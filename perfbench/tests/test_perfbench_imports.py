"""No module under perfbench/ imports JAX or the JAX package ``repro``,
and the reference imports nothing of the program.  Module names are
compared by their top-level name (the part before the first dot) whole:
``repro_torch`` is the port and is not ``repro``."""

import ast
from pathlib import Path

import pytest

from pbharness import files

BANNED = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(files.BENCH_DIR.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_there_are_sources():
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(files.BENCH_DIR)))
def test_no_jax_and_a_reference_without_the_program(path):
    names = set(top_level_imports(path))
    assert not names & BANNED, names & BANNED
    if path.parent.name == "reference":
        assert names <= {"torch", "math", "typing", "__future__"}, names


def test_spans_name_the_port():
    for path in (files.BENCH_DIR / "metrics").glob("*.py"):
        reader = files.load_module("metrics", path.stem)
        for span in reader.SPANS:
            assert span.split(".")[0] == "repro_torch"


def test_run_time_check_compares_top_level_names_whole(monkeypatch):
    import sys
    import types
    from pbharness import core
    before = [m for m in core.banned_modules()]
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", types.ModuleType("x"))
    assert core.banned_modules() == before
    monkeypatch.setitem(sys.modules, "repro.models", types.ModuleType("x"))
    assert "repro.models" in core.banned_modules()
