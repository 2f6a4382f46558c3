"""Where the benchmark's data lives, found by the names in BENCHMARK.json.

Every configuration, cell, traffic mix, end-to-end metric, per-layer
metric, operation count and reference family is a file of its own under
``perfbench/``; a later cell or metric is a new file and a new entry in
``BENCHMARK.json``, never an edit of a file that is there:

    configs/<config>.json        sizes as run, the source, reduced, assumed
    workloads/<cell>.json        config, traffic, sample, controls, stages
                                 and limits of the check
    traffic/<traffic>.json       a generator's name and parameters
    generators/<generator>.py    make(mix, seed, vocab, device)
    end_to_end/<metric>.py       read(records) -> value or None
    metrics/<metric>.py          SPANS, read(trace) -> value or None
    counts/<kernel>.py           flops and bytes of a call, from its shapes
    reference/<family>.py        the plain float32 block of a model family
    stages/<stage>.py            SPAN, keep(...), numbers(...): a stage of
                                 the program checked on its own inputs
    init/<dist>.py               fill(rule, buffer, generator)
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

_modules: Dict[Path, ModuleType] = {}


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return read_json(MANIFEST)


def config(name: str) -> dict:
    return read_json(BENCH_DIR / "configs" / f"{name}.json")


def workload(name: str) -> dict:
    return read_json(BENCH_DIR / "workloads" / f"{name}.json")


def traffic(name: str) -> dict:
    return read_json(BENCH_DIR / "traffic" / f"{name}.json")


def load_module(kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    mod = _modules.get(path)
    if mod is None:
        if not path.exists():
            raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
        mod_name = "perfbench_" + kind + "_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return mod


def _applies(metric: dict, cell: str, reported: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def end_to_end_metrics(cell: str, bench: Optional[dict] = None) -> List[dict]:
    """The end-to-end metrics ``cell`` reports, in manifest order."""
    bench = manifest() if bench is None else bench
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer_metrics(cell: str, bench: Optional[dict] = None) -> List[dict]:
    """The per-layer metrics ``cell`` reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    bench = manifest() if bench is None else bench
    reported = {m["name"] for m in end_to_end_metrics(cell, bench)}
    return [m for m in bench["per_layer"] if _applies(m, cell, reported)]


def cell_entry(cell: str, bench: Optional[dict] = None) -> dict:
    bench = manifest() if bench is None else bench
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in {MANIFEST}")
