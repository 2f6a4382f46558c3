"""Runs an example driver in this process with its output captured: the
reference's ``examples/<name>.py`` (``runpy``, ``sys.argv`` patched) and
the port's ``repro_torch.examples.<name>.main(argv + ["--device",
"cpu"])``; ``assert_same`` holds the two outputs to each other under the
driver's rules in ``repro_torch.examples.compare``."""

import contextlib
import io
import os
import runpy
import sys

import pytest

from repro_torch.examples import compare

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_reference(name: str, argv=()) -> str:
    """What ``python examples/<name>.py *argv`` prints (a driver that
    exits non-zero raises ``SystemExit``)."""
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [os.path.join(ROOT, "examples", f"{name}.py"), *argv]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = saved
    return buf.getvalue()


def run_port(name: str, argv=(), device: str = "cpu") -> str:
    """What ``python -m repro_torch.examples.<name> *argv --device cpu``
    prints."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main([*argv, "--device", device])
    return buf.getvalue()


def assert_same(name: str, got: str, want: str, reference: bool = True):
    diffs = compare.differences(name, got, want, reference=reference)
    assert not diffs, "\n".join(diffs[:20])
    assert got.strip(), "no output"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test runs its drivers on one torch thread (the suite runs six
    workers), the thread count restored after."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def planes_off():
    """Each driver starts, as a process of its own does, with both
    packages' metrics registries empty (a test of another file on the
    same worker may have counted into them: the drills assert their
    request counters); the drivers that turn a plane on leave it on, so
    turn both planes off after each test."""
    import repro.obs
    import repro_torch.obs
    planes = (repro.obs, repro_torch.obs)
    for obs in planes:
        obs.default_registry().reset()
    yield
    for obs in planes:
        obs.set_tracer(None)
        obs.disable()
        obs.default_registry().reset()
