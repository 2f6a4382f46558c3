"""What ``chip_smoke.py``'s phase 16 runs, on the CPU (no process is
started): every example driver once on each device, each run in a
directory of its own, and train_multihost's card slot on the CPU when
the gloo probe of phase 13b failed, taking the CPU batch's run."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_plan", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe(cs, ran: bool) -> dict:
    return {f"gloo{w}": {op: "ran" if ran else "refused: invalid usage"
                         for op in cs.MULTIHOST_OPS} for w in (2, 4)}


@pytest.mark.parametrize("gloo_ran", [True, False])
def test_example_plan_runs_each_driver_once_a_device(chip_smoke, gloo_ran):
    cs = chip_smoke
    where, children = cs.example_plan(_probe(cs, gloo_ran))
    assert where["train_multihost"] == ("cuda" if gloo_ran else "cpu")
    assert all(d == "cuda" for x, d in where.items()
               if x != "train_multihost")
    labels = sorted(r[0] for r in cs.EXAMPLE_RUNS)
    on = {dev: sorted(x for _, d, batch in children if d == dev
                      for x in batch) for dev in ("cpu", "cuda")}
    assert on["cpu"] == labels
    assert on["cuda"] == sorted(x for x in labels if where[x] == "cuda")
    assert len({tag for tag, _, _ in children}) == len(children)


@pytest.mark.parametrize("gloo_ran", [True, False])
def test_example_children_make_distinct_directories(chip_smoke, gloo_ran,
                                                    tmp_path, monkeypatch):
    """Every child of the plan starts (a stand-in process) with each of
    its runs in a new directory: none collides with another's."""
    cs = chip_smoke

    class Started:
        pid = 0

        def poll(self):
            return 0

        def wait(self, timeout=None):
            return 0

    monkeypatch.setattr(cs.subprocess, "Popen", lambda *a, **k: Started())
    monkeypatch.setattr(cs.os, "setpriority", lambda *a: None)
    monkeypatch.setattr(cs, "_CHILDREN", [])
    by_label = {r[0]: r for r in cs.EXAMPLE_RUNS}
    _, children = cs.example_plan(_probe(cs, gloo_ran))
    dirs = []
    for tag, device, labels in children:
        child = cs._start_examples([by_label[x] for x in labels], device,
                                   str(tmp_path), tag,
                                   low_priority=device == "cpu")
        dirs += [s["dir"] for s in child["spec"]]
        assert all(s["flags"][-2:] == ["--device", device]
                   for s in child["spec"])
    assert len(set(dirs)) == len(dirs)
    assert all(os.path.isdir(d) for d in dirs)
