"""The port's fleet-side example drivers against the reference's
(``examples/harden_fleet.py``, ``temporal_sweep.py``,
``chaos_campaign.py``, ``capacity_planner.py``), both run in this process
on the CPU: every printed line equal under
``repro_torch.examples.compare``'s rules (words, integers and booleans
exact, floats within 1e-6, the availability integral within 1e-5, each
plus a unit in its last printed place; wall times and rates masked by
name; the draws of the reference's ``jax.random`` masked where the port
draws from its own generator).  Also: ``temporal_sweep --devices 2`` over
gloo prints what ``--devices 1`` prints, the ``--trace`` /
``--metrics-out`` files validate, and a driver run as ``python -m``
imports neither JAX nor the reference."""

import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from torch_examples import (  # noqa: E402,F401
    ROOT, assert_same, one_torch_thread, planes_off, run_port, run_reference)

CASES = [("harden_fleet", ()), ("temporal_sweep", ()),
         ("chaos_campaign", ()), ("capacity_planner", ())]


@pytest.mark.parametrize("name,argv", CASES, ids=[c[0] for c in CASES])
def test_driver_prints_the_reference_lines(name, argv):
    want = run_reference(name, argv)
    got = run_port(name, argv)
    assert_same(name, got, want)


@pytest.mark.parametrize("name", ["harden_fleet", "temporal_sweep"])
def test_trace_and_metrics_validate(name, tmp_path, monkeypatch):
    """``--trace t.json --metrics-out m.prom`` in a directory each: the
    same lines as the reference's run (the written paths among them),
    and the port's Chrome trace and Prometheus file pass ``python -m
    repro_torch.obs.export --validate``."""
    argv = ["--trace", "t.json", "--metrics-out", "m.prom"]
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    want = run_reference(name, argv)
    monkeypatch.chdir(tmp_path / "port")
    got = run_port(name, argv)
    assert_same(name, got, want)
    assert "wrote t.json (" in got and "wrote m.prom + m.jsonl" in got
    for f in ("t.json", "m.prom", "m.jsonl"):
        assert (tmp_path / "port" / f).stat().st_size > 0, f
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.export", "--validate",
         "m.prom", "--validate-trace", "t.json"], cwd=tmp_path / "port",
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "prometheus OK" in out.stdout and "trace OK" in out.stdout


def test_temporal_sweep_two_gloo_ranks_print_the_one_rank_lines():
    """``--devices 2`` spawns two gloo ranks whose sweep engines shard
    each chunk's scenarios over the world's mesh (8,192 scenarios: two
    chunks of 4,096, so the default engine shards); rank 0 prints what
    the one-rank run prints (but the rank count on its first line)."""
    grid = ["--grid-size", "8192"]
    one = run_port("temporal_sweep", grid + ["--devices", "1"])
    two = run_port("temporal_sweep", grid + ["--devices", "2"])
    assert "devices=2" in two.splitlines()[0]
    assert_same("temporal_sweep", two.replace("devices=2", "devices=1", 1),
                one, reference=False)


def test_python_m_driver_imports_no_jax_and_no_reference():
    """``python -m repro_torch.examples.capacity_planner --device cpu``
    runs to its end with neither ``jax`` nor ``repro`` in
    ``sys.modules``."""
    code = textwrap.dedent("""
        import runpy, sys
        sys.argv = ["capacity_planner", "--device", "cpu"]
        runpy.run_module("repro_torch.examples.capacity_planner",
                         run_name="__main__", alter_sys=True)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print("BOUNDARY OK")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "simulator recommendation: 1.5x" in out.stdout
    assert out.stdout.rstrip().endswith("BOUNDARY OK")


COMPARE_CASES = [
    # (driver, got, want, reference, agree)
    ("temporal_sweep", "  availability integral: 0.99969 (SLA 0.9997)",
     "  availability integral: 0.99970 (SLA 0.9997)", False, True),
    ("temporal_sweep", "  availability integral: 0.99967 (SLA 0.9997)",
     "  availability integral: 0.99970 (SLA 0.9997)", False, False),
    ("temporal_sweep", "  util_peak                        0.5000006",
     "  util_peak                        0.5", False, False),
    ("temporal_sweep", "fused sweep: 256 scenarios in 0.03s (9,418 "
     "scenarios/s)", "fused sweep: 256 scenarios in 0.01s (21,816 "
     "scenarios/s)", False, True),
    ("temporal_sweep", "hardened 31 edges in 1 rounds (certified=True)",
     "hardened 31 edges in 1 rounds (certified=False)", False, False),
    ("temporal_sweep", "hardened 31 edges", "hardened 32 edges", False,
     False),
    ("capacity_planner", "  1.50    0.0166 ######  <= recommended",
     "  1.50    0.0139 #####  <= recommended", True, True),
    ("capacity_planner", "  1.50    0.0166 ######  <= recommended",
     "  1.50    0.0139 #####  <= recommended", False, False),
    ("chaos_campaign", "x\n    dependency_storm       0.408\ny",
     "x\n    preheat_stall          0.291\n    burst_shortfall        0.130"
     "\ny", False, True),
    ("chaos_campaign", "x\ny", "x\ny\nz", False, False),
]


@pytest.mark.parametrize("name,got,want,reference,agree", COMPARE_CASES)
def test_compare_rules(name, got, want, reference, agree):
    """``examples.compare``: a unit in the last printed place and the
    loose grade of the availability integral pass, more does not; masked
    times, rates and draws pass; words and integers are exact; dropped
    lines leave the others aligned; the reference-only masks apply
    against the reference alone."""
    from repro_torch.examples import compare
    diffs = compare.differences(name, got, want, reference=reference)
    assert (not diffs) == agree, diffs
