"""The port's host-side contracts on the CPU: ``stage_seed`` bit-exact
against the reference's ``jax.random`` derivation, its own copies of the
fleet synthesis and the call graph giving the reference's arrays, the
state converter, the import boundary (no JAX, nothing of ``repro``), and
the device default (CUDA, never a quiet CPU fallback)."""

import dataclasses
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scenarios as ref_sc  # noqa: E402
from repro.core.fleet_state import synthesize_fleet_state  # noqa: E402
from repro.core.service import synthesize_fleet as ref_synth  # noqa: E402
from repro.graph import CallGraph as RefGraph  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import scenarios as port_sc  # noqa: E402
from repro_torch.core import timeline_sim as port_tl  # noqa: E402
from repro_torch.core.fleet_state import (  # noqa: E402
    synthesize_fleet_state as port_synth_state)
from repro_torch.core.service import synthesize_fleet as port_synth  # noqa: E402
from repro_torch.core.sweep_engine import SweepEngine  # noqa: E402
from repro_torch.graph import CallGraph  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
STAGES = ("storm", "faults", "sweep-engine", "blackhole-ensemble",
          "drill-arrivals")


@pytest.mark.parametrize("stage", STAGES)
def test_stage_seed_bit_exact(stage):
    for seed in range(64):
        assert port_sc.stage_seed(seed, stage) == \
            ref_sc.stage_seed(seed, stage), (seed, stage)


def test_stage_seed_known_values():
    assert port_sc.stage_seed(0, "storm") == 1908923644
    assert port_sc.stage_seed(1, "storm") == 1386608071
    assert port_sc.stage_seed(7, "storm") == 312318227
    for seed in (2**31 - 1, 2**31 + 5, -1, 2**40 + 3):
        assert port_sc.stage_seed(seed, "storm") == \
            ref_sc.stage_seed(seed, "storm"), seed


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_same_fleet(a, b):
    for k, v in _fields(a).items():
        w = getattr(b, k)
        if k == "edges":
            for ek, ev in _fields(v).items():
                assert np.array_equal(ev, getattr(w, ek)), ek
                assert np.asarray(ev).dtype == np.asarray(getattr(w, ek)).dtype
        elif isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and np.array_equal(v, w), k
        else:
            assert v == w, k


@pytest.mark.parametrize("scale,seed", [(0.02, 0), (0.05, 7)])
def test_own_fleet_and_graph_copies_match(scale, seed):
    ref = ref_synth(scale=scale, seed=seed, as_arrays=True)
    port = port_synth(scale=scale, seed=seed, as_arrays=True)
    _assert_same_fleet(ref, port)
    chain_ref = synthesize_fleet_state(scale=scale, seed=seed,
                                       unsafe_chain_fraction=0.06)
    chain_port = port_synth_state(scale=scale, seed=seed,
                                  unsafe_chain_fraction=0.06)
    _assert_same_fleet(chain_ref, chain_port)
    rg, pg = RefGraph.from_fleet_state(ref), CallGraph.from_fleet_state(port)
    for k, v in _fields(rg).items():
        assert np.array_equal(v, getattr(pg, k)), k
    # the converter carries the reference's graph over unchanged
    conv = from_reference_arrays(graph=_fields(rg))["graph"]
    for k, v in _fields(rg).items():
        assert np.array_equal(v, getattr(conv, k)), k


def test_converter_copies_and_does_not_alias():
    ref = ref_synth(scale=0.02, seed=1, as_arrays=True)
    fields = {k: v for k, v in _fields(ref).items() if k != "edges"}
    fields["edges"] = dataclasses.asdict(ref.edges)
    out = from_reference_arrays(fleet=fields, device="cpu")
    fs = out["fleet"]
    _assert_same_fleet(ref, fs)
    fs.apply_ufa_target_classes()
    assert not np.array_equal(fs.fclass, ref.fclass)   # a copy, not a view


def test_import_boundary_subprocess():
    """Importing every module of the port pulls in no JAX and nothing of
    the reference package."""
    mods = []
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      os.path.dirname(PORT))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {sorted(mods)!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print("OK", len({sorted(mods)!r}))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")
    assert len(mods) >= 20


def test_import_boundary_source_grep():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro\b(?!_)"
                     r"|from\s+repro(\.|\s)|import\s+jaxlib)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, f) for f in names
                  if f.endswith((".py", ".cu"))]
    for path in files:
        with open(path) as fh:
            src = fh.read()
        assert not pat.search(src), path


def test_device_default_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        backend.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        backend.resolve_device("cuda")
    fs = port_synth(scale=0.02, seed=0, as_arrays=True)
    agg = port_sc.FleetAggregates.from_fleet_state(fs)
    cfg = port_tl.config_for_fleet(fs)
    with pytest.raises(RuntimeError, match="CUDA"):
        SweepEngine(agg, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_sc.analytic_consts(agg)
    with pytest.raises(ValueError):
        backend.resolve_device("meta")
    assert backend.resolve_device("cpu").type == "cpu"
    assert backend.describe_device("cpu")["platform"] == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
