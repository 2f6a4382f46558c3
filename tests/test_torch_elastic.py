"""Elastic resharding, the data-parallel train step, the train CLI over a
mesh and the sharded sweep (port of tests/test_elastic.py and
tests/test_sweep_engine.py's sharded case), on the CPU.

Two worlds a module (``gloo``, a ``FileStore`` under the test's
temporary directory, one torch thread a rank): 4 ranks train on a (2, 2)
mesh, save a checkpoint from it and run the sweep over 4 ranks; 2 ranks
load that checkpoint onto (2, 1), continue, and run the sweep over 2.

Tolerances: the mesh train steps against one device at rtol 1e-5 on
every leaf and metric (float32 sums over ranks in other orders); the
resharded leaves bit-equal; a continued step's loss against the straight
run's at rtol 1e-6; the train CLI's losses over 2 ranks within 1e-5 of
one device's; the sharded sweep bit-equal to one device.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.core.scenarios import (FleetAggregates,  # noqa: E402
                                        scenario_grid)
from repro_torch.core.service import synthesize_fleet  # noqa: E402
from repro_torch.core.sweep_engine import SweepEngine, tile_grid  # noqa: E402
from repro_torch.core.timeline_sim import (config_for_fleet,  # noqa: E402
                                           default_ts)
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.graph import CallGraph  # noqa: E402
from repro_torch.optim.adamw import _leaves  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402
from torch_world import ROOT, run_world  # noqa: E402

REL = 1e-5
CONTINUE_REL = 1e-6

# tests/test_elastic.py's config, and the reduced MoE config
DENSE = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_head=16, d_ff=128, vocab_size=128, tie_embeddings=True)
STEPS = 2

_COMMON = """
import dataclasses
import numpy as np
from repro_torch import models
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.core.scenarios import FleetAggregates, scenario_grid
from repro_torch.core.service import synthesize_fleet
from repro_torch.core.sweep_engine import SweepEngine, tile_grid
from repro_torch.core.timeline_sim import config_for_fleet, default_ts
from repro_torch.data import SyntheticLMDataset
from repro_torch.dist import smap
from repro_torch.dist.ctx import sharding_rules
from repro_torch.dist.sharding import param_shardings
from repro_torch.graph import CallGraph
from repro_torch.launch.mesh import make_local_mesh, make_world_mesh
from repro_torch.optim import AdamWState
from repro_torch.train import TrainState, make_train_state, make_train_step

DENSE = %r
CKPT = os.path.join(DIR, "..", "ckpt")

def configs():
    return {"dense": models.LMConfig(**DENSE),
            "moe": get_arch("phi3.5-moe-42b-a6.6b").reduced}

def specs_of(cfg, mesh):
    ps = param_shardings(cfg, mesh)
    return TrainState(ps, AdamWState((), ps, ps), ())

def batches(cfg):
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=8, seed=1)
    return [{k: torch.from_numpy(v).long() for k, v in ds.batch(i).items()}
            for i in range(4)]

def mesh_step(cfg, mesh):
    step, _ = make_train_step(cfg, n_loss_chunks=2)
    def run(state, batch):
        with sharding_rules(mesh):
            return step(state, batch)
    return run

def sweep(mesh):
    fs = synthesize_fleet(scale=0.02, seed=1, as_arrays=True)
    fs.apply_ufa_target_classes()
    agg = FleetAggregates.from_fleet_state(fs)
    cfg = config_for_fleet(fs)
    graph = CallGraph.from_fleet_state(fs)
    ts = default_ts(7200.0, 120)
    grid = tile_grid(scenario_grid(evict_fraction=(1.0, 0.5)), 1024)
    eng = SweepEngine(agg, cfg, graph=graph, ts=ts, device="cpu", mesh=mesh)
    default = SweepEngine(agg, cfg, graph=graph, ts=ts, device="cpu")
    OUT["shard_for"] = (eng._shard_for((1, 1024)),
                        default._shard_for((1, 1024)),
                        default._shard_for((2, 4096)),
                        default.mesh is not None)
    OUT["sweep"] = eng.run(grid)
"""

_WORLD4 = _COMMON + """
mesh = make_local_mesh(2, 2, "cpu")
for kind, cfg in configs().items():
    specs = specs_of(cfg, mesh)
    state = make_train_state(cfg, 0, device="cpu")
    state = smap.put(state, specs, mesh)
    step = mesh_step(cfg, mesh)
    bs = batches(cfg)
    metrics = []
    for i in range(%d):
        state, m = step(state, bs[i])
        metrics.append({k: float(v) for k, v in m.items()})
    OUT[kind] = {"metrics": metrics,
                 "state": smap.gather(state, specs, mesh)}
    if kind == "dense":
        save_checkpoint(CKPT, %d, state, shardings=specs, mesh=mesh)
        state, m = step(state, bs[%d])
        OUT["straight_loss"] = float(m["loss"])
sweep(make_world_mesh((4,), ("scenarios",), "cpu"))
"""

_WORLD2 = _COMMON + """
mesh = make_local_mesh(2, 1, "cpu")
cfg = configs()["dense"]
specs = specs_of(cfg, mesh)
like = make_train_state(cfg, 9, device="cpu")
state, _ = load_checkpoint(CKPT, like, device="cpu", shardings=specs,
                           mesh=mesh)
OUT["local_shapes"] = [tuple(t.shape) for t in
                       [state.params["layers"]["attn"]["wq"],
                        state.opt.m["embed"]]]
OUT["loaded"] = smap.gather(state, specs, mesh)
state, m = mesh_step(cfg, mesh)(state, batches(cfg)[%d])
OUT["continued_loss"] = float(m["loss"])
sweep(make_world_mesh((2,), ("scenarios",), "cpu"))
"""


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("elastic")


@pytest.fixture(scope="module")
def world4(tmp):
    return run_world(tmp / "w4", 4, _WORLD4 % (DENSE, STEPS, STEPS, STEPS))


@pytest.fixture(scope="module")
def world2(tmp, world4):
    # loads the checkpoint world4 saved
    return run_world(tmp / "w2", 2, _WORLD2 % (DENSE, STEPS))


def _configs():
    from repro_torch.configs import get_arch
    return {"dense": models.LMConfig(**DENSE),
            "moe": get_arch("phi3.5-moe-42b-a6.6b").reduced}


def _batches(cfg):
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=8, seed=1)
    return [{k: torch.from_numpy(v).long() for k, v in ds.batch(i).items()}
            for i in range(4)]


@pytest.fixture(scope="module")
def one_device():
    out = {}
    for kind, cfg in _configs().items():
        step, _ = make_train_step(cfg, n_loss_chunks=2)
        state = make_train_state(cfg, 0, device="cpu")
        bs = _batches(cfg)
        metrics = []
        for i in range(STEPS):
            state, m = step(state, bs[i])
            metrics.append({k: float(v) for k, v in m.items()})
        out[kind] = {"metrics": metrics, "state": state, "step": step,
                     "batches": bs}
    return out


def _tree_leaves(state):
    return _leaves(state.params) + _leaves(state.opt.m) + \
        _leaves(state.opt.v) + [state.opt.step, state.step]


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_mesh_train_steps_equal_one_device(world4, one_device, kind):
    want = one_device[kind]
    for out in world4:
        got = out[kind]
        for m_got, m_want in zip(got["metrics"], want["metrics"]):
            for k, v in m_want.items():
                np.testing.assert_allclose(m_got[k], v, rtol=REL,
                                           err_msg=k)
        for a, b in zip(_tree_leaves(got["state"]),
                        _tree_leaves(want["state"])):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=REL,
                atol=REL * max(1e-30, float(b.abs().max())))


def test_reshard_on_load_is_bit_equal(world4, world2, tmp):
    saved = world4[0]["dense"]["state"]
    # on (2, 1) the tables replicate every leaf (no "model" split, so no
    # FSDP end either): each rank read whole leaves
    assert world2[0]["local_shapes"] == [(2, 64, 64), (128, 64)]
    for out in world2:
        for a, b in zip(_tree_leaves(out["loaded"]), _tree_leaves(saved)):
            assert torch.equal(a, b)
    # on one device
    like = make_train_state(_configs()["dense"], 9, device="cpu")
    state, _ = load_checkpoint(tmp / "ckpt", like, device="cpu")
    for a, b in zip(_tree_leaves(state), _tree_leaves(saved)):
        assert torch.equal(a, b)


def _spec_leaves(specs):
    """The specs of a spec tree in ``_leaves`` order (dict keys sorted)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    return [specs]


def test_load_reads_each_rank_block_from_the_file(world4, tmp):
    """Reshard-on-load onto (2, 2), rank by rank: every leaf is the
    rank's block of the saved leaf (np.memmap slices of the file)."""
    from repro_torch.dist.sharding import param_shardings
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import AdamWState
    from repro_torch.train import TrainState
    saved = world4[0]["dense"]["state"]
    cfg = _configs()["dense"]
    like = make_train_state(cfg, 9, device="cpu")
    for rank in range(4):
        mesh = Mesh((2, 2), ("data", "model"), rank=rank)
        ps = param_shardings(cfg, mesh)
        state, _ = load_checkpoint(
            tmp / "ckpt", like, device="cpu", mesh=mesh,
            shardings=TrainState(ps, AdamWState((), ps, ps), ()))
        assert state.params["embed"].shape == (64, 32)
        d, m = rank // 2, rank % 2
        for got, full in ((state.params, saved.params),
                          (state.opt.m, saved.opt.m),
                          (state.opt.v, saved.opt.v)):
            for g, f, spec in zip(_leaves(got), _leaves(full),
                                  _spec_leaves(ps)):
                sl = [slice(None)] * f.dim()
                for dim, e in enumerate(spec):
                    if e is not None:
                        i = {"data": d, "model": m}[e]
                        n = f.shape[dim] // 2
                        sl[dim] = slice(i * n, (i + 1) * n)
                assert torch.equal(g, f[tuple(sl)])
        assert torch.equal(state.step, saved.step)


def test_continued_step_equals_the_straight_run(world4, world2, tmp,
                                                one_device):
    straight = world4[0]["straight_loss"]
    for out in world2:
        np.testing.assert_allclose(out["continued_loss"], straight,
                                   rtol=CONTINUE_REL)
    cfg = _configs()["dense"]
    like = make_train_state(cfg, 9, device="cpu")
    state, _ = load_checkpoint(tmp / "ckpt", like, device="cpu")
    _, m = one_device["dense"]["step"](state,
                                       one_device["dense"]["batches"][STEPS])
    np.testing.assert_allclose(float(m["loss"]), straight,
                               rtol=CONTINUE_REL)


def _cli_losses(tmp, devices):
    code = ("import json, sys\n"
            "from repro_torch.launch.train import main\n"
            "rep = main(sys.argv[1:])\n"
            "print('LOSSES', json.dumps(rep.losses))\n")
    args = ["--arch", "qwen3-1.7b", "--steps", "3", "--device", "cpu",
            "--ckpt-dir", str(tmp / f"cli{devices}")]
    if devices > 1:
        args += ["--devices", str(devices), "--mesh", f"{devices}x1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].endswith(f"devices={devices}"), lines
    assert any(line.startswith("done: 3 steps") for line in lines), lines
    return json.loads(lines[-1].split("LOSSES", 1)[1])


def test_train_cli_over_two_ranks_equals_one_device(tmp):
    one = _cli_losses(tmp, 1)
    two = _cli_losses(tmp, 2)
    assert len(one) == len(two) == 3
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def sweep_single():
    fs = synthesize_fleet(scale=0.02, seed=1, as_arrays=True)
    fs.apply_ufa_target_classes()
    agg = FleetAggregates.from_fleet_state(fs)
    cfg = config_for_fleet(fs)
    graph = CallGraph.from_fleet_state(fs)
    ts = default_ts(7200.0, 120)
    grid = tile_grid(scenario_grid(evict_fraction=(1.0, 0.5)), 1024)
    eng = SweepEngine(agg, cfg, graph=graph, ts=ts, device="cpu")
    assert eng.mesh is None
    return eng.run(grid)


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_sweep_is_bit_equal_to_one_device(world2, world4,
                                                  sweep_single, ranks):
    world = world2 if ranks == 2 else world4
    for out in world:
        # an explicit mesh always shards; the default engine takes the
        # world's mesh and shards only grids past one chunk
        assert out["shard_for"] == (True, False, True, True)
        got = out["sweep"]
        assert set(got) == set(sweep_single)
        for k in got:
            assert np.array_equal(got[k], sweep_single[k],
                                  equal_nan=True), k
        assert len(got["sla_ok"]) == 1024
