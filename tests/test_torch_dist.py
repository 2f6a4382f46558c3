"""The port's mesh path (``repro_torch.dist``) on the CPU, against its
one-device runs and against the reference's own mesh runs.

Multi-rank cases run in ``torch.distributed`` worlds of 2 and 4 CPU
processes (``gloo``, a ``FileStore`` under the test's temporary
directory; one torch thread a rank), each world spawned once for the
module and every case asserted in its own test.  The reference's mesh
runs are subprocesses with 4 fake XLA devices.

Tolerances: split-KV decode against the port's one-device decode and
against the reference's 4-device run at 1e-5 of max|logit| (float32; the
merge reorders the softmax sums), and the reference test's own 5e-3 /
0.05 against the unquantised single run; the pipeline at rel 1e-5
(tests/test_pipeline.py); the int8-compressed mean at rel 0.05
(tests/test_elastic.py) with the dequantisation exact; expert-parallel
MoE forward and gradients at rtol 1e-5 (float32 sums over ranks in
another order); the sharding tables, ``default_rules`` and the block
shapes exact.
"""

import functools
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import models as ref_models  # noqa: E402
from repro.dist import ctx as ref_ctx  # noqa: E402
from repro.dist import sharding as ref_shd  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.dist import ctx, smap  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.optim.compression import dequantize_int8  # noqa: E402
from torch_world import ROOT, run_world  # noqa: E402

REL = 1e-5

KW = {
    # tests/test_elastic.py::test_splitkv_decode_multidevice_matches_single
    "dense": dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  d_head=16, d_ff=128, vocab_size=128),
    # tests/test_dist_extras.py::test_windowed_sharded_splitkv_decode
    "windowed": dict(name="w", n_layers=4, d_model=64, n_heads=4,
                     n_kv_heads=2, d_head=16, d_ff=128, vocab_size=128,
                     window_pattern=(4, 4, 4, 0), rope_theta_local=1e3),
    "windowed_int8": dict(name="w", n_layers=4, d_model=64, n_heads=4,
                          n_kv_heads=2, d_head=16, d_ff=128, vocab_size=128,
                          window_pattern=(4, 4, 4, 0), rope_theta_local=1e3,
                          kv_quant=True),
    # one MoE layer with a shared expert, for expert parallelism
    "moe": dict(name="m", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                d_head=8, d_ff=64, vocab_size=64, n_experts=4, moe_top_k=2,
                n_shared_experts=1),
}
# (steps, batch, max_seq) of each split-KV case, as the reference tests
SPLITKV = {"dense": (6, 2, 16), "windowed": (8, 2, 16),
           "windowed_int8": (8, 2, 16)}
MOE_MESHES = ((1, 2), (2, 2))
MOE_TOKENS = (4, 8)              # B x S of the MoE input


def _ref_weights(kind):
    cfg = ref_models.LMConfig(**KW[kind])
    return cfg, jax.tree_util.tree_map(
        np.asarray, ref_models.init_params(cfg, jax.random.PRNGKey(0)))


def _np_to_torch(tree):
    return params_from_reference(tree, device="cpu")


# ---------------------------------------------------------------------------
# ctx
# ---------------------------------------------------------------------------


def test_hint_is_x_and_no_context_is_one_rank():
    x = torch.ones(4, 8)
    assert ctx.hint(x, "batch", "ff") is x
    assert ctx.current_mesh() is None and ctx.get_rule("batch") is None
    assert ctx.axis_size("batch") == 1 and ctx.axis_size("ff") == 1


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1), (16, 16),
                                   (2, 16, 16)])
def test_rules_axis_sizes_as_the_reference(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = make_abstract_mesh(shape, names)
    stand_in = types.SimpleNamespace(axis_names=names,
                                     shape=dict(zip(names, shape)))
    assert ctx.default_rules(mesh) == ref_ctx.default_rules(stand_in)
    with ctx.sharding_rules(mesh, {"embed": "model"}):
        assert ctx.current_mesh() is mesh
        assert ctx.get_rule("embed") == "model"
        assert ctx.axis_size("batch") == int(np.prod(shape[:-1]))
        assert ctx.axis_size("ff") == shape[-1]
        x = torch.ones(3, 5)      # neither dim divides: stays whole
        assert ctx.hint(x, "batch", "ff") is x
    assert ctx.current_mesh() is None


def test_nondivisible_block_raises_and_divisible_splits():
    mesh = make_abstract_mesh((2, 2))
    assert smap.local_shape((4, 8), ("data", "model"), mesh) == (2, 4)
    assert smap.local_shape((4, 8), (("data", "model"),), mesh) == (1, 8)
    with pytest.raises(ValueError, match="divide"):
        smap.local_shape((3, 5), ("data", "model"), mesh)
    t = smap.put({"w": torch.ones(4, 8)}, {"w": (None, "model")}, mesh)["w"]
    assert t.device.type == "meta" and t.shape == (4, 4)


@pytest.mark.parametrize("layout", ctx.PARAM_LAYOUTS)
def test_block_spec_follows_the_contexts_param_layout(layout):
    """A leaf's spec is the context's layout's, and the block must be the
    one it names: the rank's block under "fsdp" / "model", the whole leaf
    under "whole"; the other holding raises."""
    cfg = models.LMConfig(**KW["dense"])
    mesh = make_abstract_mesh((2, 2))
    whole = models.init_abstract(cfg)
    if layout == "whole":
        held, other = whole, smap.put(whole, shd.param_shardings(cfg, mesh),
                                      mesh)
        want = (None, None)
    else:
        specs = shd.param_shardings(cfg, mesh, fsdp=layout == "fsdp")
        held, other = smap.put(whole, specs, mesh), whole
        want = specs["layers"]["mlp"]["w_gate"][1:]
    path = ("layers", "mlp", "w_gate")
    with ctx.sharding_rules(mesh, param_layout=layout):
        layer = models.model._layer(held["layers"], 0)
        assert models.model.block_spec(layer["mlp"]["w_gate"], path, cfg,
                                       mesh, stacked=True) == want
        with pytest.raises(ValueError, match="is not the rank's block"):
            models.model.block_spec(other["layers"]["mlp"]["w_gate"], path,
                                    cfg, mesh)
    with pytest.raises(ValueError, match="param_layout"):
        with ctx.sharding_rules(mesh, param_layout="replicated"):
            pass


# ---------------------------------------------------------------------------
# sharding tables == the reference's PartitionSpecs
# ---------------------------------------------------------------------------

_MODULES = ("llama3_2_3b", "qwen3_1_7b", "command_r_plus_104b", "gemma3_4b",
            "phi3_5_moe_42b_a6_6b", "kimi_k2_1t_a32b", "hymba_1_5b",
            "internvl2_76b", "musicgen_large", "mamba2_780m")
_TABLE_MESHES = ((2, 2), (1, 4), (4, 1), (16, 16), (2, 16, 16))


@functools.lru_cache(maxsize=None)
def _ref_abstract(module, which):
    import importlib
    cfg = getattr(importlib.import_module(f"repro.configs.{module}"), which)
    return cfg, jax.eval_shape(lambda k: ref_models.init_params(cfg, k),
                               jax.random.PRNGKey(0))


def _ref_table(tree, fn):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(getattr(k, "key", getattr(k, "name", "")) for k in path)
        out[keys] = fn(path, leaf)
    return out


def _port_table(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_table(v, path + (k,)))
        return out
    return {path: tree}


@pytest.mark.parametrize("shape", _TABLE_MESHES)
@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
@pytest.mark.parametrize("module", _MODULES)
def test_sharding_tables_equal_the_reference(module, which, shape,
                                             monkeypatch):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    stand_in = types.SimpleNamespace(axis_names=names,
                                     shape=dict(zip(names, shape)))
    mesh = make_abstract_mesh(shape, names)
    ref_cfg, abstract = _ref_abstract(module, which)
    import importlib
    cfg = getattr(importlib.import_module(f"repro_torch.configs.{module}"),
                  which)
    for fsdp in (True, False):
        want = _ref_table(abstract, lambda p, leaf: tuple(
            ref_shd._leaf_spec(p, leaf, stand_in, fsdp)))
        got = _port_table(shd.param_shardings(cfg, mesh, fsdp))
        assert got == want
    # the batch and decode tables, NamedSharding stood in by its spec
    monkeypatch.setattr(ref_shd, "NamedSharding", lambda m, spec: spec)
    for b in (128, 1):
        assert tuple(ref_shd.decode_token_shardings(ref_cfg, stand_in, b)) \
            == shd.decode_token_shardings(cfg, mesh, b)
        ref_st = ref_shd.decode_state_shardings(ref_cfg, stand_in, b)
        port_st = shd.decode_state_shardings(cfg, mesh, b)
        assert [tuple(s) for s in ref_st] == list(port_st)
    ref_tb = ref_shd.train_batch_shardings(ref_cfg, stand_in)
    assert {k: tuple(v) for k, v in ref_tb.items()} == \
        shd.train_batch_shardings(cfg, mesh)
    assert tuple(ref_shd.prefill_shardings(ref_cfg, stand_in)["inputs"]) \
        == shd.prefill_shardings(cfg, mesh)["inputs"]
    assert shd.batch_axes(mesh) == ref_shd.batch_axes(stand_in)
    assert shd.cache_seq_len(32768) == ref_shd.cache_seq_len(32768)


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

_WORLD4 = """
from repro_torch import models
from repro_torch.dist import ctx, smap
from repro_torch.dist import sharding as shd
from repro_torch.dist.pipeline import pipeline_apply
from repro_torch.launch.mesh import make_local_mesh, make_world_mesh
from repro_torch.models import layers
from repro_torch.models.model import _layer, _moe_shard_map
from repro_torch.optim.compression import compressed_psum_grads
IN = torch.load(os.path.join(DIR, "..", "inputs.pt"), weights_only=False)

# split-KV decode on a (1, 4) mesh
mesh14 = make_local_mesh(1, 4, "cpu")
for kind, (steps, B, max_seq) in IN["splitkv"].items():
    cfg = models.LMConfig(**IN["kw"][kind])
    p, toks = IN["params"][kind], IN["tokens"][kind]
    st = models.init_decode_state(cfg, B, max_seq, torch.float32,
                                  device="cpu")
    st = smap.put(st, shd.decode_state_shardings(cfg, mesh14, B), mesh14)
    got = []
    with ctx.sharding_rules(mesh14, param_layout="whole"):
        for t in range(steps):
            lg, st = models.decode_step(p, cfg, st, toks[:, t])
            got.append(lg)
    OUT["splitkv/" + kind] = torch.stack(got)
    OUT["splitkv_cache/" + kind] = st.k_cache.shape

# the pipeline, 4 stages
exec(IN["stage_code"])
mesh_pod = make_world_mesh((4,), ("pod",), "cpu")
OUT["pipeline4"] = pipeline_apply(stage_fn, IN["pipe_params"],
                                  IN["pipe_x"], mesh=mesh_pod,
                                  n_microbatches=4)

# int8-compressed mean over 4 ranks
mesh_data = make_world_mesh((4,), ("data",), "cpu")
gen = torch.Generator().manual_seed(RANK)
OUT["compressed"] = compressed_psum_grads(
    {"g": IN["grads"][RANK]}, "data", gen, mesh=mesh_data)["g"]

# expert-parallel MoE on (2, 2)
exec(IN["moe_code"])
run_moe(make_local_mesh(2, 2, "cpu"))
"""

_WORLD2 = """
from repro_torch.dist.pipeline import pipeline_apply
from repro_torch.dist import smap
from repro_torch.launch.mesh import make_local_mesh, make_world_mesh
from repro_torch import models
from repro_torch.dist import ctx
from repro_torch.dist import sharding as shd
from repro_torch.models.model import _layer, _moe_shard_map
IN = torch.load(os.path.join(DIR, "..", "inputs.pt"), weights_only=False)
exec(IN["stage_code"])
mesh_pod = make_world_mesh((2,), ("pod",), "cpu")
OUT["pipeline2"] = pipeline_apply(stage_fn, IN["pipe_params"],
                                  IN["pipe_x"], mesh=mesh_pod,
                                  n_microbatches=4)
exec(IN["moe_code"])
run_moe(make_local_mesh(1, 2, "cpu"))
"""

# the rank's MoE run: its blocks of one MoE layer, y and aux, and the
# gradients of sum(y * c) / n_model (every rank's loss summed is the
# one-device loss) for every leaf block and for its token block
_MOE_CODE = """
def run_moe(mesh):
    cfg = models.LMConfig(**IN["kw"]["moe"])
    specs = shd.param_shardings(cfg, mesh)
    p = smap.put(IN["params"]["moe"], specs, mesh)
    mp = _layer(p["layers"], 0)["moe"]
    leaves = {}
    def req(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = req(v, path + (k,))
            else:
                out[k] = v.detach().clone().requires_grad_()
                leaves[path + (k,)] = out[k]
        return out
    mp = req(mp)
    par = models.MoEParallel(mode="shard_map", model_axis="model",
                             fsdp_axes=("data",), mesh=mesh)
    x = smap.put(IN["moe_x"], (("data",), None), mesh)
    c = smap.put(IN["moe_c"], (("data",), None), mesh)
    x = x.detach().clone().requires_grad_()
    y, aux = _moe_shard_map(mp, x, cfg, par)
    loss = (y * c).sum() / mesh.shape["model"]
    loss.backward()
    tag = "x".join(map(str, mesh.shape.values()))
    OUT["moe/" + tag] = {"y": y.detach(), "aux": aux.detach(),
                         "coords": dict(mesh.coords),
                         "grads": {"/".join(k): v.grad
                                   for k, v in leaves.items()},
                         "dx": smap.psum(x.grad, "model", mesh)}
"""


_STAGE_CODE = """
from repro_torch.models import layers
def stage_fn(layers_local, h):
    for i in range(layers_local["w_gate"].shape[0]):
        h = h + layers.mlp({k: v[i] for k, v in layers_local.items()}, h)
    return h
"""


def _pipe_inputs():
    g = torch.Generator().manual_seed(3)
    Lyr, D, F, B, S = 8, 32, 64, 8, 16
    params = {"w_gate": torch.randn(Lyr, D, F, generator=g) * 0.2 / D ** 0.5,
              "w_up": torch.randn(Lyr, D, F, generator=g) * 0.2 / D ** 0.5,
              "w_down": torch.randn(Lyr, F, D, generator=g) * 0.2 / F ** 0.5}
    x = torch.randn(B, S, D, generator=g)
    return params, x


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    params, tokens, np_params = {}, {}, {}
    for kind in list(SPLITKV) + ["moe"]:
        ref_cfg, w = _ref_weights(kind)
        np_params[kind] = w
        params[kind] = _np_to_torch(w)
        if kind in SPLITKV:
            steps, B, _ = SPLITKV[kind]
            tokens[kind] = torch.from_numpy(np.array(jax.random.randint(
                jax.random.PRNGKey(1), (B, steps), 0, 128))).long()
    pp, px = _pipe_inputs()
    g = torch.Generator().manual_seed(0)
    T = MOE_TOKENS[0] * MOE_TOKENS[1]
    data = {"kw": KW, "splitkv": SPLITKV, "params": params,
            "tokens": tokens, "stage_code": _STAGE_CODE, "pipe_params": pp,
            "pipe_x": px, "grads": torch.randn(4, 256, generator=g),
            "moe_code": _MOE_CODE,
            "moe_x": torch.randn(T, KW["moe"]["d_model"], generator=g),
            "moe_c": torch.randn(T, KW["moe"]["d_model"], generator=g)}
    torch.save(data, d / "inputs.pt")
    data["np_params"] = np_params
    data["dir"] = d
    return data


@pytest.fixture(scope="module")
def world4(inputs):
    return run_world(inputs["dir"] / "w4", 4, _WORLD4)


@pytest.fixture(scope="module")
def world2(inputs):
    return run_world(inputs["dir"] / "w2", 2, _WORLD2)


# ---------------------------------------------------------------------------
# split-KV decode
# ---------------------------------------------------------------------------


def _single_decode(inputs, kind):
    cfg = models.LMConfig(**KW[kind])
    steps, B, max_seq = SPLITKV[kind]
    st = models.init_decode_state(cfg, B, max_seq, torch.float32,
                                  device="cpu")
    out = []
    for t in range(steps):
        lg, st = models.decode_step(inputs["params"][kind], cfg, st,
                                    inputs["tokens"][kind][:, t])
        out.append(lg)
    return torch.stack(out)


_REF_SPLITKV = """
import dataclasses, sys, jax, jax.numpy as jnp, numpy as np
from repro.dist.ctx import sharding_rules
from repro.dist import sharding as shd
from repro.models import LMConfig, init_params, init_decode_state, decode_step
out = {}
for kind, kw in KW.items():
    steps, B, max_seq = SPLITKV[kind]
    cfg = LMConfig(**kw)
    p = init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (B, steps), 0, 128)
    mesh = jax.make_mesh((1, 4), ("data", "model"))
    st = init_decode_state(cfg, B, max_seq, jnp.float32)
    st = jax.device_put(st, shd.decode_state_shardings(cfg, mesh, B))
    def step(st, tok, cfg=cfg, p=p, mesh=mesh):
        with sharding_rules(mesh):
            return decode_step(p, cfg, st, tok)
    jstep = jax.jit(step, donate_argnums=(0,))
    got = []
    with mesh:
        for t in range(steps):
            lg, st = jstep(st, toks[:, t])
            got.append(np.asarray(lg))
    out[kind] = np.stack(got)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref_splitkv(inputs):
    path = str(inputs["dir"] / "ref_splitkv.npz")
    kw = {k: KW[k] for k in SPLITKV}
    code = (f"KW = {kw!r}\nSPLITKV = {SPLITKV!r}\n"
            + textwrap.dedent(_REF_SPLITKV))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, path], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("kind", sorted(SPLITKV))
def test_splitkv_equals_one_device_decode(world4, inputs, kind):
    single = _single_decode(inputs, kind)
    scale = float(single.abs().max())
    for r, out in enumerate(world4):
        got = out["splitkv/" + kind]
        # the caches stayed the rank's blocks of the sequence
        assert out["splitkv_cache/" + kind][2] == SPLITKV[kind][2] // 4
        err = float((got - single).abs().max())
        assert err <= REL * scale, (kind, r, err, scale)


@pytest.mark.parametrize("kind", sorted(SPLITKV))
def test_splitkv_equals_the_reference_mesh_run(world4, ref_splitkv, kind):
    want = torch.from_numpy(ref_splitkv[kind])
    got = world4[0]["splitkv/" + kind]
    err = float((got - want).abs().max())
    assert err <= REL * float(want.abs().max()), (kind, err)


@pytest.mark.parametrize("kind", sorted(SPLITKV))
def test_splitkv_within_the_reference_tests_limits(world4, inputs, kind):
    """tests/test_elastic.py (abs 5e-3) and tests/test_dist_extras.py (rel
    5e-3 unquantised, 0.05 int8) against the unquantised single run."""
    base = "windowed" if kind.startswith("windowed") else kind
    single = _single_decode(inputs, base)
    got = world4[0]["splitkv/" + kind]
    err = float((got - single).abs().max())
    if kind == "dense":
        assert err < 5e-3, err
    else:
        tol = 0.05 if kind.endswith("int8") else 5e-3
        assert err / float(single.abs().max()) < tol, (kind, err)


# ---------------------------------------------------------------------------
# pipeline, compressed mean
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_equals_sequential(world2, world4, stages):
    params, x = _pipe_inputs()
    ref = x
    for i in range(params["w_gate"].shape[0]):
        ref = ref + layers.mlp({k: v[i] for k, v in params.items()}, ref)
    world = world2 if stages == 2 else world4
    for out in world:
        got = out[f"pipeline{stages}"]
        rel = float((got - ref).abs().max()) / float(ref.abs().max())
        assert rel < REL, (stages, rel)


def test_compressed_psum_at_4_ranks(world4, inputs):
    g = inputs["grads"]
    want = g.mean(dim=0)
    scale = torch.clamp(g.abs().max() / 127.0, min=1e-12)
    outs = [o["compressed"] for o in world4]
    for out in outs:
        assert torch.equal(out, outs[0])
        rel = float((out - want).abs().max()) / float(want.abs().max())
        assert rel < 0.05, rel
        # the int32 sum dequantised exactly: out = deq(sum q, scale) / n
        q = torch.round(out * 4 / scale)
        assert torch.equal(dequantize_int8(q, scale) / 4, out)


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------


def _one_device_moe(inputs, n_data):
    """The one-device program the mesh computes: each data block's
    tokens through every expert at its local capacity; y, the mean aux,
    and the gradients of sum(y * c) for the whole leaves and tokens."""
    cfg = models.LMConfig(**KW["moe"])
    mp = {k: (v[0].detach().clone().requires_grad_() if not isinstance(v, dict)
              else {kk: vv[0].detach().clone().requires_grad_()
                    for kk, vv in v.items()})
          for k, v in inputs["params"]["moe"]["layers"]["moe"].items()}
    x = inputs["moe_x"].clone().requires_grad_()
    T = x.shape[0] // n_data
    ys, auxs = [], []
    for d in range(n_data):
        y, aux = layers.moe_apply_local(
            mp, x[d * T:(d + 1) * T], top_k=cfg.moe_top_k,
            capacity=models.moe_capacity(cfg, T), n_experts=cfg.n_experts)
        ys.append(y)
        auxs.append(aux)
    y = torch.cat(ys)
    (y * inputs["moe_c"]).sum().backward()
    grads = {"router": mp["router"].grad, "w_gate": mp["w_gate"].grad,
             "w_up": mp["w_up"].grad, "w_down": mp["w_down"].grad}
    grads.update({f"shared/{k}": v.grad for k, v in mp["shared"].items()})
    return y.detach(), torch.stack(auxs).mean().detach(), grads, x.grad


def _assemble(world, key, name, spec):
    """The whole leaf from the ranks' blocks laid out by ``spec`` (the
    layer's slice: the stacked dim dropped)."""
    spec = tuple(spec)[1:]
    blocks = {}
    for out in world:
        c = out[key]["coords"]
        idx = tuple(0 if e is None else
                    int(np.ravel_multi_index(
                        [c[a] for a in ((e,) if isinstance(e, str) else e)],
                        [MESH_SIZES[key][a] for a in
                         ((e,) if isinstance(e, str) else e)]))
                    for e in spec)
        blocks[idx] = out[key]["grads"][name]
    shape = [max(i[d] for i in blocks) + 1 for d in range(len(spec))]
    arr = np.empty(shape, dtype=object)
    for i, b in blocks.items():
        arr[i] = b
    def cat(a, d):
        if a.ndim == 1:
            return torch.cat(list(a), dim=d)
        return torch.cat([cat(a[i], d + 1) for i in range(a.shape[0])],
                         dim=d)
    return cat(arr, 0)


MESH_SIZES = {"moe/1x2": {"data": 1, "model": 2},
              "moe/2x2": {"data": 2, "model": 2}}


def _moe_world(world2, world4, mesh):
    return world2 if mesh == (1, 2) else world4


@pytest.mark.parametrize("mesh", MOE_MESHES)
def test_expert_parallel_moe_forward_equals_one_device(world2, world4,
                                                       inputs, mesh):
    world = _moe_world(world2, world4, mesh)
    key = "moe/%dx%d" % mesh
    y, aux, _, _ = _one_device_moe(inputs, mesh[0])
    T = y.shape[0] // mesh[0]
    for out in world:
        d = out[key]["coords"]["data"]
        got = out[key]["y"]
        np.testing.assert_allclose(got.numpy(), y[d * T:(d + 1) * T].numpy(),
                                   rtol=REL, atol=REL * float(y.abs().max()))
        np.testing.assert_allclose(float(out[key]["aux"]), float(aux),
                                   rtol=REL)


_REF_MOE = """
import sys, jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.models import LMConfig
from repro.models.model import MoEParallel, _moe_shard_map, moe_capacity
cfg = LMConfig(**KW)
w = dict(np.load(sys.argv[1]))
mp = {k: jnp.asarray(v) for k, v in w.items() if not k.startswith("shared")}
mp["shared"] = {k[7:]: jnp.asarray(v) for k, v in w.items()
                if k.startswith("shared")}
x = jnp.asarray(w.pop("x_tokens"))
mp.pop("x_tokens")
out = {}
for d, m in MESHES:
    mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))
    par = MoEParallel(mode="shard_map", model_axis="model",
                      fsdp_axes=("data",), mesh=mesh)
    with mesh:
        y, aux = _moe_shard_map(mp, x, cfg, par, moe_capacity(cfg, x.shape[0]))
    out[f"y{d}x{m}"] = np.asarray(y)
    out[f"aux{d}x{m}"] = np.asarray(aux)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ref_moe(inputs):
    w = inputs["np_params"]["moe"]["layers"]["moe"]
    flat = {k: np.asarray(v)[0] for k, v in w.items() if k != "shared"}
    flat.update({f"shared/{k}": np.asarray(v)[0]
                 for k, v in w["shared"].items()})
    flat["x_tokens"] = inputs["moe_x"].numpy()
    src = str(inputs["dir"] / "moe_w.npz")
    np.savez(src, **flat)
    dst = str(inputs["dir"] / "ref_moe.npz")
    code = (f"KW = {KW['moe']!r}\nMESHES = {MOE_MESHES!r}\n"
            + textwrap.dedent(_REF_MOE))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, src, dst], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(dst))


@pytest.mark.parametrize("mesh", MOE_MESHES)
def test_expert_parallel_moe_equals_the_reference(world2, world4, ref_moe,
                                                  mesh):
    world = _moe_world(world2, world4, mesh)
    key = "moe/%dx%d" % mesh
    want = ref_moe["y%dx%d" % mesh]
    T = want.shape[0] // mesh[0]
    for out in world:
        d = out[key]["coords"]["data"]
        np.testing.assert_allclose(out[key]["y"].numpy(),
                                   want[d * T:(d + 1) * T], rtol=REL,
                                   atol=REL * float(np.abs(want).max()))
        np.testing.assert_allclose(float(out[key]["aux"]),
                                   float(ref_moe["aux%dx%d" % mesh]),
                                   rtol=REL)


@pytest.mark.parametrize("mesh", MOE_MESHES)
def test_expert_parallel_moe_gradients_equal_one_device(world2, world4,
                                                        inputs, mesh):
    world = _moe_world(world2, world4, mesh)
    key = "moe/%dx%d" % mesh
    _, _, grads, dx = _one_device_moe(inputs, mesh[0])
    cfg = models.LMConfig(**KW["moe"])
    specs = shd.param_shardings(cfg, make_abstract_mesh(mesh))
    mspecs = specs["layers"]["moe"]
    for name, want in grads.items():
        spec = (mspecs["shared"][name[7:]] if name.startswith("shared/")
                else mspecs[name])
        got = _assemble(world, key, name, spec or (None,) * 4)
        np.testing.assert_allclose(
            got.numpy(), want.numpy(), rtol=REL,
            atol=REL * float(want.abs().max()), err_msg=name)
    T = dx.shape[0] // mesh[0]
    for out in world:
        d = out[key]["coords"]["data"]
        np.testing.assert_allclose(out[key]["dx"].numpy(),
                                   dx[d * T:(d + 1) * T].numpy(), rtol=REL,
                                   atol=REL * float(dx.abs().max()))
