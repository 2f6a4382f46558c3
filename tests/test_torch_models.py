"""The port's model families on the CPU: ``repro_torch.models`` against
the reference's ``repro.models`` on weights made by the reference's
``init_params`` and carried across with
``repro_torch.convert.params_from_reference``, and the port's own
``init_params`` held to the reference's tree and distributions.

Configs: the five family configs of ``tests/test_models.py`` (dense,
windowed, ssm, hybrid, moe) and the REDUCED config of each of the ten
architectures.  Tolerances: the layers and the model in float32 at
rtol = atol = 1e-4 (the port runs the kernels' plain versions, whose
sums run in other orders than XLA's; the SSM scan is B8's plain version
against the reference's ``ssd_chunked``); int8 caches, lengths and
capacities exact; the port's forward against its own teacher-forced decode
at the reference's 2e-3 (``tests/test_models.py``); float16 (one reduced
config a family, the reference's float16 run) at rtol = atol = 2e-2.  At
full width the configs are held in shapes only: ``init_abstract``,
``input_specs``, the parameter counts and the B5 / B6 / B7 checks on
``meta`` tensors."""

import dataclasses
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro.configs import mamba2_780m as ref_mamba  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.configs import mamba2_780m  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels import decode_attention as b5  # noqa: E402
from repro_torch.kernels import flash_attention as b6  # noqa: E402
from repro_torch.kernels import rmsnorm as rmsnorm_kernel  # noqa: E402
from repro_torch.kernels.grouped_matmul import grouped_matmul_route  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402

TOL = 1e-4
DECODE_TOL = 2e-3
ARCH_MODULES = ("llama3_2_3b", "qwen3_1_7b", "command_r_plus_104b",
                "gemma3_4b", "phi3_5_moe_42b_a6_6b", "kimi_k2_1t_a32b",
                "hymba_1_5b", "internvl2_76b", "musicgen_large",
                "mamba2_780m")
REF_ARCH = {m: importlib.import_module(f"repro.configs.{m}")
            for m in ARCH_MODULES}
PORT_ARCH = {m: importlib.import_module(f"repro_torch.configs.{m}")
             for m in ARCH_MODULES}

# the family configs of tests/test_models.py
REF_CFGS = {
    "dense": ref_models.LMConfig(
        name="d", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=97, qk_norm=True),
    "windowed": ref_models.LMConfig(
        name="w", n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=97, window_pattern=(4, 4, 4, 4, 4, 0),
        rope_theta_local=1e3),
    "ssm": ref_models.LMConfig(
        name="s", n_layers=2, d_model=64, n_heads=0, n_kv_heads=1, d_head=1,
        d_ff=0, vocab_size=97, block="ssm", ssm_state=16, ssm_head_dim=16,
        ssm_chunk=4),
    "hybrid": ref_models.LMConfig(
        name="h", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=97, block="hybrid", ssm_state=8,
        ssm_head_dim=16, ssm_chunk=4, window_pattern=(4, 4, 0)),
    "moe": ref_models.LMConfig(
        name="m", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=96, vocab_size=97, n_experts=8, moe_top_k=2),
}
PORT_CFGS = {k: models.LMConfig(**dataclasses.asdict(v))
             for k, v in REF_CFGS.items()}
for _m in ARCH_MODULES:
    REF_CFGS[REF_ARCH[_m].REDUCED.name] = REF_ARCH[_m].REDUCED
    PORT_CFGS[PORT_ARCH[_m].REDUCED.name] = PORT_ARCH[_m].REDUCED
NAMES = list(REF_CFGS)
SSM_NAMES = ["ssm", "mamba2-780m-reduced"]
_PARAMS = {}


def _params(name):
    """The reference's params for ``name`` and the port's copy."""
    if name not in _PARAMS:
        rp = ref_models.init_params(REF_CFGS[name], jax.random.PRNGKey(0))
        _PARAMS[name] = (rp, params_from_reference(rp, device="cpu"))
    return _PARAMS[name]


def _layer0(tree):
    return jax.tree_util.tree_map(lambda v: v[0], tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _inputs(cfg, seed, B=2, S=16):
    """Token ids, or (B, S, d_model) embeddings for stub frontends."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _port(a):
    t = torch.from_numpy(a)
    return t.long() if t.dtype == torch.int32 else t


def _seq(cfg):
    """A sequence length the config's SSM chunks divide."""
    return 3 * cfg.ssm_chunk if cfg.has_ssm else 12


def test_softplus_and_silu_match_jax():
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        np.random.default_rng(0).standard_normal(1000) * 5]
                       ).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(
        torch.nn.functional.softplus(t).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=1e-30)
    np.testing.assert_allclose(
        torch.nn.functional.silu(t).numpy(),
        np.asarray(jax.nn.silu(jnp.asarray(x))), rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("name", SSM_NAMES)
def test_ssm_apply_matches_reference(name):
    rp, pp = _params(name)
    rcfg, cfg = REF_CFGS[name], PORT_CFGS[name]
    x = np.random.default_rng(1).standard_normal(
        (2, 4 * rcfg.ssm_chunk, rcfg.d_model)).astype(np.float32)
    want = ref_layers.ssm_apply(_layer0(rp["layers"])["ssm"], rcfg.ssm_dims,
                                jnp.asarray(x))
    got = layers.ssm_apply(models.model._layer(pp["layers"], 0)["ssm"],
                           cfg.ssm_dims, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want)


@pytest.mark.parametrize("name", SSM_NAMES)
def test_ssm_step_matches_reference(name):
    rp, pp = _params(name)
    rcfg, cfg = REF_CFGS[name], PORT_CFGS[name]
    d = rcfg.ssm_dims
    conv_dim = d.d_inner + 2 * d.n_groups * d.d_state
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, rcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, d.d_conv - 1, conv_dim)).astype(np.float32)
    ssm = rng.standard_normal((3, d.n_heads, d.head_dim, d.d_state)).astype(
        np.float32)
    want = ref_layers.ssm_step(_layer0(rp["layers"])["ssm"], d,
                               *map(jnp.asarray, (x, conv, ssm)))
    got = layers.ssm_step(models.model._layer(pp["layers"], 0)["ssm"],
                          cfg.ssm_dims, *map(torch.from_numpy, (x, conv, ssm)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_logits_match_reference(name):
    rp, pp = _params(name)
    rcfg, cfg = REF_CFGS[name], PORT_CFGS[name]
    x = _inputs(rcfg, 3, S=_seq(rcfg))
    rh, raux = ref_models.forward(rp, rcfg, jnp.asarray(x))
    h, aux = models.forward(pp, cfg, _port(x))
    assert h.shape == rh.shape and h.dtype == torch.float32
    _close(h, rh)
    _close(aux, raux)
    assert (float(aux) == 0.0) == (not cfg.is_moe)
    _close(models.logits_fn(pp, cfg, h), ref_models.logits_fn(rp, rcfg, rh))


# float16: one reduced config of each family, the reference's configs with
# their dtype strings replaced (kimi-k2's reduced MoE is left out: its
# capacity drops turn on near-tied routing, which swaps tokens between the
# two frameworks in bfloat16 as well)
F16_NAMES = ["llama3.2-3b-reduced", "phi3.5-moe-42b-a6.6b-reduced",
             "mamba2-780m-reduced", "hymba-1.5b-reduced",
             "internvl2-76b-reduced", "musicgen-large-reduced"]
# float16 rounds every layer's activations (4.9e-4 relative a rounding),
# in other orders in the two frameworks: 2e-2 rtol and atol, the
# reference's own bound for its 16-bit kernels
F16_TOL = 2e-2
_F16_PARAMS = {}


def _f16(name):
    """The float16 configs (reference, port) of ``name``, the reference's
    float16 params and the port's copy."""
    if name not in _F16_PARAMS:
        rcfg = dataclasses.replace(REF_CFGS[name], param_dtype="float16",
                                   activ_dtype="float16")
        cfg = dataclasses.replace(PORT_CFGS[name], param_dtype="float16",
                                  activ_dtype="float16")
        rp = ref_models.init_params(rcfg, jax.random.PRNGKey(0))
        _F16_PARAMS[name] = (rcfg, cfg, rp,
                             params_from_reference(rp, device="cpu"))
    return _F16_PARAMS[name]


def test_float16_config_builds_its_params():
    """A float16 config (the reference builds and runs one) builds the
    port's params in float16, leaf for leaf the reference's dtypes; the
    dtype table once held only float32 and bfloat16, and this raised
    ``KeyError: 'float16'``."""
    rcfg, cfg, rp, _ = _f16("llama3.2-3b-reduced")
    assert cfg.pdtype == cfg.adtype == torch.float16
    got = models.init_params(cfg, torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_leaves_with_path(rp)
    flat = {jax.tree_util.keystr(k): v for k, v in want}
    for k, v in jax.tree_util.tree_leaves_with_path(got):
        ref_leaf = flat[jax.tree_util.keystr(k)]
        assert str(v.dtype).split(".")[1] == str(ref_leaf.dtype), k
        assert tuple(v.shape) == ref_leaf.shape, k


@pytest.mark.parametrize("name", F16_NAMES)
def test_float16_forward_matches_reference(name):
    rcfg, cfg, rp, pp = _f16(name)
    x = _inputs(rcfg, 3, S=_seq(rcfg))
    rh, _ = ref_models.forward(rp, rcfg, jnp.asarray(x))
    h, _ = models.forward(pp, cfg, _port(x))
    assert h.dtype == torch.float16 and rh.dtype == jnp.float16
    assert bool(torch.isfinite(h).all())
    _close(h, rh, F16_TOL)
    _close(models.logits_fn(pp, cfg, h), ref_models.logits_fn(rp, rcfg, rh),
           F16_TOL)


@pytest.mark.parametrize("name", F16_NAMES)
def test_float16_decode_step_matches_reference(name):
    """Decode against a float16 cache, step by step, logits and state."""
    rcfg, cfg, rp, pp = _f16(name)
    x = _inputs(rcfg, 4, S=6)
    rs = ref_models.init_decode_state(rcfg, 2, 8, jnp.float16)
    st = models.init_decode_state(cfg, 2, 8, torch.float16, device="cpu")
    step = jax.jit(lambda s, t: ref_models.decode_step(rp, rcfg, s, t))
    for t in range(x.shape[1]):
        rl, rs = step(rs, jnp.asarray(x[:, t]))
        lg, st = models.decode_step(pp, cfg, st, _port(x[:, t]))
        _close(lg, rl, F16_TOL)
    for f in _STATE:
        g, w = getattr(st, f), getattr(rs, f)
        assert str(g.dtype).split(".")[1] == str(w.dtype), f
        _close(g, w, F16_TOL)


@pytest.mark.parametrize("module", ["phi3_5_moe_42b_a6_6b",
                                    "kimi_k2_1t_a32b"])
def test_moe_capacity_matches_reference(module):
    """Per-expert capacity at the full and reduced configs, from one
    token (decode) to a 2 x 4,096 prefill (phi3.5-moe: 1,280)."""
    for field in ("CONFIG", "REDUCED"):
        rcfg = getattr(REF_ARCH[module], field)
        cfg = getattr(PORT_ARCH[module], field)
        for n in (1, 2, 8, 33, 512, 8192):
            assert models.moe_capacity(cfg, n) == \
                ref_models.moe_capacity(rcfg, n), (field, n)
    assert models.moe_capacity(PORT_ARCH["phi3_5_moe_42b_a6_6b"].CONFIG,
                               8192) == 1280
    assert models.moe_capacity(PORT_CFGS["dense"], 64) == 0


_STATE = ("k_cache", "v_cache", "k_scale", "v_scale", "conv_state",
          "ssm_state")


@pytest.mark.parametrize("name", NAMES + ["dense, kv_quant"])
def test_decode_step_matches_reference(name):
    if name == "dense, kv_quant":
        _, pp = _params("dense")
        rp = _params("dense")[0]
        rcfg = dataclasses.replace(REF_CFGS["dense"], kv_quant=True)
        cfg = dataclasses.replace(PORT_CFGS["dense"], kv_quant=True)
    else:
        rp, pp = _params(name)
        rcfg, cfg = REF_CFGS[name], PORT_CFGS[name]
    x = _inputs(rcfg, 4, S=6)
    rs = ref_models.init_decode_state(rcfg, 2, 8, jnp.float32)
    st = models.init_decode_state(cfg, 2, 8, torch.float32, device="cpu")
    for f in _STATE:
        assert tuple(getattr(st, f).shape) == getattr(rs, f).shape, f
        assert str(getattr(st, f).dtype).split(".")[1] == \
            str(getattr(rs, f).dtype), f
    step = jax.jit(lambda s, t: ref_models.decode_step(rp, rcfg, s, t))
    for t in range(x.shape[1]):
        rl, rs = step(rs, jnp.asarray(x[:, t]))
        lg, st = models.decode_step(pp, cfg, st, _port(x[:, t]))
        _close(lg, rl)
    for f in _STATE:
        g, w = getattr(st, f), getattr(rs, f)
        if g.dtype == torch.int8:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w)
    assert int(st.length) == int(rs.length) == x.shape[1]


def test_decode_writes_the_kv_caches_in_place():
    """The new state holds the very K/V tensors given, with the new
    token's K/V written at the old length; the length is a new tensor."""
    _, pp = _params("dense")
    cfg = PORT_CFGS["dense"]
    st = models.init_decode_state(cfg, 2, 8, torch.float32, device="cpu")
    st = st._replace(length=torch.tensor(3, dtype=torch.int32))
    ptrs = (st.k_cache.data_ptr(), st.v_cache.data_ptr())
    _, new = models.decode_step(pp, cfg, st, torch.tensor([5, 7]))
    assert new.k_cache is st.k_cache and new.v_cache is st.v_cache
    assert (new.k_cache.data_ptr(), new.v_cache.data_ptr()) == ptrs
    assert int(st.length) == 3 and int(new.length) == 4
    written = st.k_cache.abs().sum(dim=(0, 1, 3, 4))
    assert bool((written[3] > 0)) and bool((written[[0, 1, 2, 4, 5, 6, 7]]
                                            == 0).all())


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if not PORT_CFGS[n].is_moe])
def test_forward_matches_own_decode(name):
    """Teacher-forced decode from a zero state gives the forward's logits
    at every position (the SSM carry across chunks, windows that bite
    and the cache included).  The MoE configs are left out, as in
    ``tests/test_models.py``: the forward's capacity (for B x S tokens)
    drops slots that decode's (for B tokens) keeps."""
    _, pp = _params(name)
    cfg = PORT_CFGS[name]
    S = _seq(cfg)
    x = _port(_inputs(cfg, 5, S=S))
    full = models.logits_fn(pp, cfg, models.forward(pp, cfg, x)[0])
    st = models.init_decode_state(cfg, 2, S, torch.float32, device="cpu")
    outs = []
    for t in range(S):
        lg, st = models.decode_step(pp, cfg, st, x[:, t])
        outs.append(lg)
    err = float((full - torch.stack(outs, 1)).abs().max())
    assert err < DECODE_TOL, err


def test_moe_parallel_modes(tmp_path):
    """shard_map on one device (no mesh) is the local MoE; so is the
    expert-parallel path over a live 1 x 1 mesh (a world of one rank,
    every collective skipped), with and without the sharding rules; an
    unknown mode raises."""
    import torch.distributed as dist
    from repro_torch.dist.ctx import sharding_rules
    from repro_torch.launch.mesh import init_world, make_local_mesh
    _, pp = _params("moe")
    cfg = PORT_CFGS["moe"]
    x = _port(_inputs(cfg, 6))
    h, aux = models.forward(pp, cfg, x)
    for par in (models.MoEParallel(), models.MoEParallel(mode="shard_map")):
        h2, aux2 = models.forward(pp, cfg, x, moe_parallel=par)
        assert torch.equal(h, h2) and torch.equal(aux, aux2)
    init_world(str(tmp_path / "store"), 0, 1, "cpu")
    try:
        mesh = make_local_mesh(1, 1, device="cpu")
        par = models.MoEParallel(mode="shard_map", fsdp_axes=("data",),
                                 mesh=mesh)
        h3, aux3 = models.forward(pp, cfg, x, moe_parallel=par)
        assert torch.equal(h, h3) and torch.equal(aux, aux3)
        with sharding_rules(mesh):
            for p in (None, par):
                h4, aux4 = models.forward(pp, cfg, x, moe_parallel=p)
                assert torch.equal(h, h4) and torch.equal(aux, aux4)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="mode"):
        models.forward(pp, cfg, x, moe_parallel=models.MoEParallel(mode="x"))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


_TO_NP = {torch.float32: np.float32, torch.bfloat16: jnp.bfloat16,
          torch.int32: np.int32, torch.int8: np.int8}


def _same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert np.dtype(_TO_NP[got[k].dtype]) == w.dtype, k


# mamba2-780m at full width, one layer: every leaf shape of the real model
# but the layer axis, small enough to draw on the CPU
FULL_WIDTH = dataclasses.replace(mamba2_780m.CONFIG, n_layers=1)
REF_FULL_WIDTH = dataclasses.replace(ref_mamba.CONFIG, n_layers=1)


@pytest.mark.parametrize("name", NAMES + ["mamba2-780m, 1 layer"])
def test_init_params_tree_shapes_dtypes(name):
    if name in REF_CFGS:
        rcfg, cfg = REF_CFGS[name], PORT_CFGS[name]
    else:
        rcfg, cfg = REF_FULL_WIDTH, FULL_WIDTH
    _same_tree(models.init_params(cfg, 0, device="cpu"),
               ref_models.init_abstract(rcfg))


@pytest.mark.parametrize("module", ARCH_MODULES)
def test_init_abstract_matches_reference_at_full_width(module):
    """Every full CONFIG's tree on the meta device: the reference's
    shapes and dtypes, nothing allocated, and the parameter count."""
    cfg = PORT_ARCH[module].CONFIG
    tree = models.init_abstract(cfg)
    _same_tree(tree, ref_models.init_abstract(REF_ARCH[module].CONFIG))
    assert all(v.device.type == "meta" for _, v in _leaves(tree))
    n = sum(v.numel() for k, v in _leaves(tree) if not k.endswith("mix"))
    assert n == cfg.param_count() == REF_ARCH[module].CONFIG.param_count()


@pytest.mark.parametrize("name", NAMES)
def test_init_params_deterministic_leaves(name):
    """conv_b, d_skip, mix and the norm scales exactly the reference's;
    a_log within one unit in the last place (the reference's float32
    linspace and log are folded by XLA, and round a few entries the other
    way)."""
    rp, _ = _params(name)
    got = dict(_leaves(models.init_params(PORT_CFGS[name], 1, device="cpu")))
    for k, w in _leaves(rp):
        w = np.asarray(w, np.float32)
        if k.endswith(("conv_b", "d_skip", "scale", "mix")):
            assert np.array_equal(got[k].float().numpy(), w), k
        elif k.endswith("a_log"):
            g = got[k].numpy()
            assert np.all(np.abs(g - w) <= np.spacing(np.abs(w))), k


def _truncated_normal_stats(v, fan_in, key):
    """Truncated normal at +-2 sigma, sigma = 1 / sqrt(fan_in) (a truncated
    N(0, 1) has std 0.8796), within 4 standard errors of each moment."""
    trunc_std = 0.87962566
    v = v.float()
    sigma = 1.0 / np.sqrt(fan_in)
    n = v.numel()
    assert float(v.abs().max()) <= 2 * sigma * (1 + 2 ** -8), key
    assert abs(float(v.std()) / (sigma * trunc_std) - 1) < 4 / np.sqrt(n), key
    assert abs(float(v.mean())) < 4 * trunc_std * sigma / np.sqrt(n), key


def test_init_params_random_leaves_statistics():
    """The random leaves hold the reference's contracts: the truncated
    normal fan-in init, the embedding N(0, 0.02), and softplus(dt_bias) =
    dt in [1e-3, 1e-1], log-uniform."""
    cfg = dataclasses.replace(FULL_WIDTH, n_layers=2)
    p = dict(_leaves(models.init_params(cfg, 7, device="cpu")))
    sd = cfg.ssm_dims
    for k, fan_in in (("layers/ssm/in_proj", cfg.d_model),
                      ("layers/ssm/conv_w", sd.d_conv),
                      ("layers/ssm/out_proj", sd.d_inner)):
        _truncated_normal_stats(p[k], fan_in, k)
    emb = p["embed"].float()
    n = emb.numel()
    assert abs(float(emb.std()) / 0.02 - 1) < 4 / np.sqrt(2 * n)
    assert abs(float(emb.mean())) < 4 * 0.02 / np.sqrt(n)
    dt = torch.nn.functional.softplus(p["layers/ssm/dt_bias"]).double()
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    # log-uniform: the mean of log dt sits midway (96 draws, 4 sigma)
    mid = (np.log(1e-3) + np.log(1e-1)) / 2
    half = (np.log(1e-1) - np.log(1e-3)) / 2
    assert abs(float(dt.log().mean()) - mid) < 4 * half / np.sqrt(3 * 96)
    # two seeds give other draws, one seed the same
    again = dict(_leaves(models.init_params(cfg, 7, device="cpu")))
    other = dict(_leaves(models.init_params(cfg, 8, device="cpu")))
    assert torch.equal(again["layers/ssm/in_proj"], p["layers/ssm/in_proj"])
    assert not torch.equal(other["layers/ssm/in_proj"],
                           p["layers/ssm/in_proj"])


def test_init_params_attention_and_moe_statistics():
    """The attention, MLP and MoE leaves: each its reference fan-in (the
    gate and up expert slabs take the expert count as theirs, as the
    reference's ``_dense_init`` reads the leading axis), the router
    float32 in a bf16 model, hybrid's mix 0.5."""
    cfg = models.LMConfig(
        name="x", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_head=32, d_ff=192, vocab_size=512, block="hybrid", qk_norm=True,
        n_experts=8, moe_top_k=2, n_shared_experts=1, ssm_state=16,
        ssm_head_dim=32, param_dtype="bfloat16")
    p = dict(_leaves(models.init_params(cfg, 3, device="cpu")))
    for k, fan_in in (("layers/attn/wq", 256), ("layers/attn/wk", 256),
                      ("layers/attn/wv", 256), ("layers/attn/wo", 256),
                      ("layers/moe/router", 256), ("layers/moe/w_gate", 8),
                      ("layers/moe/w_up", 8), ("layers/moe/w_down", 192),
                      ("layers/moe/shared/w_gate", 256),
                      ("layers/moe/shared/w_down", 192)):
        _truncated_normal_stats(p[k], fan_in, k)
    assert p["layers/moe/router"].dtype == torch.float32
    assert p["layers/moe/w_gate"].dtype == torch.bfloat16
    assert p["layers/mix"].dtype == torch.float32
    assert bool((p["layers/mix"] == 0.5).all())
    assert bool((p["layers/attn/q_norm/scale"] == 1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_and_embed_init_scale_in_place(dtype):
    """``_dense_init`` and ``_embed_init`` scale their float32 draw in
    place (one float32 slab alive before the cast: kimi-k2's expert slab
    is 22.5 GB of it): bit-equal to ``(t * std).to(dtype)`` on the same
    seeded draw."""
    shape, fan_in = (3, 40, 24), 40
    got = layers._dense_init(torch.Generator().manual_seed(5), shape, dtype,
                             in_axis_size=fan_in)
    # the draw: N(0, 1) cut at +-2 by the inverse CDF of one uniform a
    # value (tests/test_torch_layers.py holds it to scipy's erfinv)
    t = torch.empty(shape, dtype=torch.float32).uniform_(
        math.erf(-math.sqrt(2.0)), math.erf(math.sqrt(2.0)),
        generator=torch.Generator().manual_seed(5))
    t = t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    assert got.dtype == dtype
    assert torch.equal(got, (t * (1.0 / np.sqrt(fan_in))).to(dtype))
    emb = layers._embed_init(torch.Generator().manual_seed(6), (50, 16),
                             dtype)
    r = torch.randn((50, 16), generator=torch.Generator().manual_seed(6))
    assert torch.equal(emb, (r * 0.02).to(dtype))


@pytest.mark.parametrize("n_layers", [1, 3])
def test_init_params_stacks_layers_as_drawn(n_layers):
    """``init_params`` copies each layer into the stack as it is drawn:
    the tree ``torch.stack`` of the layers drawn one after another (after
    the embedding) would give, with one layer's tree alive beside the
    stack instead of all of them."""
    cfg = dataclasses.replace(PORT_ARCH["kimi_k2_1t_a32b"].REDUCED,
                              n_layers=n_layers)
    got = models.init_params(cfg, 4, device="cpu")
    gen = torch.Generator().manual_seed(4)
    layers._embed_init(gen, (cfg.vocab_size, cfg.d_model), cfg.pdtype)
    drawn = [model_mod._init_layer(gen, cfg) for _ in range(n_layers)]
    for (k, g), (k2, w0) in zip(_leaves(got["layers"]), _leaves(drawn[0])):
        assert k == k2 and g.shape == (n_layers, *w0.shape)
        want = torch.stack([dict(_leaves(t))[k] for t in drawn])
        assert torch.equal(g, want), k


@pytest.mark.parametrize("name", NAMES + ["mamba2-780m"])
def test_param_count_matches_reference(name):
    if name == "mamba2-780m":
        rcfg, cfg = ref_mamba.CONFIG, mamba2_780m.CONFIG
    else:
        rcfg, cfg = REF_CFGS[name], PORT_CFGS[name]
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    got = sum(v.numel() for k, v in _leaves(models.init_params(
        dataclasses.replace(cfg, n_layers=1), 0, device="cpu"))
        if not k.endswith("mix"))
    assert got == dataclasses.replace(rcfg, n_layers=1).param_count()


def test_params_from_reference_keeps_bf16_exact():
    """Every leaf exact, the float32 ones (a_log, mix, the router) kept
    float32 in a bf16 model."""
    for fam in ("ssm", "hybrid", "moe"):
        rcfg = dataclasses.replace(REF_CFGS[fam], param_dtype="bfloat16",
                                   activ_dtype="bfloat16")
        rp = ref_models.init_params(rcfg, jax.random.PRNGKey(3))
        pp = params_from_reference(rp, device="cpu")
        for (k, w), (k2, g) in zip(_leaves(rp), _leaves(pp)):
            assert k == k2
            assert tuple(g.shape) == w.shape
            assert np.dtype(_TO_NP[g.dtype]) == w.dtype, k
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
        assert pp["embed"].dtype == torch.bfloat16
    assert pp["layers"]["moe"]["router"].dtype == torch.float32


def test_configs_registry():
    archs = port_configs.all_archs()
    assert set(archs) == set(ref_configs.all_archs())
    assert len(archs) == 10
    for module in ARCH_MODULES:
        ref, port = REF_ARCH[module].SPEC, PORT_ARCH[module].SPEC
        assert archs[port.arch_id] is port
        for field in ("config", "reduced"):
            assert dataclasses.asdict(getattr(port, field)) == \
                dataclasses.asdict(getattr(ref, field)), (module, field)
        assert (port.family, int(port.tier), port.source, port.skips) == \
            (ref.family, int(ref.tier), ref.source, ref.skips), module
    assert mamba2_780m.CONFIG.pdtype == torch.bfloat16
    assert mamba2_780m.CONFIG.ssm_dims == layers.SSMDims(
        **dataclasses.asdict(ref_mamba.CONFIG.ssm_dims))
    assert set(port_configs.SHAPES) == {"train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"}
    assert port_configs.base.FULL_ATTENTION_500K_SKIP == \
        ref_configs.base.FULL_ATTENTION_500K_SKIP


@pytest.mark.parametrize("arch_id", sorted(ref_configs.all_archs()))
def test_input_specs_match_reference(arch_id):
    """Every (arch x shape) cell's inputs as meta tensors: the reference's
    ShapeDtypeStructs' shapes and dtypes, the decode state's included."""
    for shape in port_configs.SHAPES:
        want = ref_configs.input_specs(ref_configs.get_arch(arch_id), shape)
        got = port_configs.input_specs(port_configs.get_arch(arch_id), shape)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            pairs = (zip(got[k], w) if k == "state" else [(got[k], w)])
            for g, ws in pairs:
                assert g.device.type == "meta"
                assert tuple(g.shape) == ws.shape, (shape, k)
                assert np.dtype(_TO_NP[g.dtype]) == ws.dtype, (shape, k)


def _meta_prefill(cfg, B=2, S=4096):
    """q, K and V as the attention layer hands them to B6: (B, S, H, d)
    each, KV repeated to H heads, in the config's activation dtype."""
    t = torch.empty((B, S, cfg.n_heads, cfg.d_head), dtype=cfg.adtype,
                    device="meta")
    return t, torch.empty_like(t), torch.empty_like(t)


# the GQA group each full config hands B5 and B6 (phase 14 of
# chip_smoke.py runs musicgen-large's 1 and command-r-plus-104b's 12)
FULL_GROUPS = {"llama3_2_3b": 3, "qwen3_1_7b": 2, "command_r_plus_104b": 12,
               "gemma3_4b": 2, "phi3_5_moe_42b_a6_6b": 4,
               "kimi_k2_1t_a32b": 8, "hymba_1_5b": 5, "internvl2_76b": 8,
               "musicgen_large": 1}


@pytest.mark.parametrize("module", [m for m in ARCH_MODULES
                                    if PORT_ARCH[m].CONFIG.has_attn])
def test_kernel_checks_pass_at_full_width(module):
    """The checks only the card runs (B6's and B5's head-dim domain and
    dtypes, row alignment) on meta tensors at every full config's
    attention shapes: prefill q/k/v at B 2 x S 4,096, and decode q at B 8
    against each layer's view of a 4,352-slot stacked decode state, at
    each config's GQA group (1 to 12).  B4 takes the configs' widths (up
    to command-r-plus-104b's 12,288).  B7 takes its wgmma route on the
    MoE configs' expert slabs at the capacity of 2 x 4,096 tokens
    (kimi-k2: 384 experts, capacity 216).  The reduced configs' heads (16
    or 8) are in both routes' domain in both dtypes."""
    cfg = PORT_ARCH[module].CONFIG
    assert cfg.n_heads // cfg.n_kv_heads == FULL_GROUPS[module]
    assert cfg.d_model <= rmsnorm_kernel.MAX_D
    assert b6.check_inputs(*_meta_prefill(cfg), window=1024) == 1
    st = models.init_decode_state(cfg, 8, 4352, device="meta")
    q = torch.empty((8, cfg.n_heads, cfg.d_head), dtype=cfg.adtype,
                    device="meta")
    for i in (0, cfg.n_layers - 1):
        assert b5.check_inputs(q, st.k_cache[i], st.v_cache[i]) == 1
    if cfg.is_moe:
        tree = models.init_abstract(dataclasses.replace(cfg, n_layers=1))
        moe = tree["layers"]["moe"]
        cap = models.moe_capacity(cfg, 8192)
        assert cap == {16: 1280, 384: 216}[cfg.n_experts]
        xe = torch.empty((cfg.n_experts, cap, cfg.d_model), dtype=cfg.adtype,
                         device="meta")
        h = torch.empty((cfg.n_experts, cap, cfg.d_ff), dtype=cfg.adtype,
                        device="meta")
        assert grouped_matmul_route(xe, moe["w_gate"][0]) == "wgmma"
        assert grouped_matmul_route(h, moe["w_down"][0]) == "wgmma"
    small = PORT_ARCH[module].REDUCED
    assert b6.check_inputs(*_meta_prefill(small, S=64)) == 0
    assert b6.check_inputs(*(t.to(torch.bfloat16)
                             for t in _meta_prefill(small, S=64))) == 1
    sq = torch.empty((2, small.n_heads, small.d_head), device="meta")
    sc = torch.empty((2, 64, small.n_kv_heads, small.d_head), device="meta")
    assert b5.check_inputs(sq, sc, sc) == 0
    assert b5.check_inputs(*(t.to(torch.bfloat16) for t in (sq, sc, sc))) == 1


# the serving drill's model (repro/serving/workload.py _LM)
DRILL_LM = models.LMConfig(name="live-drill", n_layers=2, d_model=64,
                           n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                           vocab_size=128, tie_embeddings=True)


@pytest.mark.parametrize("batch,max_seq", [(8, 20), (4, 16), (1, 16)])
@pytest.mark.parametrize("cfg", [PORT_ARCH[m].REDUCED for m in ARCH_MODULES
                                 if PORT_ARCH[m].REDUCED.has_attn]
                         + [DRILL_LM], ids=lambda c: c.name)
def test_decode_checks_pass_at_reduced_and_drill_shapes(cfg, batch, max_seq):
    """B5's checks (head dims 8 and 16, the group, row alignment) on meta
    tensors at the decode shapes the serve CLI (batch up to 8, prompt 8 +
    4 new + 8 slots) and the serving drill (waves of 1-4, 4 + 4 + 8
    slots) give it: q against each layer's cache view of the stacked
    float32 decode state, on the float32 route at its own width 8 or 16;
    the same shapes in bf16 on the mma route, run at width 64."""
    st = models.init_decode_state(cfg, batch, max_seq, torch.float32,
                                  device="meta")
    q = torch.empty((batch, cfg.n_heads, cfg.d_head), device="meta")
    assert cfg.d_head in (8, 16)
    assert backend.padded_head_dim(cfg.d_head, b5.WIDTHS["fma"],
                                   "decode_attention") == cfg.d_head
    for i in range(cfg.n_layers):
        assert b5.check_inputs(q, st.k_cache[i], st.v_cache[i]) == 0
    k16, v16 = (c[0].to(torch.bfloat16) for c in (st.k_cache, st.v_cache))
    assert b5.check_inputs(q.to(torch.bfloat16), k16, v16) == 1
    assert backend.padded_head_dim(cfg.d_head, b5.WIDTHS["mma"],
                                   "decode_attention") == 64


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PORT_CFGS["ssm"]
    with pytest.raises(RuntimeError, match="CUDA"):
        models.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        models.init_decode_state(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_reference(_params("ssm")[0])
    # a generator given sets the device: a CPU generator, CPU parameters
    p = models.init_params(cfg, torch.Generator().manual_seed(0))
    assert p["embed"].device.type == "cpu"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_rmsnorm_defaults_to_cuda(monkeypatch, dtype):
    """Unit scale on the device asked for; with no device, the card, which
    raises where there is none (no quiet CPU default)."""
    p = layers.init_rmsnorm(48, dtype, device="cpu")
    assert p["scale"].device.type == "cpu" and p["scale"].dtype == dtype
    assert p["scale"].shape == (48,) and bool((p["scale"] == 1).all())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        layers.init_rmsnorm(48, dtype)
