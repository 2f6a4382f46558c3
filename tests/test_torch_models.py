"""The port's SSM model family on the CPU: ``repro_torch.models`` against
the reference's ``repro.models`` on weights made by the reference's
``init_params`` and carried across with
``repro_torch.convert.params_from_reference``, and the port's own
``init_params`` held to the reference's tree and distributions.

Configs: the ``"ssm"`` family config of ``tests/test_models.py`` and
mamba2-780m's REDUCED.  Tolerances: the layers and the model in float32
at rtol = atol = 1e-4 (the port's scan is B8's plain version, the
reference's ``ssd_chunked``, so sums run in other orders; measured
errors are ~2e-6); the port's forward against its own teacher-forced
decode at the reference's 2e-3 (``tests/test_models.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as ref_models  # noqa: E402
from repro.configs import mamba2_780m as ref_mamba  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.configs import mamba2_780m  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = 1e-4
DECODE_TOL = 2e-3
REF_CFGS = {
    "ssm": ref_models.LMConfig(
        name="s", n_layers=2, d_model=64, n_heads=0, n_kv_heads=1, d_head=1,
        d_ff=0, vocab_size=97, block="ssm", ssm_state=16, ssm_head_dim=16,
        ssm_chunk=4),
    "mamba2-780m-reduced": ref_mamba.REDUCED,
}
PORT_CFGS = {"ssm": models.LMConfig(**dataclasses.asdict(REF_CFGS["ssm"])),
             "mamba2-780m-reduced": mamba2_780m.REDUCED}
NAMES = list(REF_CFGS)
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


def _tokens(cfg, seed, B=2, S=16):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


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


@pytest.mark.parametrize("name", NAMES)
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


@pytest.mark.parametrize("name", NAMES)
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
    toks = _tokens(rcfg, 3)
    rh, raux = ref_models.forward(rp, rcfg, jnp.asarray(toks))
    h, aux = models.forward(pp, cfg, torch.from_numpy(toks).long())
    assert h.shape == rh.shape and h.dtype == torch.float32
    _close(h, rh)
    assert float(aux) == float(raux) == 0.0
    _close(models.logits_fn(pp, cfg, h), ref_models.logits_fn(rp, rcfg, rh))


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(name):
    rp, pp = _params(name)
    rcfg, cfg = REF_CFGS[name], PORT_CFGS[name]
    toks = _tokens(rcfg, 4, S=6)
    rs = ref_models.init_decode_state(rcfg, 2, 8, jnp.float32)
    st = models.init_decode_state(cfg, 2, 8, torch.float32, device="cpu")
    for f in ("k_cache", "v_cache", "k_scale", "v_scale", "conv_state",
              "ssm_state"):
        assert tuple(getattr(st, f).shape) == getattr(rs, f).shape, f
    for t in range(toks.shape[1]):
        rl, rs = ref_models.decode_step(rp, rcfg, rs, jnp.asarray(toks[:, t]))
        lg, st = models.decode_step(pp, cfg, st,
                                    torch.from_numpy(toks[:, t]).long())
        _close(lg, rl)
    _close(st.conv_state, rs.conv_state)
    _close(st.ssm_state, rs.ssm_state)
    assert int(st.length) == int(rs.length) == toks.shape[1]


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_own_decode(name):
    """Teacher-forced decode from a zero state gives the forward's logits
    at every position (the carry across chunks included)."""
    _, pp = _params(name)
    cfg = PORT_CFGS[name]
    S = 3 * cfg.ssm_chunk
    toks = torch.from_numpy(_tokens(cfg, 5, S=S)).long()
    full = models.logits_fn(pp, cfg, models.forward(pp, cfg, toks)[0])
    st = models.init_decode_state(cfg, 2, S, torch.float32, device="cpu")
    outs = []
    for t in range(S):
        lg, st = models.decode_step(pp, cfg, st, toks[:, t])
        outs.append(lg)
    err = float((full - torch.stack(outs, 1)).abs().max())
    assert err < DECODE_TOL, err


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


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
    want = dict(_leaves(ref_models.init_abstract(rcfg)))
    got = dict(_leaves(models.init_params(cfg, 0, device="cpu")))
    assert sorted(got) == sorted(want)
    to_np = {torch.float32: np.float32, torch.bfloat16: jnp.bfloat16}
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert np.dtype(to_np[got[k].dtype]) == w.dtype, k


@pytest.mark.parametrize("name", NAMES)
def test_init_params_deterministic_leaves(name):
    """conv_b, d_skip and the norm scales exactly the reference's; a_log
    within one unit in the last place (the reference's float32 linspace
    and log are folded by XLA, and round a few entries the other way)."""
    rp, _ = _params(name)
    got = dict(_leaves(models.init_params(PORT_CFGS[name], 1, device="cpu")))
    for k, w in _leaves(rp):
        w = np.asarray(w, np.float32)
        if k.endswith(("conv_b", "d_skip", "scale")):
            assert np.array_equal(got[k].float().numpy(), w), k
        elif k.endswith("a_log"):
            g = got[k].numpy()
            assert np.all(np.abs(g - w) <= np.spacing(np.abs(w))), k


def test_init_params_random_leaves_statistics():
    """The random leaves hold the reference's contracts: truncated normal
    at +-2 sigma with sigma = 1 / sqrt(fan_in) (a truncated N(0, 1) has
    std 0.8796), the embedding N(0, 0.02), and softplus(dt_bias) = dt in
    [1e-3, 1e-1], log-uniform."""
    cfg = dataclasses.replace(FULL_WIDTH, n_layers=2)
    p = dict(_leaves(models.init_params(cfg, 7, device="cpu")))
    sd = cfg.ssm_dims
    trunc_std = 0.87962566
    for k, fan_in in (("layers/ssm/in_proj", cfg.d_model),
                      ("layers/ssm/conv_w", sd.d_conv),
                      ("layers/ssm/out_proj", sd.d_inner)):
        v = p[k].float()
        sigma = 1.0 / np.sqrt(fan_in)
        n = v.numel()                 # 4 standard errors of each moment
        assert float(v.abs().max()) <= 2 * sigma * (1 + 2 ** -8), k
        assert abs(float(v.std()) / (sigma * trunc_std) - 1) < 4 / np.sqrt(n), k
        assert abs(float(v.mean())) < 4 * trunc_std * sigma / np.sqrt(n), k
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


@pytest.mark.parametrize("name", ["mamba2-780m", "mamba2-780m-reduced", "ssm"])
def test_param_count_matches_reference(name):
    if name == "mamba2-780m":
        rcfg, cfg = ref_mamba.CONFIG, mamba2_780m.CONFIG
    else:
        rcfg, cfg = REF_CFGS[name], PORT_CFGS[name]
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    got = sum(v.numel() for _, v in _leaves(models.init_params(
        dataclasses.replace(cfg, n_layers=1), 0, device="cpu")))
    assert got == dataclasses.replace(rcfg, n_layers=1).param_count()


def test_params_from_reference_keeps_bf16_exact():
    rcfg = dataclasses.replace(REF_CFGS["ssm"], param_dtype="bfloat16",
                               activ_dtype="bfloat16")
    rp = ref_models.init_params(rcfg, jax.random.PRNGKey(3))
    pp = params_from_reference(rp, device="cpu")
    for (k, w), (k2, g) in zip(_leaves(rp), _leaves(pp)):
        assert k == k2
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    assert pp["embed"].dtype == torch.bfloat16
    assert pp["layers"]["ssm"]["a_log"].dtype == torch.float32


def test_configs_registry():
    spec = port_configs.get_arch("mamba2-780m")
    assert spec.config == mamba2_780m.CONFIG
    assert spec.family == "ssm" and int(spec.tier) == int(ref_mamba.SPEC.tier)
    assert set(port_configs.all_archs()) == {"mamba2-780m"}
    ref_fields = dataclasses.asdict(ref_mamba.CONFIG)
    assert dataclasses.asdict(mamba2_780m.CONFIG) == ref_fields
    assert dataclasses.asdict(mamba2_780m.REDUCED) == \
        dataclasses.asdict(ref_mamba.REDUCED)
    assert mamba2_780m.CONFIG.pdtype == torch.bfloat16
    assert mamba2_780m.CONFIG.ssm_dims == layers.SSMDims(
        **dataclasses.asdict(ref_mamba.CONFIG.ssm_dims))
    assert set(port_configs.SHAPES) == {"train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"}


@pytest.mark.parametrize("block,d_ff", [("attn", 128), ("hybrid", 128),
                                        ("ssm", 128)])
def test_other_families_raise(block, d_ff):
    cfg = models.LMConfig(name="x", n_layers=1, d_model=64, n_heads=4,
                          n_kv_heads=2, d_head=16, d_ff=d_ff, vocab_size=97,
                          block=block, ssm_state=8, ssm_head_dim=16,
                          ssm_chunk=4)
    toks = torch.zeros((1, 4), dtype=torch.long)
    for call in (lambda: models.init_params(cfg, 0, device="cpu"),
                 lambda: models.init_decode_state(cfg, 1, 4, device="cpu"),
                 lambda: models.forward({}, cfg, toks),
                 lambda: models.decode_step({}, cfg, None, toks[:, 0])):
        with pytest.raises(NotImplementedError, match="Queue A item 1"):
            call()


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
