"""The port's training path on the CPU against the reference's:
autograd through the model kernels, remat, and the train step.

  - Each kernel wrapper's gradient (``kernels.backend.with_plain_grad``:
    the wrapper's forward, the plain version's backward) against
    ``jax.grad`` of ``repro/kernels/ref.py`` on the same numpy inputs, at
    rtol = atol 1e-5 (2e-5 for attention, the reference's own flash
    tolerance; float32 sums in other orders than XLA's).  B8's state is
    not differentiable.  Under ``torch.no_grad()`` no graph is made.
  - ``remat="full"`` and ``"dots"`` give ``"none"``'s loss and gradients
    (rtol 1e-6: the same arithmetic, recomputed); ``"dots"`` saves the
    plain products that ``"full"`` recomputes.
  - One and two train steps of each of the ten REDUCED configs on the
    reference's weights (``convert.params_from_reference``) against
    ``repro.train.make_train_step``: loss, ``ce``, ``aux`` and
    ``grad_norm`` at rtol 1e-5; the updated parameters and moments at
    the stated float32 tolerances (``PARAM_TOL``).
  - B6's checks on meta tensors at the reduced configs' heads: float32 at
    d 8 and 16 passes, bf16 there raises.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import train as ref_train  # noqa: E402
from repro.data import SyntheticLMDataset as RefDataset  # noqa: E402
from repro.kernels import ref as ref_k  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels import flash_attention as b6  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim.adamw import _leaves  # noqa: E402
from repro_torch.train import (TrainState, chunked_ce_loss,  # noqa: E402
                               make_decode_fn, make_prefill_step,
                               make_train_state, make_train_state_abstract,
                               make_train_step)

CPU = "cpu"
ARCH_MODULES = ("llama3_2_3b", "qwen3_1_7b", "command_r_plus_104b",
                "gemma3_4b", "phi3_5_moe_42b_a6_6b", "kimi_k2_1t_a32b",
                "hymba_1_5b", "internvl2_76b", "musicgen_large",
                "mamba2_780m")
REF_ARCH = {m: importlib.import_module(f"repro.configs.{m}")
            for m in ARCH_MODULES}
PORT_ARCH = {m: importlib.import_module(f"repro_torch.configs.{m}")
             for m in ARCH_MODULES}
METRIC_RTOL = 1e-5
# the updated parameters after one or two AdamW steps at lr 3e-4: rtol
# 1e-5 on the values, plus 0.1 of the step size absolute.  An entry whose
# gradient is within float32 noise of zero moves by lr * m / (sqrt(v) +
# eps), which lands anywhere in (-lr, lr) for the two packages (eps
# 1e-8); such entries were found up to 0.039 lr apart (hymba-1.5b).  The
# moments at rtol 1e-4 plus 1e-4 of the largest moment of their leaf,
# for the same entries (found up to 3.8e-6 of it)
PARAM_TOL = dict(rtol=1e-5, atol=0.1 * 3e-4)
MOMENT_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _grads_port(fn, inputs, w):
    xs = [x.clone().requires_grad_() for x in inputs]
    out = fn(*xs)
    y = out[0] if isinstance(out, tuple) else out
    assert "_PlainBackward" in type(y.grad_fn).__name__
    g = torch.autograd.grad((y.float() * w).sum(), xs)
    return out, g


def _grads_ref(fn, inputs, w):
    def loss(*xs):
        y = fn(*xs)
        y = y[0] if isinstance(y, tuple) else y
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(w.numpy()))
    return jax.grad(loss, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(x.numpy()) for x in inputs])


def _hold(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("rows,D", [(6, 16), (33, 64), (4, 1001)])
def test_rmsnorm_grad_equals_jax(rows, D):
    r = _rng(rows + D)
    x = _t(r.standard_normal((rows, D)).astype(np.float32))
    s = _t(r.standard_normal(D).astype(np.float32))
    w = _t(r.standard_normal((rows, D)).astype(np.float32))
    before = ops.rmsnorm.launches
    out, g = _grads_port(lambda x, s: ops.rmsnorm(x, s, 1e-6), (x, s), w)
    assert ops.rmsnorm.launches == before          # the CPU: no kernel
    _hold(g, _grads_ref(lambda x, s: ref_k.ref_rmsnorm(x, s, 1e-6),
                        (x, s), w), 1e-5)


@pytest.mark.parametrize("S,H,d,causal,window", [
    (16, 2, 8, True, 0), (40, 3, 16, True, 7), (24, 2, 16, False, 0),
    (33, 1, 32, True, 0)])
def test_flash_attention_grad_equals_jax(S, H, d, causal, window):
    r = _rng(S * d + window)
    q, k, v, w = (_t(r.standard_normal((2, S, H, d)).astype(np.float32))
                  for _ in range(4))
    out, g = _grads_port(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=causal, window=window), (q, k, v), w)
    _hold(g, _grads_ref(lambda q, k, v: ref_k.ref_flash_attention(
        q, k, v, causal=causal, window=window), (q, k, v), w), 2e-5)


@pytest.mark.parametrize("E,C,D,F", [(2, 8, 16, 12), (4, 8, 64, 96),
                                     (3, 5, 7, 9)])
def test_grouped_matmul_grad_equals_jax(E, C, D, F):
    r = _rng(E * C * D * F)
    x = _t(r.standard_normal((E, C, D)).astype(np.float32))
    wt = _t(r.standard_normal((E, D, F)).astype(np.float32))
    w = _t(r.standard_normal((E, C, F)).astype(np.float32))
    out, g = _grads_port(ops.grouped_matmul, (x, wt), w)
    _hold(g, _grads_ref(ref_k.ref_grouped_matmul, (x, wt), w), 1e-5)


def _jax_ssd_scan(x, dt, a, b, c, chunk):
    """``repro/kernels/ref.py``'s ``ref_ssd_chunk`` over the chunks of S,
    carrying the float32 state, b and c repeated to the heads: the
    Pallas kernel's grid, step by step."""
    H, G = x.shape[2], b.shape[2]
    b = jnp.repeat(b, H // G, axis=2)
    c = jnp.repeat(c, H // G, axis=2)
    state = jnp.zeros((x.shape[0], H, x.shape[3], b.shape[3]), jnp.float32)
    ys = []
    for s0 in range(0, x.shape[1], chunk):
        sl = slice(s0, s0 + chunk)
        y, state = ref_k.ref_ssd_chunk(x[:, sl], dt[:, sl], a, b[:, sl],
                                       c[:, sl], state)
        ys.append(y)
    return jnp.concatenate(ys, axis=1), state


@pytest.mark.parametrize("S,H,G,P,N,chunk", [(8, 2, 1, 4, 3, 4),
                                             (24, 4, 2, 8, 16, 8),
                                             (16, 3, 3, 5, 4, 16)])
def test_ssd_scan_grad_equals_jax(S, H, G, P, N, chunk):
    r = _rng(S * H * P)
    x = _t(r.standard_normal((2, S, H, P)).astype(np.float32))
    dt = _t(r.uniform(0.05, 0.5, (2, S, H)).astype(np.float32))
    a = _t(-r.uniform(0.5, 2.0, H).astype(np.float32))
    b, c = (_t(r.standard_normal((2, S, G, N)).astype(np.float32))
            for _ in range(2))
    w = _t(r.standard_normal((2, S, H, P)).astype(np.float32))
    (y, state), g = _grads_port(lambda *t: ops.ssd_scan(*t, chunk=chunk),
                                (x, dt, a, b, c), w)
    assert not state.requires_grad and y.requires_grad
    _hold(g, _grads_ref(lambda *t: _jax_ssd_scan(*t, chunk),
                        (x, dt, a, b, c), w), 1e-5)


def test_ssd_scan_grad_finite_where_the_decay_overflows():
    """At mamba2-scale decay (dt * |a| summed over a chunk past 88) the
    exp of the masked upper triangle overflows float32; B8's gradient
    stays finite and equals ``jax.grad`` of the reference model's own
    ``ssd_chunked``, which masks before the exp (``repro/kernels/ref.py``
    exponentiates first and gives NaN there)."""
    from repro.models import layers as ref_layers
    r = _rng(12)
    S, H, P, N, chunk = 64, 2, 4, 8, 32
    x = _t(r.standard_normal((1, S, H, P)).astype(np.float32))
    dt = _t(r.uniform(2.0, 6.0, (1, S, H)).astype(np.float32))
    a = _t(-r.uniform(4.0, 16.0, H).astype(np.float32))
    b, c = (_t(r.standard_normal((1, S, 1, N)).astype(np.float32))
            for _ in range(2))
    w = _t(r.standard_normal((1, S, H, P)).astype(np.float32))
    _, g = _grads_port(lambda *t: ops.ssd_scan(*t, chunk=chunk),
                       (x, dt, a, b, c), w)
    assert all(bool(torch.isfinite(t).all()) for t in g)
    want = _grads_ref(lambda *t: ref_layers.ssd_chunked(*t, chunk),
                      (x, dt, a, b, c), w)
    _hold(g, want, 1e-4)


def test_no_graph_under_no_grad_and_bf16_grads_keep_dtype():
    x = torch.randn(4, 32, dtype=torch.bfloat16, requires_grad=True)
    s = torch.ones(32, dtype=torch.bfloat16, requires_grad=True)
    with torch.no_grad():
        assert ops.rmsnorm(x, s).grad_fn is None
    gx, gs = torch.autograd.grad(ops.rmsnorm(x, s).float().sum(), (x, s))
    assert gx.dtype == gs.dtype == torch.bfloat16
    # inputs that need no grad make no graph either
    assert ops.rmsnorm(x.detach(), s.detach()).grad_fn is None


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

_FAMILY = {
    "dense": dict(name="d", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                  d_head=16, d_ff=128, vocab_size=97, qk_norm=True),
    "moe": dict(name="m", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_head=16, d_ff=96, vocab_size=97, n_experts=8, moe_top_k=2),
    "hybrid": dict(name="h", n_layers=3, d_model=64, n_heads=4,
                   n_kv_heads=2, d_head=16, d_ff=128, vocab_size=97,
                   block="hybrid", ssm_state=8, ssm_head_dim=16,
                   ssm_chunk=4, window_pattern=(4, 4, 0)),
    "ssm": dict(name="s", n_layers=2, d_model=64, n_heads=0, n_kv_heads=1,
                d_head=1, d_ff=0, vocab_size=97, block="ssm", ssm_state=16,
                ssm_head_dim=16, ssm_chunk=4),
}


class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts ``aten.mm`` calls while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _loss_grads(cfg, params, tokens, labels):
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    from repro_torch.optim.adamw import _unflatten
    p = _unflatten(params, leaves)
    h, aux = models.forward(p, cfg, tokens)
    loss = chunked_ce_loss(p, cfg, h, labels, 2) + 0.01 * aux
    mm = _CountMM()
    with mm:
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, mm.n


@pytest.mark.parametrize("family", sorted(_FAMILY))
def test_remat_policies_equal_none(family):
    base = models.LMConfig(**_FAMILY[family])
    params = models.init_params(base, 3, device=CPU)
    r = _rng(7)
    tokens = torch.from_numpy(r.integers(0, 97, (2, 8)).astype(np.int32))
    labels = torch.from_numpy(r.integers(0, 97, (2, 8)).astype(np.int32))
    got = {policy: _loss_grads(dataclasses.replace(base, remat=policy),
                               params, tokens, labels)
           for policy in ("none", "full", "dots")}
    loss0, grads0, mm_none = got["none"]
    for policy in ("full", "dots"):
        loss, grads, _ = got[policy]
        torch.testing.assert_close(loss, loss0, rtol=1e-6, atol=0)
        for g, g0 in zip(grads, grads0):
            torch.testing.assert_close(g, g0, rtol=1e-6, atol=1e-7)
    # "full" recomputes every layer's products in the backward pass;
    # "dots" keeps them (the loss chunks are recomputed under both)
    assert got["full"][2] > got["dots"][2] == mm_none
    # without autograd the forward takes no checkpoint at all
    with torch.no_grad():
        h_full = models.forward(params, dataclasses.replace(
            base, remat="full"), tokens)[0]
        assert torch.equal(h_full, models.forward(params, base, tokens)[0])


def test_remat_rejects_unknown_policy():
    cfg = models.LMConfig(**dict(_FAMILY["dense"], remat="most"))
    params = models.init_params(cfg, 0, device=CPU)
    p = {k: v for k, v in params.items()}
    p["embed"] = p["embed"].detach().requires_grad_()
    with pytest.raises(ValueError, match="remat 'most'"):
        models.forward(p, cfg, torch.zeros((1, 4), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the train step against the reference, the ten reduced configs
# ---------------------------------------------------------------------------


def _batch(cfg, index):
    """The reference's synthetic tokens (B 2, S 16; S 3 chunks for an SSM
    config) as inputs and labels; a stub-frontend config takes seeded
    (B, S, d_model) embeddings instead of token ids."""
    S = 3 * cfg.ssm_chunk if cfg.has_ssm else 16
    b = RefDataset(vocab_size=cfg.vocab_size, seq_len=S, global_batch=2,
                   seed=1).batch(index)
    if not cfg.embed_inputs:
        b["inputs"] = _rng(index).standard_normal(
            (2, S, cfg.d_model)).astype(np.float32)
    return b


def _close_tree(got, want, **tol):
    for g, w in zip(_leaves(got), jax.tree_util.tree_leaves(want),
                    strict=True):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("module", ARCH_MODULES)
def test_train_steps_equal_the_reference(module):
    rcfg, cfg = REF_ARCH[module].REDUCED, PORT_ARCH[module].REDUCED
    ref_step, ref_opt = ref_train.make_train_step(rcfg, n_loss_chunks=2)
    rstate = ref_train.make_train_state(rcfg, jax.random.PRNGKey(0), ref_opt)
    step, opt = make_train_step(cfg, n_loss_chunks=2)
    params = params_from_reference(rstate.params, CPU)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(ref_step)
    for i in range(2):
        b = _batch(rcfg, i)
        rstate, rm = jstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        assert sorted(m) == ["aux", "ce", "grad_norm", "loss", "lr"]
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert m[k].shape == () and m[k].dtype == torch.float32, k
            np.testing.assert_allclose(float(m[k]), float(rm[k]),
                                       rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=f"step {i + 1} {k}")
        assert int(state.step) == int(rstate.step) == i + 1
        assert int(state.opt.step) == i + 1
        _close_tree(state.params, rstate.params, **PARAM_TOL)
        for got, want in ((state.opt.m, rstate.opt.m),
                          (state.opt.v, rstate.opt.v)):
            for g, w in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
                w = np.asarray(w, np.float32)
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=MOMENT_RTOL,
                    atol=1e-4 * float(np.abs(w).max()))
    assert (float(m["aux"]) != 0.0) == cfg.is_moe


def test_train_state_factories():
    cfg = PORT_ARCH["qwen3_1_7b"].REDUCED
    st = make_train_state(cfg, 0, device=CPU)
    ab = make_train_state_abstract(cfg)
    assert isinstance(st, TrainState) and int(st.step) == 0
    assert st.step.dtype == torch.int32 and ab.step.device.type == "meta"
    for a, b in zip(_leaves(ab), _leaves(st), strict=True):
        assert a.device.type == "meta" and a.shape == b.shape
        assert a.dtype == b.dtype
    assert torch.equal(_leaves(st.params)[0],
                       _leaves(models.init_params(cfg, 0, device=CPU))[0])
    toks = torch.zeros((2, 5), dtype=torch.int32)
    last = make_prefill_step(cfg)(st.params, toks)
    h = models.forward(st.params, cfg, toks)[0]
    assert torch.equal(last, models.logits_fn(st.params, cfg,
                                              h[:, -1:])[:, 0])
    assert last.grad_fn is None
    ds = models.init_decode_state(cfg, 2, 8, torch.float32, device=CPU)
    lg, ds2 = make_decode_fn(cfg)(st.params, ds, toks[:, 0])
    assert lg.shape == (2, cfg.vocab_size) and int(ds2.length) == 1


def test_train_state_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_state(PORT_ARCH["qwen3_1_7b"].REDUCED, 0)


# ---------------------------------------------------------------------------
# B6 at the reduced configs' heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("module", [m for m in ARCH_MODULES
                                    if PORT_ARCH[m].REDUCED.has_attn])
def test_flash_checks_take_small_heads_in_float32(module):
    """B6's checks on meta tensors at the train CLI's shapes (B 8 x S 64,
    KV repeated to H heads) of each reduced config: its float32 route
    takes d 8 and 16 at their own width; the same heads in bf16 take the
    mma route at width 32 (its k16 fragments and tiling)."""
    cfg = PORT_ARCH[module].REDUCED
    assert cfg.d_head in (8, 16) and cfg.adtype == torch.float32
    q = torch.empty((8, 64, cfg.n_heads, cfg.d_head), device="meta")
    assert b6.flash_attention_route(q) == "fma"
    assert b6.check_inputs(q, q, q, window=8) == 0
    assert backend.padded_head_dim(cfg.d_head, b6.WIDTHS["fma"],
                                   "flash_attention") == cfg.d_head
    qb = q.to(torch.bfloat16)
    assert b6.flash_attention_route(qb) == "mma"
    assert b6.check_inputs(qb, qb, qb) == 1
    assert backend.padded_head_dim(cfg.d_head, b6.WIDTHS["mma"],
                                   "flash_attention") == 32
    assert b6.WIDTHS == {"fma": (8, 16, 32, 64, 128, 256),
                         "mma": (32, 64, 128, 256)}
