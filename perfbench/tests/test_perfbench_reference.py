"""Each reference family against a float64 computation of the same
semantics, written out token by token, at a reduced size on the CPU."""

import math

import pytest
import torch
import torch.nn.functional as F

from pbharness import files

attn_moe = files.load_module("reference", "attn_moe")
mamba2 = files.load_module("reference", "mamba2")
lm = files.load_module("reference", "lm")


def _rms(x, scale, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _moe_conf(capacity_factor):
    return {"lm_config": {"n_heads": 4, "n_kv_heads": 2, "d_head": 8},
            "semantics": {"norm_eps": 1e-5, "rope_theta": 1e4, "top_k": 2,
                          "capacity_factor": capacity_factor,
                          "capacity_multiple": 8, "capacity_min": 8}}


def _moe_layer(gen, D=32, H=4, KV=2, d=8, E=4, Fd=24):
    def w(*shape, s=0.2):
        return torch.randn(shape, generator=gen, dtype=torch.float64) * s
    return {"ln1/scale": 1 + w(D, s=0.1), "ln2/scale": 1 + w(D, s=0.1),
            "attn/wq": w(D, H * d), "attn/wk": w(D, KV * d),
            "attn/wv": w(D, KV * d), "attn/wo": w(H * d, D),
            "moe/router": w(D, E, s=0.5), "moe/w_gate": w(E, D, Fd),
            "moe/w_up": w(E, D, Fd), "moe/w_down": w(E, Fd, D)}


def _attn_moe_by_token(lp, h, conf):
    """The layer in float64, one query and one (token, slot) at a time."""
    lc, sem = conf["lm_config"], conf["semantics"]
    B, S, D = h.shape
    H, KV, d = lc["n_heads"], lc["n_kv_heads"], lc["d_head"]
    x = _rms(h, lp["ln1/scale"], sem["norm_eps"])

    def rot(t):  # (S, heads, d)
        out = torch.empty_like(t)
        for s in range(S):
            for i in range(d // 2):
                a = s * sem["rope_theta"] ** (-2 * i / d)
                c, si = math.cos(a), math.sin(a)
                out[s, :, i] = t[s, :, i] * c - t[s, :, i + d // 2] * si
                out[s, :, i + d // 2] = t[s, :, i + d // 2] * c + t[s, :, i] * si
        return out

    att = torch.zeros(B, S, H * d, dtype=torch.float64)
    for b in range(B):
        q = rot((x[b] @ lp["attn/wq"]).reshape(S, H, d))
        k = rot((x[b] @ lp["attn/wk"]).reshape(S, KV, d))
        v = (x[b] @ lp["attn/wv"]).reshape(S, KV, d)
        for hh in range(H):
            g = hh // (H // KV)
            for i in range(S):
                sc = torch.stack([q[i, hh] @ k[j, g] / math.sqrt(d)
                                  for j in range(i + 1)])
                p = torch.softmax(sc, 0)
                att[b, i, hh * d:(hh + 1) * d] = sum(p[j] * v[j, g]
                                                     for j in range(i + 1))
    h = h + att @ lp["attn/wo"]
    x = _rms(h, lp["ln2/scale"], sem["norm_eps"]).reshape(B * S, D)
    T, E = B * S, lp["moe/router"].shape[1]
    cap = max(8, -(-math.ceil(T * 2 * sem["capacity_factor"] / E) // 8) * 8)
    choice = []
    for t in range(T):
        p = torch.softmax(x[t] @ lp["moe/router"], 0)
        order = sorted(range(E), key=lambda e: (-float(p[e]), e))[:2]
        wsum = p[order[0]] + p[order[1]]
        choice.append([(e, p[e] / wsum) for e in order])
    filled = [0] * E
    y = torch.zeros_like(x)
    for slot in range(2):
        for t in range(T):
            e, wt = choice[t][slot]
            if filled[e] < cap:
                filled[e] += 1
                hid = F.silu(x[t] @ lp["moe/w_gate"][e]) * (x[t] @ lp["moe/w_up"][e])
                y[t] += wt * (hid @ lp["moe/w_down"][e])
    return h + y.reshape(B, S, D), filled, cap


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_attn_moe_layer_against_float64_by_token(capacity_factor):
    gen = torch.Generator().manual_seed(34)
    lp64 = _moe_layer(gen)
    conf = _moe_conf(capacity_factor)
    h64 = torch.randn(2, 24, 32, generator=gen, dtype=torch.float64)
    want, filled, cap = _attn_moe_by_token(lp64, h64, conf)
    if capacity_factor < 1:   # the drops are exercised
        assert max(filled) == cap
    lp32 = {k: v.float() for k, v in lp64.items()}
    got = attn_moe.layer(lp32, h64.float(), conf, lm.FLOAT32)
    assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4)


def test_attention_blocks_equal_one_block(monkeypatch):
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(1, 64, 4, 8, generator=gen)
    k = torch.randn(1, 64, 2, 8, generator=gen)
    v = torch.randn(1, 64, 2, 8, generator=gen)
    whole = attn_moe.causal_attention(q, k, v, lm.float32_mm)
    monkeypatch.setattr(attn_moe, "SCORES_BYTES", 4 * 4 * 64 * 16)
    blocked = attn_moe.causal_attention(q, k, v, lm.float32_mm)
    assert torch.allclose(whole, blocked, atol=1e-6)


def _ssd_sequential(x, dt, A, Bm, Cm):
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.zeros_like(x)
    for b in range(Bsz):
        for hh in range(H):
            g = hh // (H // G)
            st = torch.zeros(P, N, dtype=x.dtype)
            for t in range(S):
                st = st * torch.exp(dt[b, t, hh] * A[hh]) + \
                    dt[b, t, hh] * torch.outer(x[b, t, hh], Bm[b, t, g])
                y[b, t, hh] = st @ Cm[b, t, g]
    return y


@pytest.mark.parametrize("S,chunk,G", [(37, 8, 1), (32, 16, 2), (5, 8, 1)])
def test_ssd_dual_form_against_the_recurrence(S, chunk, G):
    gen = torch.Generator().manual_seed(S)
    x = torch.randn(2, S, 4, 3, generator=gen, dtype=torch.float64)
    dt = F.softplus(torch.randn(2, S, 4, generator=gen, dtype=torch.float64))
    A = -torch.rand(4, generator=gen, dtype=torch.float64) * 2
    Bm = torch.randn(2, S, G, 5, generator=gen, dtype=torch.float64)
    Cm = torch.randn(2, S, G, 5, generator=gen, dtype=torch.float64)
    want = _ssd_sequential(x, dt, A, Bm, Cm)
    got = mamba2.ssd(x.float(), dt.float(), A.float(), Bm.float(), Cm.float(),
                     chunk=chunk)
    assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4)


def test_mamba2_layer_against_float64_by_token():
    gen = torch.Generator().manual_seed(2405)
    D, P, N = 16, 8, 6
    d_inner, H, K = 2 * D, 4, 4
    conf = {"lm_config": {"ssm_expand": 2, "ssm_head_dim": P, "ssm_state": N},
            "semantics": {"norm_eps": 1e-5, "gated_norm_eps": 1e-6, "d_conv": K}}
    conv_dim = d_inner + 2 * N

    def w(*shape, s=0.3):
        return torch.randn(shape, generator=gen, dtype=torch.float64) * s
    lp = {"ln1/scale": 1 + w(D, s=0.1), "ssm/in_proj": w(D, 2 * d_inner + 2 * N + H),
          "ssm/conv_w": w(K, conv_dim), "ssm/conv_b": w(conv_dim),
          "ssm/dt_bias": w(H), "ssm/a_log": torch.log(torch.linspace(1, 16, H, dtype=torch.float64)),
          "ssm/d_skip": 1 + w(H), "ssm/norm/scale": 1 + w(d_inner, s=0.1),
          "ssm/out_proj": w(d_inner, D)}
    h = torch.randn(2, 21, D, generator=gen, dtype=torch.float64)
    S = h.shape[1]
    x = _rms(h, lp["ln1/scale"], 1e-5)
    zxbcdt = x @ lp["ssm/in_proj"]
    z, u, dt = (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:2 * d_inner + 2 * N],
                zxbcdt[..., 2 * d_inner + 2 * N:])
    conv = torch.zeros_like(u)
    for t in range(S):
        for i in range(K):
            src = t - (K - 1) + i
            if src >= 0:
                conv[:, t] += lp["ssm/conv_w"][i] * u[:, src]
    u = F.silu(conv + lp["ssm/conv_b"])
    xs = u[..., :d_inner].reshape(2, S, H, P)
    Bm = u[..., d_inner:d_inner + N].reshape(2, S, 1, N)
    Cm = u[..., d_inner + N:].reshape(2, S, 1, N)
    dtv = F.softplus(dt + lp["ssm/dt_bias"])
    A = -torch.exp(lp["ssm/a_log"])
    y = _ssd_sequential(xs, dtv, A, Bm, Cm) + lp["ssm/d_skip"][:, None] * xs
    y = y.reshape(2, S, d_inner) * F.silu(z)
    want = h + _rms(y, lp["ssm/norm/scale"], 1e-6) @ lp["ssm/out_proj"]
    got = mamba2.layer({k: v.float() for k, v in lp.items()}, h.float(), conf,
                       lm.FLOAT32)
    assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4)


def test_last_logits_runs_the_stack_and_the_tied_head():
    gen = torch.Generator().manual_seed(1)
    conf = {"lm_config": {"n_layers": 2, "tie_embeddings": True},
            "semantics": {"norm_eps": 1e-5}}

    class Twice:
        @staticmethod
        def layer(lp, h, conf, prec):
            return h * lp["w"]

    params = {"embed": torch.randn(10, 4, generator=gen).bfloat16(),
              "layers": {"w": torch.tensor([[2.0], [3.0]])},
              "final_norm": {"scale": torch.ones(4)}}
    ids = torch.tensor([[1, 2, 3]])
    (got,) = lm.last_logits(conf, params, [ids], Twice)
    h = params["embed"][3].float() * 6
    want = (h * torch.rsqrt(h.pow(2).mean() + 1e-5)) @ params["embed"].float().T
    assert torch.allclose(got[0], want, atol=1e-5)
