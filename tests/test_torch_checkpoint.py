"""The port's data pipeline, int8 gradient compression and checkpoints on
the CPU, against the reference's ``repro.data``, ``repro.optim.compression``
and ``repro.checkpoint``.

  - ``SyntheticLMDataset.batch`` bit-identical to the reference's (both
    draw with numpy), and ``make_train_iterator`` resumable.
  - int8 quantisation: within one quantisation step of the input and
    unbiased, the contracts of ``tests/test_substrate.py`` (the noise is a
    ``torch.Generator``'s, so the reference's bits cannot be matched);
    ``dequantize_int8`` equal to the reference's on the same ``q``,
    ``scale``; ``compressed_psum_grads`` on a one-process ``gloo`` group.
  - checkpoints in the reference's format: round trips (float32, bf16,
    int32, ``extra``), ``AsyncCheckpointer``'s gc, and a ``TrainState``
    saved by either package loading in the other, leaf for leaf.
"""

import json
import os
import socket
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro import data as ref_data  # noqa: E402
from repro.models import LMConfig as RefLMConfig  # noqa: E402
from repro.optim import compression as ref_comp  # noqa: E402
from repro.train import make_train_state as ref_make_train_state  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import data  # noqa: E402
from repro_torch.convert import params_from_reference, to_tensor  # noqa: E402
from repro_torch.models import LMConfig  # noqa: E402
from repro_torch.optim import (compressed_psum_grads,  # noqa: E402
                               dequantize_int8, make_optimizer, quantize_int8)
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.train import TrainState, make_train_state  # noqa: E402
from repro_torch.train import make_train_state_abstract  # noqa: E402

CPU = "cpu"
_CFG = dict(name="ck", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_head=8, d_ff=64, vocab_size=64, tie_embeddings=False,
            param_dtype="bfloat16", activ_dtype="bfloat16")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (128, 16, 4, 0), (128, 16, 4, 2), (256, 64, 8, 0), (50, 1, 3, 7),
    (151936, 33, 2, 5), (10, 2, 1, 1 << 12)])
def test_dataset_batches_bit_identical(vocab, seq, batch, seed):
    ref = ref_data.SyntheticLMDataset(vocab_size=vocab, seq_len=seq,
                                      global_batch=batch, seed=seed)
    port = data.SyntheticLMDataset(vocab_size=vocab, seq_len=seq,
                                   global_batch=batch, seed=seed)
    for index in (0, 1, 5, 1000, 2 ** 20 + 3):
        want, got = ref.batch(index), port.batch(index)
        assert sorted(got) == ["inputs", "labels"]
        for k in want:
            assert got[k].dtype == np.int32 and got[k].shape == (batch, seq)
            np.testing.assert_array_equal(got[k], want[k])


def test_iterator_is_resumable_and_matches_the_reference():
    ds = data.SyntheticLMDataset(vocab_size=97, seq_len=12, global_batch=3,
                                 seed=4)
    ref = ref_data.make_train_iterator(ref_data.SyntheticLMDataset(
        vocab_size=97, seq_len=12, global_batch=3, seed=4))
    it = data.make_train_iterator(ds, device=CPU)
    straight = [next(it) for _ in range(6)]
    for b in straight:
        want = next(ref)
        for k in ("inputs", "labels"):
            assert b[k].dtype == torch.int32 and b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(want[k]))
    resumed = data.make_train_iterator(ds, start_step=4, device=CPU)
    for want in straight[4:]:
        got = next(resumed)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_iterator_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = data.SyntheticLMDataset(vocab_size=8, seq_len=4, global_batch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(data.make_train_iterator(ds))


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("scale", [0.01, 0.37, 1.0, 42.0, 100.0])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_int8_quantization_bounded_error(scale, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        256).astype(np.float32) * scale)
    q, s = quantize_int8(x, _gen(seed + 1))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert int(q.abs().max()) <= 127
    err = float((dequantize_int8(q, s) - x).abs().max())
    assert err <= float(s) * 1.01        # within one quantization step


def test_int8_quantization_unbiased():
    x = torch.full((20000,), 0.3)
    q, s = quantize_int8(x, _gen(0))
    mean = float(dequantize_int8(q, s).mean())
    assert abs(mean - 0.3) < 2e-3        # stochastic rounding unbiased


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_keeps_bf16_inputs_and_zero(dtype):
    x = torch.zeros(64, dtype=dtype)
    q, s = quantize_int8(x, _gen(3))
    assert bool((q == 0).all()) and float(s) == pytest.approx(1e-12)
    y = torch.linspace(-2, 2, 64).to(dtype)
    q, s = quantize_int8(y, _gen(3))
    back = dequantize_int8(q, s, dtype)
    assert back.dtype == dtype
    assert float((back.float() - y.float()).abs().max()) <= 2.02 * float(s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_equals_the_reference(dtype):
    rng = np.random.default_rng(11)
    q = rng.integers(-127, 128, size=(7, 33)).astype(np.int8)
    for scale in (np.float32(1e-12), np.float32(0.0123), np.float32(3.5)):
        want = ref_comp.dequantize_int8(jnp.asarray(q), jnp.asarray(scale),
                                        jnp.dtype(dtype))
        got = dequantize_int8(torch.from_numpy(q),
                              torch.tensor(scale), getattr(torch, dtype))
        assert torch.equal(got, to_tensor(want, CPU))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def gloo_group():
    """A one-process ``gloo`` group on localhost, torn down after."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_compressed_psum_grads_one_process(gloo_group):
    rng = np.random.default_rng(5)
    grads = {"w": torch.from_numpy(rng.standard_normal((16, 8))
                                   .astype(np.float32)),
             "b": {"s": torch.from_numpy(rng.standard_normal(5)
                                         .astype(np.float32)
                                         ).to(torch.bfloat16)}}
    out = compressed_psum_grads(grads, gloo_group, _gen(9))
    assert sorted(out) == ["b", "w"] and sorted(out["b"]) == ["s"]
    for got, x in ((out["w"], grads["w"]), (out["b"]["s"], grads["b"]["s"])):
        assert got.dtype == x.dtype and got.shape == x.shape
        step = float(x.float().abs().max()) / 127.0
        # one participant: its own quantization, within one step (plus
        # the bf16 rounding of the result)
        assert float((got.float() - x.float()).abs().max()) <= \
            step * 1.01 + 2.0 ** -8 * float(x.float().abs().max())
    # the same noise stream gives the same mean as quantize / dequantize
    q, s = quantize_int8(grads["b"]["s"], _gen(9))
    again = compressed_psum_grads({"x": grads["b"]["s"]}, gloo_group,
                                  _gen(9))["x"]
    assert torch.equal(again, dequantize_int8(q, s, torch.bfloat16))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.linspace(-3, 3, 5).to(torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)}}


def _same(x, y):
    return (x.dtype == y.dtype and x.shape == y.shape
            and x.device == y.device and torch.equal(x, y))


def test_checkpoint_roundtrip():
    tree = _tree()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 7, tree, extra={"note": "x", "n": [1, 2]})
        assert ckpt.latest_step(d) == 7
        out, extra = ckpt.load_checkpoint(d, tree, device=CPU)
        assert extra == {"note": "x", "n": [1, 2]}
        assert _same(out["a"], tree["a"]) and _same(out["b"]["c"],
                                                    tree["b"]["c"])
        assert _same(out["b"]["d"], tree["b"]["d"])
        m = json.loads(open(os.path.join(d, "step_0000000007",
                                         "manifest.json")).read())
        assert [(x["path"], x["dtype"], x["shape"]) for x in m["leaves"]] \
            == [("a", "float32", [3, 4]), ("b/c", "bfloat16", [5]),
                ("b/d", "int32", [])]
        # bf16 as its raw 16-bit words: 2 bytes a value
        assert os.path.getsize(os.path.join(d, "step_0000000007",
                                            "leaf_00001.bin")) == 10


def test_float16_params_roundtrip_both_ways():
    """A float16 model's params (the reference builds float16 configs)
    saved by either package load in the other bit for bit, under the
    reference's dtype string ``float16``."""
    from repro.models import init_params as ref_init_params
    from repro_torch.models import init_params
    f16 = dict(_CFG, param_dtype="float16", activ_dtype="float16")
    port = init_params(LMConfig(**f16), torch.Generator().manual_seed(3))
    ref = ref_init_params(RefLMConfig(**f16), jax.random.PRNGKey(3))
    assert port["embed"].dtype == torch.float16
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 1, port)
        m = json.loads(open(os.path.join(d, "step_0000000001",
                                         "manifest.json")).read())
        assert {x["dtype"] for x in m["leaves"]} == {"float16"}
        back, _ = ckpt.load_checkpoint(d, port, device=CPU)
        got, _ = ref_ckpt.load_checkpoint(d, ref)
    for (pb, b), (pw, w) in zip(_leaves(back), _leaves(port), strict=True):
        assert pb == pw and _same(b, w), pb
    ref_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    for (kp, g), (path, w) in zip(ref_leaves, _leaves(port), strict=True):
        assert np.asarray(g).dtype == np.float16, path
        assert _same(to_tensor(g, CPU), w), path
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.save_checkpoint(d, 2, ref)
        got, _ = ckpt.load_checkpoint(d, port, device=CPU)
    want = params_from_reference(ref, device=CPU)
    for (pg, g), (pw, w) in zip(_leaves(got), _leaves(want), strict=True):
        assert pg == pw and _same(g, w), pg


def test_checkpoint_loads_into_like_dtype_and_meta_skeleton():
    tree = _tree()
    like = {"a": torch.empty((3, 4), dtype=torch.bfloat16, device="meta"),
            "b": {"c": torch.empty(5, dtype=torch.float32, device="meta"),
                  "d": torch.empty((), dtype=torch.int64, device="meta")}}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 1, tree)
        out, extra = ckpt.load_checkpoint(d, like, device=CPU)
        assert extra == {}
        assert _same(out["a"], tree["a"].to(torch.bfloat16))
        assert _same(out["b"]["c"], tree["b"]["c"].float())
        assert _same(out["b"]["d"], tree["b"]["d"].long())
        with pytest.raises(KeyError, match="no leaf"):
            ckpt.load_checkpoint(d, {"zz": tree["a"]}, device=CPU)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            ckpt.load_checkpoint(d, tree, device=CPU)


def test_checkpoint_load_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 1, _tree())
        with pytest.raises(RuntimeError, match="CUDA"):
            ckpt.load_checkpoint(d, _tree())


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_async_checkpointer_gc(keep):
    tree = {"w": torch.ones((4, 4))}
    with tempfile.TemporaryDirectory() as d:
        ck = ckpt.AsyncCheckpointer(d, keep=keep)
        for s in (1, 2, 3, 4):
            ck.save(s, {"w": tree["w"] * s}, extra={"s": s})
        ck.wait()
        assert ckpt.latest_step(d) == 4
        assert sorted(os.listdir(d)) == [f"step_{s:010d}"
                                         for s in range(5 - keep, 5)]
        out, extra = ckpt.load_checkpoint(d, tree, device=CPU)
        assert extra == {"s": 4} and torch.equal(out["w"], tree["w"] * 4)
        out, _ = ckpt.load_checkpoint(d, tree, step=5 - keep, device=CPU)
        assert torch.equal(out["w"], tree["w"] * (5 - keep))


def test_async_checkpointer_copies_before_returning():
    """``save`` takes the host copy on the caller's thread: changing the
    tensor after it returns does not reach the file."""
    w = torch.zeros(1000)
    with tempfile.TemporaryDirectory() as d:
        ck = ckpt.AsyncCheckpointer(d)
        ck.save(1, {"w": w})
        w.fill_(5.0)
        ck.wait()
        out, _ = ckpt.load_checkpoint(d, {"w": w}, device=CPU)
        assert bool((out["w"] == 0).all())


def test_async_checkpointer_surfaces_writer_errors():
    with tempfile.TemporaryDirectory() as d:
        target = os.path.join(d, "file")
        open(target, "w").close()
        ck = ckpt.AsyncCheckpointer(target)      # a file, not a directory
        ck.save(1, {"w": torch.ones(2)})
        with pytest.raises(OSError):
            ck.wait()
        ck.wait()                                # the error is raised once


def _ref_state(seed=0):
    cfg = RefLMConfig(**_CFG)
    return ref_make_train_state(cfg, jax.random.PRNGKey(seed))


def _port_state_from(ref_state):
    p = params_from_reference(ref_state.params, CPU)
    opt = AdamWState(to_tensor(ref_state.opt.step, CPU),
                     params_from_reference(ref_state.opt.m, CPU),
                     params_from_reference(ref_state.opt.v, CPU))
    return TrainState(p, opt, to_tensor(ref_state.step, CPU))


def _leaves(tree):
    return ckpt.checkpoint._flatten_with_paths(tree)


def test_train_state_paths_are_the_references():
    cfg = LMConfig(**_CFG)
    st = make_train_state_abstract(cfg)
    ref = jax.tree_util.tree_flatten_with_path(_ref_state())[0]
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp) for kp, _ in ref]
    assert [p for p, _ in _leaves(st)] == want
    assert {".params/embed", ".opt/.step", ".opt/.m/layers/attn/wk",
            ".step"} <= set(want)


def test_reference_checkpoint_loads_in_the_port():
    ref = _ref_state(3)
    # one AdamW-like change so m, v and the steps are not all zeros
    ref = ref._replace(
        opt=ref.opt._replace(
            step=jnp.asarray(4, jnp.int32),
            m=jax.tree_util.tree_map(lambda x: (x * 0.5).astype(x.dtype),
                                     ref.params),
            v=jax.tree_util.tree_map(lambda x: (x * x).astype(x.dtype),
                                     ref.params)),
        step=jnp.asarray(4, jnp.int32))
    like = make_train_state(LMConfig(**_CFG), 1, device=CPU)
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.save_checkpoint(d, 4, ref, extra={"by": "reference"})
        got, extra = ckpt.load_checkpoint(d, like, device=CPU)
    assert extra == {"by": "reference"}
    want = _port_state_from(ref)
    for (pg, g), (pw, w) in zip(_leaves(got), _leaves(want), strict=True):
        assert pg == pw and _same(g, w), pg


def test_port_checkpoint_loads_in_the_reference():
    cfg = LMConfig(**_CFG)
    port = make_train_state(cfg, 5, make_optimizer(), device=CPU)
    port = port._replace(step=port.step + 9,
                         opt=port.opt._replace(step=port.opt.step + 9))
    like = _ref_state(0)
    with tempfile.TemporaryDirectory() as d:
        ck = ckpt.AsyncCheckpointer(d)
        ck.save(9, port, extra={"by": "port"})
        ck.wait()
        assert ref_ckpt.latest_step(d) == 9
        got, extra = ref_ckpt.load_checkpoint(d, like)
    assert extra == {"by": "port"}
    ref_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(ref_leaves) == len(_leaves(port))
    for (kp, g), (path, w) in zip(ref_leaves, _leaves(port)):
        assert np.asarray(g).dtype.name == {
            torch.bfloat16: "bfloat16", torch.int32: "int32"}[w.dtype], path
        assert _same(to_tensor(g, CPU), w), path
