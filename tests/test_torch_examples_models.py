"""The port's model drivers against the reference's
(``examples/serve_batched.py``, ``quickstart.py``,
``train_multihost.py``), run in this process on the CPU, every printed
line equal under ``repro_torch.examples.compare``'s rules with the
losses masked (they follow the random weights, which the port draws from
its own generator); the losses are held instead to the reference
driver's asserts and to the port's own runs: the quickstart trained from
the reference's seed-0 weights prints the reference's losses, and the
sharded (4, 2) and resharded (2, 1) meshes print a one-device run's.
Also: every driver raises under its default ``--device cuda`` when
there is no card."""

import contextlib
import io
import re
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_examples import (  # noqa: E402,F401
    assert_same, one_torch_thread, planes_off, run_port, run_reference)
from repro_torch.examples import NAMES  # noqa: E402


def _losses(text: str, pat: str) -> list:
    return [float(x) for x in re.findall(pat, text)]


def test_serve_batched_prints_the_reference_lines():
    want = run_reference("serve_batched")
    got = run_port("serve_batched")
    assert_same("serve_batched", got, want)
    # the driver's assert (serve_batched.py:77): T1 at 1.00 throughout
    assert re.search(r"^\s+T1\s+\d+\s+0\s+1\.00$", got, re.M)


def test_quickstart_prints_the_reference_lines_and_learns():
    want = run_reference("quickstart")
    got = run_port("quickstart")
    assert_same("quickstart", got, want)
    first, last = _losses(got, r"loss: (\d+\.\d+)")
    assert last < first - 0.25          # quickstart.py:35
    # the port trained from the reference's own seed-0 weights prints the
    # reference's two losses
    import jax
    from repro.models import LMConfig as RefConfig
    from repro.models import init_params as ref_init
    from repro_torch.convert import params_from_reference
    from repro_torch.data import SyntheticLMDataset, make_train_iterator
    from repro_torch.models import LMConfig
    from repro_torch.optim import cosine_schedule, make_optimizer
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.train.trainer import Trainer
    kw = dict(name="quickstart", n_layers=4, d_model=128, n_heads=4,
              n_kv_heads=2, d_head=32, d_ff=256, vocab_size=256,
              tie_embeddings=True)
    cfg = LMConfig(**kw)
    params = params_from_reference(
        ref_init(RefConfig(**kw), jax.random.PRNGKey(0)), "cpu")
    opt = make_optimizer(lr=cosine_schedule(8e-3, warmup=8, total=80),
                         weight_decay=0.01)
    step, _ = make_train_step(cfg, opt, n_loss_chunks=2)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    ds = SyntheticLMDataset(vocab_size=256, seq_len=64, global_batch=16,
                            seed=0, n_clusters=8)
    with tempfile.TemporaryDirectory() as ckdir:
        trainer = Trainer(cfg, step, ckdir, checkpoint_every=20)
        _, rep = trainer.run(state, make_train_iterator(ds, device="cpu"),
                             n_steps=80)
    np.testing.assert_allclose(
        [rep.losses[0], rep.final_loss],
        _losses(want, r"loss: (\d+\.\d+)"), rtol=0, atol=1e-3)


def _one_device_losses() -> list:
    """train_multihost's ten steps on one device: the same weights,
    batches and optimizer, no mesh."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.examples.common import train_state
    from repro_torch.examples.train_multihost import CFG
    from repro_torch.models import LMConfig
    from repro_torch.train import make_train_step
    cfg = LMConfig(**CFG)
    step_fn, opt = make_train_step(cfg, n_loss_chunks=2)
    state = train_state(cfg, 0, opt, torch.device("cpu"))
    ds = SyntheticLMDataset(vocab_size=512, seq_len=32, global_batch=8,
                            seed=3)
    out = []
    for i in range(10):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch(i).items()}
        state, m = step_fn(state, batch)
        out.append(float(m["loss"]))
    return out


def test_train_multihost_prints_the_reference_lines():
    """The reference driver's 8-device phase stops in this JAX
    (``ShardingTypeError`` at the embedding gather of its sharded
    params) and it exits 1 after its first line; the port prints that
    line and then the lines the reference's program prints for each
    step, and its sharded losses are a one-device run's."""
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        try:
            want = run_reference("train_multihost")
            failed = False
        except SystemExit as e:
            failed = e.code != 0
    got = run_port("train_multihost")
    lines = got.splitlines()
    if failed:
        assert "ShardingTypeError" in buf.getvalue()
        want = (["== phase 1: FSDP+TP training on a 4x2 mesh (8 devices) =="]
                + [f"[train8] devices=8 step {i} loss 0.0" for i in range(6)]
                + ["== phase 2: preempted; elastic restore on a 2x1 mesh =="]
                + [f"[resume2] devices=2 step {i} loss 0.0"
                   for i in range(6, 10)]
                + ["OK — the job continued on 4x fewer devices from the same "
                   "checkpoint (UFA Restore-Later semantics)"])
        want = "\n".join(want) + "\n"
    assert_same("train_multihost", got, want)
    assert len(lines) == 13
    got_losses = _losses(got, r"loss (\d+\.\d+)")
    np.testing.assert_allclose(got_losses, _one_device_losses(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_driver_default_device_is_cuda_and_never_falls_back(name,
                                                             monkeypatch):
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(RuntimeError,
                                                        match="CUDA"):
        mod.main([])
    assert buf.getvalue() == ""          # nothing ran before it raised
