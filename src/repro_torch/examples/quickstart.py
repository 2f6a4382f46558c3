"""Quickstart, on the port (``examples/quickstart.py`` of the reference):
train a tiny decoder LM (4 layers; B4 and B6 forward on the card, their
plain versions' backwards) for 80 steps, with checkpointing and the
straggler watchdog; the loss must fall by more than 0.25.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The weights are the port's ``init_params(cfg, 0)``, drawn on the CPU
whatever the device, so a card run trains a CPU run's weights.  The
reference draws ``jax.random.PRNGKey(0)``'s, which the port cannot
reproduce; the port trained from the reference's own seed-0 weights
prints the reference's losses (``tests/test_torch_examples_models.py``).
"""

import argparse
import tempfile

from repro_torch.data import SyntheticLMDataset, make_train_iterator
from repro_torch.examples.common import add_device_arg, train_state
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import LMConfig
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.train import make_train_step
from repro_torch.train.trainer import Trainer

SEED = 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = LMConfig(name="quickstart", n_layers=4, d_model=128, n_heads=4,
                   n_kv_heads=2, d_head=32, d_ff=256, vocab_size=256,
                   tie_embeddings=True)
    print(f"model: {cfg.param_count()/1e6:.2f}M params")

    opt = make_optimizer(lr=cosine_schedule(8e-3, warmup=8, total=80),
                         weight_decay=0.01)
    step, _ = make_train_step(cfg, opt, n_loss_chunks=2)
    state = train_state(cfg, SEED, opt, dev)
    ds = SyntheticLMDataset(vocab_size=256, seq_len=64, global_batch=16,
                            seed=0, n_clusters=8)

    with tempfile.TemporaryDirectory() as ckdir:
        trainer = Trainer(cfg, step, ckdir, checkpoint_every=20)
        state, rep = trainer.run(state, make_train_iterator(ds, device=dev),
                                 n_steps=80)
    print(f"step  1 loss: {rep.losses[0]:.3f}")
    print(f"step {rep.steps_done} loss: {rep.final_loss:.3f}")
    assert rep.final_loss < rep.losses[0] - 0.25, "model must learn"
    print("OK — loss decreased; checkpointing + straggler watchdog exercised")


if __name__ == "__main__":
    main()
