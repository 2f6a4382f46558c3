"""Training launcher (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 20 [--device cuda|cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --full --batch 2 --seq 2048 --steps 4        # the card only

Uses the REDUCED config by default (trainable on the CPU); --full
selects the full assigned config.  --device (default cuda) is where the
weights lie and the steps run.  The weights are the port's
``init_params(cfg, 0)`` drawn on the CPU and moved to --device, so a run
on the card trains the same weights as one on the CPU (a generator on
the card draws other numbers); the batches are the reference's
``SyntheticLMDataset`` (bit-identical).  The port runs on one device:
--devices > 1 and --mesh raise (ROADMAP Queue A item 3).  A checkpoint
is written every 50 steps and at the end, under --ckpt-dir (default: a
directory in the system's temporary directory).
"""

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLMDataset, make_train_iterator
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import init_params
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.optim.adamw import _tree_map
from repro_torch.train import TrainState, make_train_step
from repro_torch.train.trainer import Trainer


def main(argv=None):
    """Runs the CLI; returns the ``TrainerReport``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config (the card only)")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--mesh", default="",
                    help="DxM mesh (not on one device: ROADMAP Queue A "
                         "item 3)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.devices > 1 or args.mesh:
        raise NotImplementedError(
            f"--devices {args.devices} --mesh {args.mesh!r}: the port trains "
            "on one device; data and model parallelism over a mesh come "
            "with ROADMAP Queue A item 3")

    arch = get_arch(args.arch)
    cfg = arch.config if args.full else arch.reduced
    print(f"arch={args.arch} cfg={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"devices=1")

    opt = make_optimizer(lr=cosine_schedule(3e-3, 10, args.steps))
    step_fn, _ = make_train_step(cfg, opt, n_loss_chunks=2)
    dev = resolve_device(args.device)
    params = _tree_map(lambda t: t.to(dev),
                       init_params(cfg, 0, device="cpu"))
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                            global_batch=args.batch, seed=0)
    trainer = Trainer(cfg, step_fn, args.ckpt_dir, checkpoint_every=50)
    state, rep = trainer.run(state, make_train_iterator(
        ds, device=args.device), args.steps)

    print(f"done: {rep.steps_done} steps, loss {rep.losses[0]:.3f} -> "
          f"{rep.final_loss:.3f}, stragglers={len(rep.straggler_steps)}")
    return rep


if __name__ == "__main__":
    main()
