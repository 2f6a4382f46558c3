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
``SyntheticLMDataset`` (bit-identical).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --devices 4 --mesh 2x2 --device cpu

With --devices N > 1 the launcher spawns N ranks (``torch.multiprocessing``,
a ``FileStore`` rendezvous in a temporary directory; ``gloo`` for --device
cpu, ``nccl`` for cuda, rank r on card r % device_count) over a live
(D, M) mesh (--mesh DxM, default Nx1): the state is placed by
``dist.sharding.param_shardings`` (each rank its blocks), every rank
reads the same global batches and the train step keeps its block, and
rank 0 prints and writes the checkpoints (gathered whole, the unsharded
format).  The reference re-executes itself with fake XLA devices
instead.  --mesh without --devices > 1 stays on one device, as in the
reference.  A checkpoint is written every 50 steps and at the end,
under --ckpt-dir (default: a directory in the system's temporary
directory).
"""

import argparse
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_arch
from repro_torch.dist.ctx import sharding_rules
from repro_torch.dist.sharding import param_shardings
from repro_torch.dist.smap import put
from repro_torch.launch.mesh import init_world, make_local_mesh
from repro_torch.data import SyntheticLMDataset, make_train_iterator
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import init_params
from repro_torch.optim import AdamWState, cosine_schedule, make_optimizer
from repro_torch.optim.adamw import _tree_map
from repro_torch.train import TrainState, make_train_step
from repro_torch.train.trainer import Trainer


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config (the card only)")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--mesh", default="",
                    help="DxM mesh, e.g. 4x2 (defaults to devicesx1)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    return ap


def _run(args, rank: int = 0, init_file: str = ""):
    """One rank of the run (the only one without a mesh); returns the
    ``TrainerReport``."""
    arch = get_arch(args.arch)
    cfg = arch.config if args.full else arch.reduced
    mesh = None
    if args.devices > 1:
        d, m = (map(int, args.mesh.split("x")) if args.mesh
                else (args.devices, 1))
        dev = init_world(init_file, rank, args.devices, args.device)
        mesh = make_local_mesh(d, m, device=dev)
    else:
        dev = resolve_device(args.device)
    if rank == 0:
        print(f"arch={args.arch} cfg={cfg.name} "
              f"params={cfg.param_count()/1e6:.1f}M devices={args.devices}",
              flush=True)

    opt = make_optimizer(lr=cosine_schedule(3e-3, 10, args.steps))
    step_fn, _ = make_train_step(cfg, opt, n_loss_chunks=2)
    params = init_params(cfg, 0, device="cpu")
    specs = None
    if mesh is not None:
        ps = param_shardings(cfg, mesh)
        specs = TrainState(ps, AdamWState((), ps, ps), ())
        params = put(params, ps, mesh)
    params = _tree_map(lambda t: t.to(dev), params)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                            global_batch=args.batch, seed=0)
    if mesh is not None:
        def step(state, batch):
            with sharding_rules(mesh):
                return step_fn(state, batch)
    else:
        step = step_fn
    trainer = Trainer(cfg, step, args.ckpt_dir, checkpoint_every=50,
                      mesh=mesh, shardings=specs)
    state, rep = trainer.run(state, make_train_iterator(ds, device=dev),
                             args.steps)
    if rank == 0:
        print(f"done: {rep.steps_done} steps, loss {rep.losses[0]:.3f} -> "
              f"{rep.final_loss:.3f}, stragglers={len(rep.straggler_steps)}",
              flush=True)
    return rep


def _rank_main(rank: int, args, init_file: str, queue):
    if args.device == "cpu":
        torch.set_num_threads(1)
    try:
        rep = _run(args, rank, init_file)
        queue.put((rank, rep, None))
    except BaseException as e:  # reported by the parent
        queue.put((rank, None, f"{type(e).__name__}: {e}"))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    """Runs the CLI; returns rank 0's ``TrainerReport``."""
    args = _parser().parse_args(argv)
    if args.devices <= 1:
        return _run(args)
    d, m = (map(int, args.mesh.split("x")) if args.mesh
            else (args.devices, 1))
    if d * m != args.devices:
        raise ValueError(f"--mesh {args.mesh} does not cover --devices "
                         f"{args.devices}")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, args, init_file, queue))
                 for r in range(args.devices)]
        for p in procs:
            p.start()
        results = {}
        try:
            while len(results) < args.devices:
                rank, rep, err = queue.get(timeout=3600)
                results[rank] = (rep, err)
                if err is not None:
                    break
        finally:
            for p in procs:
                p.join(timeout=60 if not any(
                    e for _, e in results.values()) else 5)
                if p.is_alive():
                    p.kill()
                    p.join()
    errors = {r: e for r, (_, e) in results.items() if e}
    if errors or len(results) < args.devices:
        raise RuntimeError(f"train ranks failed: {errors or results}")
    return results[0][0]


if __name__ == "__main__":
    main()
