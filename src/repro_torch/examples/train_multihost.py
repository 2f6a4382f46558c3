"""Distributed-training walkthrough on an 8-rank mesh, on the port
(``examples/train_multihost.py`` of the reference): FSDP+TP sharded
train steps on a (4, 2) mesh, then elastic checkpoint restore onto a
(2, 1) mesh, the UFA Restore-Later path for a preempted training job.

  PYTHONPATH=src python -m repro_torch.examples.train_multihost \\
      [--device cpu]

Each phase spawns its ranks over ``torch.distributed``
(``launch.mesh.run_ranks``, a ``FileStore`` rendezvous), 8 and then 2
processes, where the reference re-executes itself with 8 and 2 fake XLA
host devices.  ``--device cpu``: gloo ranks on the CPU.  ``cuda``: NCCL
with one rank a card where the host has a card for every rank; with
fewer cards the ranks share them over gloo (its collectives staging
CUDA tensors through the host), which the driver says on standard
error.  Rank 0 prints the losses and writes the checkpoint (the whole
leaves, gathered).  The weights are the port's ``init_params(cfg, 0)``
drawn on the CPU (the reference draws ``jax.random.PRNGKey(0)``'s), so
the losses follow the port's weights.
"""

import argparse
import contextlib
import io
import sys
import tempfile

import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.data import SyntheticLMDataset
from repro_torch.dist.ctx import sharding_rules
from repro_torch.dist.sharding import param_shardings
from repro_torch.dist.smap import put
from repro_torch.examples.common import add_device_arg, train_state
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.mesh import (init_world, make_local_mesh,
                                     run_ranks)
from repro_torch.models import LMConfig
from repro_torch.optim import AdamWState
from repro_torch.train import TrainState, make_train_step

CFG = dict(name="mh", n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
           d_head=16, d_ff=256, vocab_size=512, tie_embeddings=True)
PHASES = {"train8": ((4, 2), 6, 0), "resume2": ((2, 1), 4, 6)}


def _phase_rank(rank: int, world: int, init_file: str, phase: str,
                ckdir: str, device: str, backend) -> str:
    """One rank of ``phase``; returns what it printed."""
    torch.set_num_threads(1)        # the ranks share one host
    dev = init_world(init_file, rank, world, device, backend=backend)
    (d, m), n_steps, start = PHASES[phase]
    cfg = LMConfig(**CFG)
    mesh = make_local_mesh(d, m, device=dev)
    ps = param_shardings(cfg, mesh)
    specs = TrainState(ps, AdamWState((), ps, ps), ())
    step_fn, opt = make_train_step(cfg, n_loss_chunks=2)
    state = train_state(cfg, 0, opt, dev)
    if phase == "resume2":
        # elastic reshard-on-load: each rank reads its blocks alone
        state, _ = load_checkpoint(ckdir, state, device=dev,
                                   shardings=specs, mesh=mesh)
    else:
        state = put(state, specs, mesh)
    ds = SyntheticLMDataset(vocab_size=512, seq_len=32, global_batch=8,
                            seed=3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), sharding_rules(mesh):
        for i in range(start, start + n_steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in ds.batch(i).items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            if rank == 0:
                print(f"[{phase}] devices={world} step {i} loss {loss:.4f}")
    if phase == "train8":
        save_checkpoint(ckdir, start + n_steps, state, shardings=specs,
                        mesh=mesh)
    return buf.getvalue()


def run(phase: str, devices: int, ckdir: str, dev: torch.device) -> None:
    """One phase over ``devices`` spawned ranks; prints rank 0's lines."""
    backend = None
    if dev.type == "cuda" and devices > torch.cuda.device_count():
        backend = "gloo"
        print(f"train_multihost: {devices} ranks share "
              f"{torch.cuda.device_count()} card(s) over gloo",
              file=sys.stderr)
    out = run_ranks(_phase_rank, devices,
                    (phase, ckdir, dev.type, backend))
    print(out[0], end="", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    dev = resolve_device(ap.parse_args(argv).device)
    with tempfile.TemporaryDirectory() as ckdir:
        print("== phase 1: FSDP+TP training on a 4x2 mesh (8 devices) ==")
        run("train8", 8, ckdir, dev)
        print("== phase 2: preempted; elastic restore on a 2x1 mesh ==")
        run("resume2", 2, ckdir, dev)
        print("OK — the job continued on 4x fewer devices from the same "
              "checkpoint (UFA Restore-Later semantics)")


if __name__ == "__main__":
    main()
