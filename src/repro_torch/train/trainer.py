"""Training loop with fault-tolerance machinery (port of
``repro/train/trainer.py``).

- periodic async checkpointing (non-blocking);
- a straggler watchdog: per-step wall-time EWMA; a step exceeding
  ``straggler_factor`` x EWMA is recorded and (beyond ``max_strays``)
  stops the loop after a checkpoint: on a multi-host deployment this is
  where the UFA QoS controller would evict the hot host and the restore
  path takes over;
- preemption-safe: ``request_preempt()`` (called by the UFA orchestrator's
  on_evict hook) stops the loop at the next step boundary with a final
  checkpoint, and ``maybe_resume()`` restarts from storage.

The reference jits the step and donates the old state; the port runs it
eagerly.  The one host read a step is the loss (``float(...)``), which
is also the step barrier the watchdog times.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint)
from repro_torch.models import LMConfig
from repro_torch.train.train_step import TrainState


@dataclasses.dataclass
class TrainerReport:
    steps_done: int
    final_loss: float
    losses: list
    straggler_steps: list
    preempted: bool
    resumed_from: Optional[int]


class Trainer:
    def __init__(self, cfg: LMConfig, train_step: Callable,
                 checkpoint_dir: str, checkpoint_every: int = 50,
                 straggler_factor: float = 3.0, max_strays: int = 5,
                 mesh=None, shardings=None):
        self.cfg = cfg
        # on a mesh the state is the rank's blocks (laid out by
        # ``shardings``): a save gathers the whole leaves on every rank
        # and rank 0 writes them; the stop decision is every rank's
        self.mesh = mesh
        self.shardings = shardings
        self.train_step = train_step
        self.ckpt = AsyncCheckpointer(checkpoint_dir)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.straggler_factor = straggler_factor
        self.max_strays = max_strays
        self._preempt_requested = False

    def _save(self, step: int, state: TrainState) -> None:
        from repro_torch.checkpoint.checkpoint import whole
        full = whole(state, self.shardings, self.mesh)
        if self.mesh is None or self.mesh.rank == 0:
            self.ckpt.save(step, full)

    def _any(self, flag: bool) -> bool:
        """``flag`` on any rank of the mesh (every rank stops together)."""
        if self.mesh is None or not self.mesh.live or self.mesh.size == 1:
            return flag
        import torch
        import torch.distributed as dist
        t = torch.tensor([int(flag)], device=self.mesh.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def request_preempt(self):
        """UFA eviction hook: stop at the next step boundary."""
        self._preempt_requested = True

    def maybe_resume(self, state: TrainState,
                     device=None) -> tuple[TrainState, int]:
        """The newest checkpoint loaded into ``state``'s structure and
        dtypes on ``device`` (default: the CUDA card), and its step; or
        ``(state, 0)`` when there is none."""
        step = latest_step(self.checkpoint_dir)
        if step is None:
            return state, 0
        state, _ = load_checkpoint(self.checkpoint_dir, state, step=step,
                                   device=device)
        return state, step

    def run(self, state: TrainState, batches: Iterator[Dict],
            n_steps: int, start_step: int = 0) -> tuple[TrainState, TrainerReport]:
        losses = []
        strays = []
        ewma = None
        preempted = False
        done = 0
        for step in range(start_step, start_step + n_steps):
            if self._any(self._preempt_requested):
                preempted = True
                break
            batch = next(batches)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])  # blocks; acts as step barrier
            dt = time.perf_counter() - t0
            losses.append(loss)
            done += 1
            if ewma is None:
                ewma = dt
            else:
                if dt > self.straggler_factor * ewma and done > 3:
                    strays.append((step, dt, ewma))
                ewma = 0.9 * ewma + 0.1 * dt
            if (step + 1) % self.checkpoint_every == 0:
                self._save(step + 1, state)
            if self._any(len(strays) > self.max_strays):
                # persistent straggler: checkpoint and hand off to the
                # restore path
                break
        self._save(start_step + done, state)
        self.ckpt.wait()
        return state, TrainerReport(
            steps_done=done,
            final_loss=losses[-1] if losses else float("nan"),
            losses=losses, straggler_steps=strays,
            preempted=preempted, resumed_from=start_step or None)
