"""What the example drivers share: the ``--device`` flag, the device's
label in printed lines, the observability plane behind ``--trace`` /
``--metrics-out``, and weights drawn on the host."""

from __future__ import annotations

import argparse
import os
from contextlib import nullcontext

import torch

from repro_torch import obs
from repro_torch.models import init_params
from repro_torch.obs import export
from repro_torch.obs.profiler import Profiler
from repro_torch.optim.adamw import _tree_map
from repro_torch.train import TrainState


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the driver runs: cuda (the default; raises "
                         "without a card) or cpu")


def device_label(dev: torch.device) -> str:
    """The device a line ran on, where the reference prints "CPU"."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "CPU"


class ObsPlane:
    """``--trace`` / ``--metrics-out``: the metrics registry on, a tracer
    when a trace is asked for, and a profiler timing the driver's phases
    (a no-op context when neither flag is given).  With ``write`` False
    (a rank other than 0) nothing is written or printed."""

    def __init__(self, trace, metrics_out, write: bool = True):
        self.trace, self.metrics_out = trace, metrics_out
        self.write = write
        self.tracer, self.prof = None, None
        if trace or metrics_out:
            obs.enable()
            if trace:
                self.tracer = obs.Tracer()
                obs.set_tracer(self.tracer)
            self.prof = Profiler(self.tracer)

    @property
    def on(self) -> bool:
        return self.prof is not None

    def phase(self, name: str):
        return self.prof.phase(name) if self.prof is not None \
            else nullcontext()

    def finish(self, meta: dict) -> None:
        """Writes the trace and the Prometheus + JSONL snapshots, prints
        where, and turns the plane off."""
        if not self.on:
            return
        if self.trace and self.write:
            self.tracer.save(self.trace)
            print(f"\nwrote {self.trace} ({len(self.tracer)} events; load in "
                  f"https://ui.perfetto.dev)")
        if self.metrics_out and self.write:
            export.write_prometheus(self.metrics_out)
            jsonl = os.path.splitext(self.metrics_out)[0] + ".jsonl"
            export.write_jsonl(jsonl, meta=meta)
            print(f"wrote {self.metrics_out} + {jsonl}")
        obs.set_tracer(None)
        obs.disable()


def init_weights(cfg, seed: int, dev: torch.device):
    """``init_params(cfg, seed)`` drawn on the CPU and moved to ``dev``:
    a run on the card holds the very weights of a ``--device cpu`` run
    (a generator on the card draws other numbers), so the two runs'
    weight-dependent lines (the losses) can be held to each other."""
    return _tree_map(lambda t: t.to(dev), init_params(cfg, seed,
                                                     device="cpu"))


def train_state(cfg, seed: int, opt, dev: torch.device):
    """``make_train_state(cfg, seed, opt)`` on ``dev`` from the weights
    ``init_weights`` draws."""
    params = init_weights(cfg, seed, dev)
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32, device=dev))
