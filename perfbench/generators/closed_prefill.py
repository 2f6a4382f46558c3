"""A closed loop of prefill requests from one client.

The client sends a batch of ``batch`` prompts together and waits for
every first token before it sends the next batch: a prefill replica
feeding a decode pool, or a bulk job scoring documents, sees prompts so.
Prompt ids are drawn uniformly over the configuration's vocabulary, on
the device, from the run's seed and the batch's index.

Prompt lengths, one a batch (every prompt of a batch has its length):

- ``"seq_len": n``: every batch n tokens;
- ``"lengths": {"median", "sigma", "min", "max", "count", "multiple"}``:
  a fixed set of ``count`` lengths, the lognormal's quantiles at
  (i + 1/2) / count, rounded up to ``multiple`` and clipped to
  [min, max].  The set does not depend on the seed; the seed orders it,
  and the window cycles through it, so every seed does the same work.

``warmup_steps`` batches, at least one of each length and at least as
many as the harness asks for, run in set-up; ``trace_steps`` of the window's batches are profiled in a
traced run.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from pbharness import traffic


def lengths(mix: dict) -> List[int]:
    if "seq_len" in mix:
        return [int(mix["seq_len"])]
    spec = mix["lengths"]
    n, mult = int(spec["count"]), int(spec.get("multiple", 1))
    normal = statistics.NormalDist()
    out = []
    for i in range(n):
        x = spec["median"] * math.exp(spec["sigma"]
                                      * normal.inv_cdf((i + 0.5) / n))
        x = -(-math.ceil(x) // mult) * mult
        out.append(int(min(spec["max"], max(spec["min"], x))))
    return out


class ClosedPrefill:
    def __init__(self, mix: dict, seed: int, vocab: int, device):
        self.batch = int(mix["batch"])
        self.lengths = lengths(mix)
        rng = np.random.default_rng([int(seed) & (2 ** 128 - 1), 0x1E6])
        self.order = rng.permutation(len(self.lengths)).tolist()
        self.warmup_steps = int(mix.get("warmup_steps", 2))
        self.trace_steps = int(mix.get("trace_steps", 4))
        self.seed, self.vocab, self.device = seed, vocab, device

    def shape(self, index: int):
        return (self.batch,
                self.lengths[self.order[index % len(self.lengths)]])

    def prompts(self, index: int,
                stream: int = traffic.WINDOW_STREAM) -> torch.Tensor:
        """Batch ``index``'s prompt ids, (batch, its length) int64."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(traffic.seed_for(self.seed, stream, index))
        return torch.randint(0, self.vocab, self.shape(index),
                             generator=gen, device=self.device)

    def warmup(self, at_least: int = 0) -> List[torch.Tensor]:
        n = max(self.warmup_steps, len(self.lengths), at_least)
        return [self.prompts(i, traffic.WARMUP_STREAM) for i in range(n)]

    def run(self, step: Callable, seconds: float, min_steps: int = 1,
            before: Optional[Callable] = None,
            after: Optional[Callable] = None) -> List[dict]:
        """Send batches until ``seconds`` have passed since the first
        dispatch and at least ``min_steps`` batches are done; the window
        ends at the last batch's first tokens."""
        records = []
        t_start = None
        i = 0
        while True:
            if before is not None:
                before(i)
            ids = self.prompts(i)
            t_dispatch = time.perf_counter()
            if t_start is None:
                t_start = t_dispatch
            tokens, out = step(ids)
            t_first = time.perf_counter()
            records.append(dict(index=i, shape=tuple(ids.shape),
                                t_dispatch=t_dispatch, t_first=t_first,
                                requests=ids.shape[0],
                                prompt_tokens=ids.numel(),
                                tokens=tokens, out=out))
            if after is not None:
                after(i)
            i += 1
            if t_first - t_start >= seconds and i >= min_steps:
                return records


def make(mix: dict, seed: int, vocab: int, device) -> ClosedPrefill:
    return ClosedPrefill(mix, seed, vocab, device)
