"""Traffic: the generator a mix names, and the seeds its prompts come from.

A traffic file (``traffic/<mix>.json``) names its generator
(``generators/<generator>.py``) and gives its parameters.  A generator
file has ``make(mix, seed, vocab, device)``, which returns an object
with:

- ``prompts(index, stream)``: batch ``index``'s prompt ids (B, S), drawn
  from the run's seed, the stream and the index, so the same seed gives
  the same prompts and the check can draw them again;
- ``warmup(at_least)``: the batches set-up runs, every shape the window
  will use among them, and at least ``at_least``;
- ``run(step, seconds, min_steps, before, after)``: the measured window,
  a list of records, one a batch, each with its ``index``, ``shape``,
  ``t_dispatch``, ``t_first``, ``requests``, ``prompt_tokens``, the first
  ``tokens`` and what ``step`` returned (``out``);
- ``trace_steps``: how many of the window's batches a traced run
  profiles.
"""

from __future__ import annotations

import numpy as np

from pbharness import files

WINDOW_STREAM = 0
WARMUP_STREAM = 1  # prompts of set-up's batches come from their own stream


def seed_for(seed: int, stream: int, index: int) -> int:
    """A 64-bit generator seed for one batch of one stream of a run."""
    state = np.random.SeedSequence([int(seed) & (2 ** 128 - 1), stream,
                                    index]).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1]) << 32)


def load(mix: dict, seed: int, vocab: int, device):
    """The generator ``mix`` names, made for this run."""
    return files.load_module("generators", mix["generator"]).make(
        mix, seed, vocab, device)
