"""Deterministic synthetic-token data pipeline (port of
``repro/data/pipeline.py``).

Markov-chain token streams (stable bigram structure so small models show a
real, decreasing loss) generated on the fly from a counter-based PRNG:
batch N is a pure function of (seed, N), so any worker/restart resumes
exactly — the property UFA's preempt-and-restore path (BBM) relies on: a
training job revived in burst capacity continues from (checkpoint step + 1)
with bit-identical data order.  The draws are numpy's, as in the
reference, so every batch is bit-identical to the reference's.  Under a
mesh every rank reads the same global batch and the train step keeps its
block over the data axes (``dist.sharding.train_batch_shardings``), where
the reference's iterator places the batch with its shardings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_clusters: int = 16      # latent "topics" giving learnable structure

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V, C = self.vocab_size, self.n_clusters
        # each cluster prefers a band of tokens; transitions are sticky
        self.cluster_of = rng.integers(0, C, size=V)
        self.trans = rng.dirichlet(np.ones(C) * 0.3, size=C)
        self.band = [np.flatnonzero(self.cluster_of == c) for c in range(C)]
        for c in range(C):
            if len(self.band[c]) == 0:
                self.band[c] = np.array([c % V])

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        """Batch `index`, deterministically (counter-based): int32
        ``inputs`` and ``labels`` of shape (global_batch, seq_len)."""
        rng = np.random.default_rng((self.seed << 20) ^ index)
        B, S, C = self.global_batch, self.seq_len, self.n_clusters
        clusters = np.empty((B, S), np.int64)
        clusters[:, 0] = rng.integers(0, C, size=B)
        u = rng.random((B, S))
        cum = np.cumsum(self.trans, axis=1)
        for t in range(1, S):
            clusters[:, t] = (u[:, t, None] <
                              cum[clusters[:, t - 1]]).argmax(axis=1)
        pick = rng.integers(0, 1 << 30, size=(B, S))
        tokens = np.empty((B, S), np.int32)
        for c in range(C):
            m = clusters == c
            tokens[m] = self.band[c][pick[m] % len(self.band[c])]
        inputs = tokens[:, :-1] if S > 1 else tokens
        # pad back to S with a wrap token so shapes stay (B, S)
        inputs = np.concatenate([tokens[:, :1], inputs], axis=1)[:, :S]
        labels = tokens
        return {"inputs": inputs.astype(np.int32),
                "labels": labels.astype(np.int32)}


def make_train_iterator(ds: SyntheticLMDataset, start_step: int = 0,
                        device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Resumable iterator: step N always yields the same batch, as int32
    tensors on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    step = start_step
    while True:
        yield {k: torch.from_numpy(v).to(dev)
               for k, v in ds.batch(step).items()}
        step += 1
