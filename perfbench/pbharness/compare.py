"""The numbers that decide ``correct``.

A cell's check has one of two modes.  ``logits``: the program's
last-position logits and first tokens against the plain reference run
from the prompts.  ``layers``: the reference follows the program layer
by layer from the program's own hidden states, for a model whose
discrete choices (top-k routing) make two correct computations in
different precisions part ways over the layers; the embedding (the
start) and the final norm and head (the end) are checked by themselves.

For each compared request (a row):

- ``logit_err``: the relative distance ||program - reference||_2 /
  ||reference||_2 of the whole logit vector;
- ``token_gap``: how far the reference's logit of the token the program
  served lies below the reference's best logit, in units of the
  reference logits' standard deviation over the vocabulary (0 when the
  served token is the reference's argmax).

A cell compares the mean and the largest ``logit_err`` and the largest
``token_gap`` of its sample, each against its own limit.
"""

from __future__ import annotations

from typing import Dict

import torch


def numbers(got: torch.Tensor, tokens: torch.Tensor,
            ref: torch.Tensor) -> Dict[str, float]:
    got, ref = got.double(), ref.double()
    err = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
    best = ref.max(dim=-1).values
    served = ref.gather(1, tokens.long().reshape(-1, 1))[:, 0]
    gap = (best - served) / ref.std(dim=-1)
    return {"logit_err_mean": float(err.mean()),
            "logit_err_max": float(err.max()),
            "token_gap_max": float(gap.max())}


def token_update_err(x: torch.Tensor, got: torch.Tensor,
                     ref: torch.Tensor) -> torch.Tensor:
    """Per token, the relative distance between two outputs' updates of
    the residual stream (output - input): ||got - ref|| / ||ref - x||."""
    d_ref = (ref - x).double()
    return (got.double() - ref.double()).norm(dim=-1).flatten() / \
        d_ref.norm(dim=-1).flatten()
