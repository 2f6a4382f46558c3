"""Deterministic synthetic-token data (port of ``repro.data``)."""

from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLMDataset,
    make_train_iterator,
)
