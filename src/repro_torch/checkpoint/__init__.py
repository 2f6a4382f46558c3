"""Checkpoint and restore (port of ``repro.checkpoint``)."""

from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
