"""Training, prefill and decode steps and the fault-tolerant trainer
(port of ``repro.train``)."""

from repro_torch.train.train_step import (  # noqa: F401
    TrainState,
    chunked_ce_loss,
    make_train_state,
    make_train_state_abstract,
    make_train_step,
    make_prefill_step,
    make_decode_fn,
)
