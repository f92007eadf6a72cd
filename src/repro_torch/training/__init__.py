"""Training substrate: optimizer, train step, data, checkpointing."""
from .optimizer import AdamW, AdamWState, global_norm
from .train_step import TrainState, make_train_state, make_train_step
from .data import input_specs, stream, synthetic_batch
from . import checkpoint

__all__ = ["AdamW", "AdamWState", "global_norm", "TrainState",
           "make_train_state", "make_train_step", "input_specs", "stream", "synthetic_batch",
           "checkpoint"]
