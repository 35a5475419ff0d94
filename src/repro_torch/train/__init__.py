"""Training for the LM substrate: optimizers (AdamW, Adafactor), the
train step with microbatching, the loop with checkpoints, and int8
gradient compression (``repro_torch.train.compression``)."""

from repro_torch.train.optimizer import OptConfig, global_norm, init_opt_state, opt_update
from repro_torch.train.train_loop import make_train_step, train_loop

__all__ = [
    "OptConfig", "init_opt_state", "opt_update", "global_norm",
    "make_train_step", "train_loop",
]
