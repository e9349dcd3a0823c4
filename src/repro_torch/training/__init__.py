"""Port of ``src/repro/training``: AdamW, the train step and the
checkpointed train loop, on one device."""

from .optimizer import OptConfig, make_train_step, opt_init, opt_update
from .train_loop import TrainLoopConfig, train

__all__ = ["OptConfig", "TrainLoopConfig", "make_train_step", "opt_init",
           "opt_update", "train"]
