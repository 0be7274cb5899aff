"""The train and eval steps (counterpart of `repro.train`)."""
from repro_torch.train.step import (TrainState, build_eval_step,
                                    build_train_step, init_state)

__all__ = ["TrainState", "build_eval_step", "build_train_step",
           "init_state"]
