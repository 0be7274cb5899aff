"""The fault-tolerant training runner (counterpart of
`repro.runtime`)."""
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
