"""Checkpoint save/restore (counterpart of `repro.checkpoint`)."""
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         load_checkpoint, place_state,
                                         save_checkpoint)

__all__ = ["AsyncCheckpointer", "latest_step", "load_checkpoint",
           "place_state", "save_checkpoint"]
