"""Crash-safe checkpoints of the training state (``ckpt.py``)."""
from repro_torch.checkpoint.ckpt import (latest_step, load_meta,
                                        restore_checkpoint,
                                        restore_for_resume, save_checkpoint)

__all__ = ["latest_step", "load_meta", "restore_checkpoint",
           "restore_for_resume", "save_checkpoint"]
