"""Optimizers and LR schedules for the port's training path."""
from repro_torch.optim.optimizers import (Optimizer, adamw, get_optimizer,
                                          sgd_momentum)
from repro_torch.optim.schedule import (constant, poly_decay, step_decay,
                                        warmup_cosine)

__all__ = ["Optimizer", "adamw", "get_optimizer", "sgd_momentum",
           "constant", "poly_decay", "step_decay", "warmup_cosine"]
