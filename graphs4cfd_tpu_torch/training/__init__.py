"""Rollout, the training step, and checkpoint reading."""
from .checkpoint import load_checkpoint
from .rollout import solve
from .trainer import (AdamState, adam_init, adam_state_from_jax,
                      adam_update_, make_train_step, make_val_step)

__all__ = ["load_checkpoint", "solve", "AdamState", "adam_init",
           "adam_state_from_jax", "adam_update_", "make_train_step",
           "make_val_step"]
