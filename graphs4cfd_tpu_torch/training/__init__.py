"""Rollout and checkpoint reading."""
from .checkpoint import load_checkpoint
from .rollout import solve

__all__ = ["load_checkpoint", "solve"]
