"""Small utilities: transform composition, dataset splits, profiling."""
from .data import Compose, ConcatDataset, Subset, random_split
from .profiling import EdgeRateMeter, Timer, trace_annotation

__all__ = ["Compose", "Subset", "ConcatDataset", "random_split",
           "trace_annotation", "Timer", "EdgeRateMeter"]
