"""Small utilities: transform composition and dataset splits."""
from .data import Compose, ConcatDataset, Subset, random_split

__all__ = ["Compose", "Subset", "ConcatDataset", "random_split"]
