"""Learning-rate scheduling (port of ``graphs4cfd_tpu/training/schedule.py``).

``ReduceLROnPlateau`` with torch's scheduler semantics as the reference
uses them (``factor``, ``patience``, ``eps=0``, ``threshold=1e-4`` in
'rel' mode), as a small host-side state machine: the lr it gives is
handed to the training step each epoch.
"""
from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(self, lr: float, factor: float, patience: int,
                 threshold: float = 1e-4, eps: float = 0.0):
        self.lr = float(lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.eps = eps
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = self.lr * self.factor
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs,
                "factor": self.factor, "patience": self.patience,
                "threshold": self.threshold, "eps": self.eps}

    def load_state_dict(self, state: dict):
        self.__dict__.update(state)
