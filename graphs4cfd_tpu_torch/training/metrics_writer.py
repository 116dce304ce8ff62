"""Metric logging (port of ``graphs4cfd_tpu/training/metrics_writer.py``).

Scalars go through ``torch.utils.tensorboard`` when it imports, and always
to a JSONL mirror (``<log_dir>/metrics.jsonl``, one
``{"tag", "value", "step", "time"}`` object a line), so the metrics
survive without tensorboard.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsWriter:
    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self._tb = None
        self._jsonl = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:       # no tensorboard: the JSONL mirror only
                self._tb = None
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": time.time()}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
