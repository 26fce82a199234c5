"""Metric writer (counterpart of ``nf_tpu/train/metrics.py``):
``metrics.jsonl`` always, one ``{"t", "step", "tag", "value"}`` record a
line, appended; TensorBoard event files too when
``torch.utils.tensorboard`` imports, where ``image`` writes the report's
panels (nothing otherwise, as in nf_tpu).  Rank 0 writes; the other ranks
do nothing.
"""
from __future__ import annotations

import json
import os
import time

from ..parallel.distributed import is_host0


class MetricWriter:
    def __init__(self, run_dir: str, use_tensorboard: bool = True):
        self.run_dir = run_dir
        self.is_host0 = is_host0()
        self._jsonl = None
        self._tb = None
        if not self.is_host0:
            return
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(run_dir)
            except Exception:
                self._tb = None

    def scalar(self, tag: str, value: float, step: int):
        if not self.is_host0:
            return
        rec = {"t": time.time(), "step": step, "tag": tag, "value": float(value)}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def image(self, tag: str, hwc_uint8, step: int):
        if not self.is_host0:
            return
        if self._tb is not None:
            self._tb.add_image(tag, hwc_uint8, step, dataformats="HWC")

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
