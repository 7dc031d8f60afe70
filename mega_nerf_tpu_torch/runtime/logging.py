"""Experiment metrics: a `metrics.jsonl` file, plus TensorBoard event files
when `torch.utils.tensorboard` imports.

Counterpart of the JAX package's `runtime/logging.py` `MetricsWriter`. Each
`add_scalar` appends one JSON line
`{"t": <unix time>, "step": <iteration>, <key>: <value>}`. In a
multi-process run only rank 0 makes a writer (the runners keep None on every
other rank), and `main_print` (`parallel/distributed.py`) prints on rank 0
only.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsWriter:
    def __init__(self, log_dir):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(log_dir / "metrics.jsonl", "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard package: the JSON lines only
            self._tb = None
        else:
            self._tb = SummaryWriter(str(log_dir))

    def add_scalar(self, key: str, value: float, step: int) -> None:
        self._jsonl.write(
            json.dumps({"t": time.time(), "step": step, key: float(value)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(key, float(value), step)

    def add_image(self, key: str, image_hwc, step: int) -> None:
        if self._tb is not None:
            self._tb.add_image(key, image_hwc, step, dataformats="HWC")

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
