"""Training metric logging: a jsonlines log.txt per run (port of
cosypose_tpu/training/logs.py)."""

from __future__ import annotations

import json
import pathlib
import time
from collections import defaultdict

import numpy as np


class MetricsAccumulator:
    """Mean-accumulates metric dicts. Values may be tensors on the card: they
    are kept as they are and turned into floats only in means(), since each
    conversion waits for the card."""

    def __init__(self):
        self.buffers = defaultdict(list)

    def add(self, metrics: dict):
        for k, v in metrics.items():
            self.buffers[k].append(v)

    def means(self) -> dict:
        return {k: float(np.mean([float(v) for v in vs])) for k, vs in self.buffers.items()}

    def reset(self):
        self.buffers.clear()


class RunLogger:
    """Appends one JSON line per call to <run_dir>/log.txt: epoch, seconds
    since the logger was made, train/<metric> and any extra keys."""

    def __init__(self, run_dir):
        self.run_dir = pathlib.Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.log_path = self.run_dir / "log.txt"
        self.t0 = time.time()

    def append(self, epoch: int, train_metrics: dict, extra: dict | None = None):
        record = dict(epoch=epoch, time=time.time() - self.t0)
        record.update({f"train/{k}": v for k, v in train_metrics.items()})
        if extra:
            record.update(extra)
        with open(self.log_path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
        return record

    def read(self):
        if not self.log_path.exists():
            return []
        with open(self.log_path) as f:
            return [json.loads(line) for line in f if line.strip()]
