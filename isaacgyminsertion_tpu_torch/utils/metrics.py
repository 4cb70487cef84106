"""Metrics and logging: a windowed scalar average and a metrics sink (the
phase times are `utils.profiling` spans).

Port of `isaacgyminsertion_tpu/utils/metrics.py`. The sink always writes
`metrics.jsonl` (one JSON object per `write`) and adds a tensorboardX writer
only where that package imports. The reference's wandb sink is left out: no
caller names a project.
"""

from __future__ import annotations

import json
import os
from collections import deque


class AverageScalarMeter:
    """Windowed scalar average."""

    def __init__(self, window_size: int = 100):
        self.window_size = window_size
        self.deque: deque = deque(maxlen=window_size)

    def update(self, values):
        try:
            iter(values)
        except TypeError:
            values = [values]
        for v in values:
            self.deque.append(float(v))

    @property
    def current_mean(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)


class MetricsWriter:
    """JSONL metrics sink, with tensorboardX where it imports."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self.tb = None
        else:
            self.tb = SummaryWriter(os.path.join(out_dir, "tb"))

    def write(self, step: int, scalars: dict):
        rec = {"step": int(step)}
        for k, v in scalars.items():
            v = float(v)
            rec[k] = v
            if self.tb is not None:
                self.tb.add_scalar(k, v, step)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
