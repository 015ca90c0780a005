"""Metrics logging: counterpart of ``ocpg_tpu/utils/logging.py``.

Console meters (the reference's SmoothedValue and MetricLogger), the JSONL
``log.txt`` of per-epoch stats, and TensorBoard scalars.  One process
trains on one GPU, so no meter is synchronised across ranks.
"""

from __future__ import annotations

import collections
import json
from pathlib import Path
from typing import Dict, Optional


class SmoothedValue:
    def __init__(self, window: int = 20):
        self.deque = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(value)
        self.total += value
        self.count += 1

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricMeter:
    def __init__(self, window: int = 20):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            lambda: SmoothedValue(window))

    def update(self, values: Dict[str, float]):
        for k, v in values.items():
            self.meters[k].update(float(v))

    def averages(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def __str__(self) -> str:
        return " ".join(f"{k}={m.avg:.4f}" for k, m in self.meters.items())


class JSONLLogger:
    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, record: Dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


class TensorBoardLogger:
    """TensorBoard scalars through ``torch.utils.tensorboard``; does nothing
    when ``logdir`` is None or the ``tensorboard`` package is not installed
    (as the JAX package's does without tensorflow)."""

    def __init__(self, logdir: Optional[str]):
        self.writer = None
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self.writer = SummaryWriter(str(logdir))

    def scalars(self, step: int, values: Dict[str, float]):
        if self.writer is None:
            return
        for k, v in values.items():
            self.writer.add_scalar(k, float(v), global_step=step)
        self.writer.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()
