"""Training recorder; counterpart of ``nerf_tpu/train/recorder.py``.

20-window median/avg smoothing of each scalar, tensorboardX scalars under
train/ and val/ (only where tensorboardX imports), and a state_dict for
resuming.
"""
from __future__ import annotations

import os
from collections import defaultdict, deque
from typing import Dict


class SmoothedValue:
    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        v = float(value)
        self.deque.append(v)
        self.total += v
        self.count += 1

    @property
    def median(self) -> float:
        vals = sorted(self.deque)
        n = len(vals)
        if n == 0:
            return 0.0
        mid = n // 2
        return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(1, len(self.deque))

    @property
    def global_avg(self) -> float:
        return self.total / max(1, self.count)


class Recorder:
    def __init__(self, record_dir: str = "", enabled: bool = True, use_tb: bool = True):
        self.enabled = enabled
        self.step = 0
        self.epoch = 0
        self.scalars: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.writer = None
        if enabled and use_tb and record_dir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                os.makedirs(record_dir, exist_ok=True)
                self.writer = SummaryWriter(log_dir=record_dir)

    def update(self, stats: Dict[str, float]):
        if not self.enabled:
            return
        for k, v in stats.items():
            self.scalars[k].update(float(v))

    def record(self, prefix: str = "train", step: int = None, stats: Dict = None):
        if not self.enabled:
            return
        step = self.step if step is None else step
        if self.writer is not None:
            items = stats.items() if stats else (
                (k, sv.median) for k, sv in self.scalars.items()
            )
            for k, v in items:
                self.writer.add_scalar(f"{prefix}/{k}", float(v), step)

    def log_line(self, extra: Dict[str, float] = None) -> str:
        parts = [f"step {self.step}", f"epoch {self.epoch}"]
        for k, sv in self.scalars.items():
            parts.append(f"{k}: {sv.median:.4f}")
        for k, v in (extra or {}).items():
            parts.append(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
        return "  ".join(parts)

    def state_dict(self) -> Dict:
        return {"step": self.step, "epoch": self.epoch}

    def load_state_dict(self, sd: Dict):
        self.step = int(sd.get("step", 0))
        self.epoch = int(sd.get("epoch", 0))

    def close(self):
        if self.writer is not None:
            self.writer.close()
