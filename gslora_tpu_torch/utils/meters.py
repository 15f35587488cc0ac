"""Running meters (port of gslora_tpu/utils/meters.py; reference
util/utils.py:316-332 AverageMeter)."""
from __future__ import annotations


class AverageMeter:
    """Tracks current value / running average, reset per display window."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
