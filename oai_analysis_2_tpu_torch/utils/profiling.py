"""Per-stage wall timers (port of `StageTimer`, `oai_analysis_2_tpu/utils/profiling.py:18-48`).

Where the JAX package blocks on device results at a stage end, this timer
synchronizes the card, so a stage's seconds cover its device work and not
only the enqueue.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch

from oai_analysis_2_tpu_torch.core.device import synchronize


class StageTimer:
    """Accumulates wall time per named stage."""

    def __init__(self, device=None):
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {"seconds": round(t, 4), "calls": self.counts[name]}
            for name, t in sorted(self.totals.items())
        }
