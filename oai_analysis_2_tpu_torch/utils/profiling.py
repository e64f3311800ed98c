"""Per-stage wall timers, the process-wide timer and a profiler trace (port
of `StageTimer`, `GLOBAL_TIMER` and `trace`,
`oai_analysis_2_tpu/utils/profiling.py:18-67`).

Where the JAX package blocks on device results at a stage end, this timer
synchronizes the card, so a stage's seconds cover its device work and not
only the enqueue.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

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

    def print_report(self) -> None:
        print(json.dumps(self.report(), indent=1))


GLOBAL_TIMER = StageTimer()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Trace a code region with torch.profiler (host, and the card when one
    is present) and write it to `log_dir` as a Chrome trace JSON; with no
    `log_dir`, do nothing."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))
