"""90th percentile (nearest rank) of the seconds each knee of the window
took, on the benchmark's clock around `KneePipeline.run`, over the knees
that ran outside the profiler (it slows the host)."""

import math


def read(ctx):
    xs = sorted(ctx.get("knee_seconds") or [])
    if not xs:
        return None
    return xs[max(0, math.ceil(0.9 * len(xs)) - 1)]
