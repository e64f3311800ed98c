"""Share of the traced window in which no kernel, copy or set ran on the
card (the profiler's device activities, their intervals merged)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr.get("window_s", 0) <= 0 or not tr.get("n_device_events"):
        return None
    return 100.0 * max(0.0, tr["window_s"] - tr["busy_s"]) / tr["window_s"]
