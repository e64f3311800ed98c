"""Knees completed over the window, from its start to the last completion,
per hour (the benchmark's clock)."""


def read(ctx):
    w = ctx.get("window")
    if not w or not w.get("completed") or ctx.get("unit_of_work") != "knees":
        return None
    return 3600.0 * w["completed"] / w["seconds"]
