"""Pairs trained over the window, counted in whole steps, per second from
the window's start to the end of its last step (the benchmark's clock)."""


def read(ctx):
    w = ctx.get("window")
    if not w or not w.get("completed") or ctx.get("unit_of_work") != "pairs":
        return None
    return w["completed"] / w["seconds"]
