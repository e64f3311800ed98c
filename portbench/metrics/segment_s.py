"""Mean seconds of the pipeline's segment stage a knee over the window's knees
that ran outside the profiler (it slows the host), from
`KneeResult.timings` (the program's stage timer, the card synchronized at
the stage's end)."""


def read(ctx):
    xs = (ctx.get("stages") or {}).get("segment")
    return sum(xs) / len(xs) if xs else None
