"""The training step's share of the card's peak over the traced steps: the
time the forward and backward passes' convs and products need at peak
(3x3x3 convs, their data and weight gradients in bf16 at 989 TFLOP/s; the
f32 upconvs and heads and their gradients at 67 TFLOP/s), over the traced
window's seconds."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("traced_items") or tr.get("window_s", 0) <= 0:
        return None
    return 100.0 * tr["model_work"]["bound_s"] / tr["window_s"]
