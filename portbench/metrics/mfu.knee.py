"""The whole knee's share of the card's peak over the traced knees: the
time the model's convs and products need at peak (the segmentation UNet's
in bf16 at 989 TFLOP/s, its f32 upconvs and head and the GradICON
network's both directions in f32 at 67 TFLOP/s), over the traced window's
seconds."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("traced_items") or tr.get("window_s", 0) <= 0:
        return None
    return 100.0 * tr["model_work"]["bound_s"] / tr["window_s"]
