"""Share of its roofline that the sm90n conv kernel (csrc/conv3d_sm90n.cu)
reaches over the traced training steps: the bound of the GradICON stages'
forward convs and data gradients that it was written for
(`roofline.sm90n_takes`), counted from the configuration's shapes, over
the device time of the kernels named conv3d_sm90n_kernel. Silent where the
kernel did not run, or ran another number of times than those convs need."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("traced_items"):
        return None
    t = sum(v for k, v in tr["kernels"].items() if "conv3d_sm90n_kernel" in k)
    if t <= 0 or tr.get("launches_sm90n") != tr.get("expected_sm90n"):
        return None
    return 100.0 * tr["sm90n_work"]["bound_s"] / t
