"""Share of its roofline that the sm90 conv kernel (csrc/conv3d_sm90.cu)
reaches over the traced knees: the bound of the segmentation UNet's convs
that it was written for (`roofline.sm90_takes`), counted from the
configuration's tiles, over the device time of the kernels named
conv3d_sm90_kernel. Silent where the kernel did not run, or ran another
number of times than those convs need."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("traced_items"):
        return None
    t = sum(v for k, v in tr["kernels"].items() if "conv3d_sm90_kernel" in k)
    if t <= 0 or tr.get("launches_sm90") != tr.get("expected_sm90"):
        return None
    return 100.0 * tr["sm90_work"]["bound_s"] / t
