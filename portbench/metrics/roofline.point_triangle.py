"""Share of its roofline that the distance kernel (csrc/point_triangle.cu)
reaches over the traced knees: 85 f32 operations a point-triangle pair of
the four distance calls a knee needs (each tissue's inner points to its
outer surface and back, from the meshes' sizes), over the device time of
the kernels named point_triangle_min_d2_fma_kernel. Silent where the
kernel did not run or ran another number of times."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("traced_items"):
        return None
    t = sum(v for k, v in tr["kernels"].items() if "point_triangle_min_d2_fma_kernel" in k)
    if t <= 0 or tr.get("launches_dist") != tr.get("expected_dist"):
        return None
    return 100.0 * tr["dist_work"]["bound_s"] / t
