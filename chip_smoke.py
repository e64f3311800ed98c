"""Drive the PyTorch/CUDA port (`oai_analysis_2_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each fatal on failure (exit code 1, no result line):

1. build: compile the hand-written kernels in `oai_analysis_2_tpu_torch/csrc/`
   (one nvcc per source, all started together) and print the card's name
   and power limit as nvidia-smi gives them;
2. kernels: hold each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it, and time the kernel, the plain version
   and (where one exists) one PyTorch library call computing the same
   function, with CUDA events. The conv has three routes
   (`cuda_conv.conv3d_route`): the TMA + wgmma kernel `sm90` at the segment
   UNet's three full-resolution shapes and one shape per lower level, the
   mma.sync kernel `cin1` at enc0a (Cin = 1), the f32 kernel at each of the
   ten convs of the finest GradICON stage (from the stage spec, at their
   grid sizes). A bf16 conv is checked with f32 output and with the bf16
   output the main path takes (each its own build of the kernel); enc0b
   (sm90) and enc0a (cin1) are checked once more on the batch-norm UNet's
   route, without ReLU and with f32 output (rows named `...:bn`). At each
   sm90 and cin1 shape it also times the wmma build (which ran those convs
   before) and the sm90 kernel's loads-only or the cin1 kernel's
   stores-only and general-path builds; at each f32 shape and at the
   distance shape, the build that the kernel replaced (`was_ms`, uncounted
   launches);
3. small knee: the whole pipeline on a 48x96x96 knee on the card and on the
   CPU (plain versions), compared;
4. full knee: `KneePipeline.run` on a 160x384x384 knee against the bench
   fixture's shell atlas, with the offline configuration's production
   `UNet` (threshold weights, bf16) and the shipped width-24 GradICON in
   network mode. The knee runs twice; the launch counts are zeroed just
   before the second run and read just after it, and that run is reported:
   the sm90 route must have taken 13 bf16 conv launches per cin1 (enc0a)
   launch, and the wmma build none. Then the thickness stage runs once
   more, timed per substage, and the knee once more under torch.profiler
   (the device's busy share and its milliseconds by kernel), which must
   show the enc0a, f32 conv and distance time in their kernels and none in
   the builds those replaced.

5. instance small: `register_pair_instance` (scales 2 and 1, 20 Adam steps
   each, lr 0.3) on the small knee and its atlas pooled to 24x48x48, on the
   card and on the CPU, in both GradICON gradient modes: the final
   objective, the inverse-consistency error, the fold fractions and the
   maps are compared within the tolerances stated at `INSTANCE_SMALL_TOL`;
6. accurate knee: `KneePipeline.run` with atlas thickness maps on the full
   knee in two configurations, (a) the CLI default, network + 20
   fine-tuning steps, and (b) instance optimization (80, 60, 40 steps at
   scales 4, 2, 1 on the 48x96x96 grid). The atlas mapper is built first
   (it segments the atlas once), its launches counted apart; each knee
   then runs twice and the second run is reported: stage seconds with
   register and atlas_map, peak memory, launches (f32 conv 60 in (a), 0 in
   (b)), registration quality, raster coverage and mean mapped thickness.
   Non-finite or empty maps, zero coverage, an FC median outside 0.2-10 mm
   or an f32 conv launch in (b) are fatal;
7. instance steps: milliseconds per Adam step at each of the three scales
   (each gradient mode at scale 1), and one step at scale 1 (48x96x96)
   under torch.profiler: device milliseconds by kernel name, device events
   per step and the device's busy share;
8. release layout: (a) a release-shaped tree under the git-ignored
   `build/release_smoke/` with `OAI_TPU_DATA_DIR` pointing at it: the
   production `UNet`'s threshold weights as the reference's torch
   checkpoint (`ec*` / `dc*` names, written by `reference_state_dict`, the
   exact inverse of the port's converter), its training config, phase 4's
   atlas and the segmenter's probability maps of it, and the knee, all
   written as NIfTI by the port; (b) the CLI's `pipeline` command
   (`oai_analysis_2_tpu_torch.__main__.main`) on the knee file, in this
   process, twice: the second run's read, stage and write seconds, 65
   sm90 + 5 cin1 + 60 f32 conv and 4 distance launches, and the four VTK
   files read back within 0.5 % in size and 1 % in mean thickness of phase
   6 (a); (c) `KneePipeline.run_path` with the atlas maps read from NIfTI
   (the mapper launches no conv), its thickness_2d file, raster coverage
   within 0.005 and mean mapped thickness within 1 % of phase 6 (a); (d)
   the segment stage of the knee with an identity batch-norm variant of
   the checkpoint (the BN route), within 1e-3 of the fused route's maps,
   and each route's segment once under torch.profiler.

Before the last line it prints one JSON object `{"kernels": [...]}` (per
kernel and conv route: launches on the reported run, max error against the
plain version, kernel / plain / library milliseconds and the bound; sm90,
cin1, f32 and distance rows add the replaced build's milliseconds, sm90
rows the loads-only build's, the cin1 row the stores-only build's; the
`:bn` rows count the launches of phase 8 (d)), then the card line.
The last line is `{"ok": true, "device": {...}}`. Without a CUDA card it
exits with code 1 and prints no result. It imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# the least f32 operations per point-triangle pair that the distance
# kernel's inner loop needs (csrc/point_triangle.cu), an FMA counted as 2,
# every other add, multiply, min or compare as 1: q = a - p 3; plane
# t = q.n 5 and t * t / n.n 2; triple products d2 = q.m2, d3 = q.m3 5 each
# and d1 = n.n - d2 - d3 2; inside = min(d1, d2, d3) >= 0 3; edge ab: u.w
# 5, the saturated t 1, r = u + t w 6, r.r 5 (17); edges bc and ca 3 more
# each for u (20, 20); the nearest edge 2; the running minimum 1 (the
# choice of plane or edge costs no instruction: the compiler predicates
# the minimum). Total 85, as `tools/port_kernel_report.py` counts in the
# built loop (27 FFMA, 11 FADD, 11 FMUL, 3 FMUL.SAT, 5 FMNMX, 1 FSETP a
# pair); the build it replaced needed 154, without FMA.
DIST_OPS_PER_PAIR = 85

SLAB = (1, 48, 416, 416)  # one auto z-slab of the 160x384x384 knee
# (name, x shape without channels, Cin, Cout) of segment-UNet convs on one
# slab: the three full-resolution ones on the sm90 route, one per lower
# level, and enc0a (Cin = 1) on the cin1 route
SEG_CONVS = [
    ("enc0b", SLAB, 32, 64), ("dec2a", SLAB, 192, 64), ("dec2b", SLAB, 64, 64),
    ("enc1b", (1, 24, 208, 208), 128, 128), ("dec0a", (1, 12, 104, 104), 768, 256),
    ("enc3b", (1, 6, 52, 52), 512, 512), ("enc0a", SLAB, 1, 32),
]
REG_GRID = (48, 96, 96)  # the registration grid; the finest stage (scale 1) runs on it
REG_WIDTH = 24  # the shipped GradICON's stage width (oai_analysis_2_tpu/weights/gradicon.npz)
DIST_SHAPE = (32_500, 65_000)  # points x triangles, production mesh sizes
CONV_SOURCES = {"sm90": "oai_analysis_2_tpu_torch/csrc/conv3d_sm90.cu",
                "cin1": "oai_analysis_2_tpu_torch/csrc/conv3d_cin1.cu",
                "wmma": "oai_analysis_2_tpu_torch/csrc/conv3d.cu",
                "f32": "oai_analysis_2_tpu_torch/csrc/conv3d_f32.cu"}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call of `fn` on the card: one warm-up call, then
    `reps` calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clock_under_load(torch, fn, reps: int) -> dict:
    """The SM clock (MHz) and power draw (W) that nvidia-smi samples every
    50 ms while `fn` runs `reps` times back to back: medians over the
    samples; None where nvidia-smi gives none. The sampler is stopped
    before this returns."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    samples = []
    for line in out.splitlines():
        try:
            samples.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    samples = [v for v in samples if len(v) == 2]
    if not samples:
        return {"sm_clock_mhz": None, "power_w": None}
    return {"sm_clock_mhz": float(np.median([v[0] for v in samples])),
            "power_w": float(np.median([v[1] for v in samples]))}


def check_close(name, got, want, atol, rtol) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol |want|
    everywhere."""
    diff = (got.float() - want.float()).abs()
    bad = diff > atol + rtol * want.float().abs()
    err = float(diff.max())
    if not bool(want.isfinite().all()) or not bool(got.isfinite().all()) or bool(bad.any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max abs err {err}, "
                             f"{int(bad.sum())} elements beyond atol {atol} rtol {rtol})")
    return err


def reset_launches(cuda_conv, cuda_kernels):
    cuda_conv.reset_launches()
    cuda_kernels.point_triangle_min_d2.launches = 0


def read_launches(cuda_conv, cuda_kernels) -> dict:
    return {
        "conv3d_sm90": cuda_conv.conv3d.launches_sm90,
        "conv3d_cin1": cuda_conv.conv3d.launches_cin1,
        "conv3d_wmma": cuda_conv.conv3d.launches_wmma,
        "conv3d_f32": cuda_conv.conv3d.launches_f32,
        "point_triangle": cuda_kernels.point_triangle_min_d2.launches,
    }


def check_bf16_routes(launches, what):
    """Each UNet forward runs 14 bf16 convs, enc0a's alone on the cin1
    route; no conv of the production UNet reaches the wmma build."""
    if launches["conv3d_sm90"] != 13 * launches["conv3d_cin1"] or launches["conv3d_wmma"] != 0:
        raise AssertionError(f"{what}: sm90 route took {launches['conv3d_sm90']} bf16 conv launches, want 13 per "
                             f"enc0a launch ({launches['conv3d_cin1']}); wmma took {launches['conv3d_wmma']}, want 0")


def gradicon_convs(width=REG_WIDTH, grid=REG_GRID):
    """(name, x shape without channels, Cin, Cout) of every 3x3x3 conv of the
    finest GradICON stage, from the port's stage spec: a conv of encoder
    level l, or of the decoder level whose skip comes from l, runs on the
    grid halved l times (maxpool floors odd sizes)."""
    from oai_analysis_2_tpu_torch.models.gradicon import _stage_spec
    from oai_analysis_2_tpu_torch.models.unet3d import param_shapes

    spec = _stage_spec(width)
    convs = []
    for name, leaves in param_shapes(spec).items():
        kshape = leaves["kernel"]
        if kshape[:3] != (3, 3, 3):
            continue
        li = int(name[3])
        level = li if name.startswith("enc") else len(spec.enc) - 2 - li
        convs.append((f"stage2.{name}", (1,) + tuple(g >> level for g in grid), kshape[3], kshape[4]))
    return convs


def conv_case(torch, F, cuda_conv, name, shape, cin, cout, dtype, tol, reps, clock=False, bn=False):
    """One conv shape: kernel vs plain version, times and bound. `bn`: the
    batch-norm UNet's route (no ReLU, f32 output: BN runs after the conv)."""
    route = cuda_conv.conv3d_route(cin, cout, dtype)
    relu = not bn
    out_dtype = torch.float32 if bn else dtype  # the output type the path takes
    gen = torch.Generator(device="cuda").manual_seed(len(name) * 1000 + cin)
    x = torch.randn(shape + (cin,), device="cuda", generator=gen).to(dtype)
    k = (torch.randn((3, 3, 3, cin, cout), device="cuda", generator=gen) / (27 * cin) ** 0.5).to(dtype)
    b = torch.randn((cout,), device="cuda", generator=gen) * 0.1
    want = cuda_conv.conv3d_reference(x, k, b, relu=relu, out_dtype=torch.float32)
    # f32 output: the kernel's f32 accumulator and epilogue, held at 1e-4
    # where K is short (cin1: 27 products) or the operands are f32
    f32_tol = 1e-4 if route in ("cin1", "f32") else tol
    got = cuda_conv.conv3d(x, k, b, relu=relu, out_dtype=torch.float32)
    err = err_f32 = check_close(f"conv3d {name} (f32 out)", got, want, f32_tol, f32_tol)
    del got
    if out_dtype != torch.float32:
        # the output type the main path takes, another build of the kernel:
        # one cast of the f32 result, so within a bf16 rounding of the plain one
        got = cuda_conv.conv3d(x, k, b, relu=relu, out_dtype=dtype)
        err = check_close(f"conv3d {name}", got, want, tol, tol)
        del got
    del want
    ms = time_ms(torch, lambda: cuda_conv.conv3d(x, k, b, relu=relu, out_dtype=out_dtype), reps)
    plain_ms = time_ms(torch, lambda: cuda_conv.conv3d_reference(x, k, b, relu=relu, out_dtype=out_dtype), 1)
    # yardstick: one cuDNN call on the channels-last view of the same data
    # (bias fused, ReLU not); never called by the port
    x_cl = x.permute(0, 4, 1, 2, 3)
    w_cl = k.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    b_lib = b.to(dtype)
    library_ms = time_ms(torch, lambda: F.conv3d(x_cl, w_cl, b_lib, padding=1), reps)
    voxels = int(np.prod(shape))
    esize = x.element_size()
    flops = 2.0 * 27 * cin * cout * voxels
    out_size = torch.finfo(out_dtype).bits // 8
    nbytes = voxels * cin * esize + 27 * cin * cout * esize + cout * 4 + voxels * cout * out_size
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    bound_ops, bound_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    extra = {}  # other builds are timed at the ReLU route's rows only
    if route == "f32":
        # uncounted launches: the f32 build that this route replaced, and the
        # kernel's multiplies alone (no copies; the output is garbage)
        extra = {
            "was_ms": time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="f32_was", relu=True,
                                                               out_dtype=dtype), reps),
            "compute_ms": time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="f32", relu=True,
                                                                   out_dtype=dtype, compute_only=True), reps),
        }
        if clock:
            extra.update(clock_under_load(torch, lambda: cuda_conv.conv3d(x, k, b, relu=True, out_dtype=dtype),
                                          int(1500 / ms) + 1))
    if route == "sm90" and not bn:
        # uncounted launches of other builds at the same shape: the wmma
        # kernel, which ran every bf16 conv before the sm90 route, and the
        # sm90 kernel's load pipeline alone (no wgmma, no stores)
        extra = {
            "was_ms": time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="wmma", relu=True,
                                                               out_dtype=dtype), reps),
            "loads_ms": time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="sm90", relu=True,
                                                                 out_dtype=dtype, loads_only=True), reps),
        }
    if route == "cin1" and not bn:
        # uncounted launches at enc0a's shape: the wmma build of
        # csrc/conv3d.cu, which ran enc0a before the cin1 route, the cin1
        # kernel's store path alone (bias + ReLU of zero staged and copied
        # out; no loads, no products), and the cin1 kernel on its general
        # paths (cp.async landing, bulk row stores) in place of TMA's
        extra = {
            "was_ms": time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="wmma", relu=True,
                                                               out_dtype=dtype), reps),
            "stores_ms": time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="cin1", relu=True,
                                                                  out_dtype=dtype, stores_only=True), reps),
            "general_ms": time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="cin1", relu=True,
                                                                   out_dtype=dtype, general=True), reps),
        }
    del x, k, b, x_cl, w_cl
    torch.cuda.empty_cache()
    return {
        "name": f"conv3d_{route}:{name}" + (":bn" if bn else ""),
        "route": "cuda",
        "source": CONV_SOURCES[route],
        "replaces": "oai_analysis_2_tpu/ops/pallas_conv.py:100",
        "shape": f"x {list(shape) + [cin]} -> Cout {cout}" + (", no ReLU, f32 out (BN route)" if bn else ""),
        "launches": None,
        "max_abs_err": err,
        "tol": {"atol": tol, "rtol": tol},
        **({} if out_dtype == torch.float32 else {"max_abs_err_f32_out": err_f32, "tol_f32_out": f32_tol}),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": library_ms,
        "tflops": flops / ms * 1e-9,
        **extra,
    }


def distance_case(torch, cuda_kernels, reps):
    n_pts, n_tri = DIST_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    # a soup of small triangles (~0.5 mm edges) and points in a 100 mm box;
    # the kernel's work per pair does not depend on the data
    corner = torch.rand((n_tri, 1, 3), device="cuda", generator=gen) * 100
    tris = (corner + torch.randn((n_tri, 3, 3), device="cuda", generator=gen) * 0.5).reshape(n_tri, 9).contiguous()
    pts = torch.rand((n_pts, 3), device="cuda", generator=gen) * 100
    got = cuda_kernels.point_triangle_distance(pts, tris)
    want = torch.sqrt(cuda_kernels.point_triangle_min_d2_reference(pts, tris, point_chunk=4096, tri_chunk=16384))
    err = check_close("point_triangle", got, want, 1e-3, 1e-4)
    ms = time_ms(torch, lambda: cuda_kernels.point_triangle_distance(pts, tris), reps)
    # the build the kernel replaced, uncounted, in the same call
    was_ms = time_ms(torch, lambda: torch.sqrt(cuda_kernels.point_triangle_launch(pts, tris, build="was")), reps)
    clock = clock_under_load(torch, lambda: cuda_kernels.point_triangle_distance(pts, tris), int(1500 / ms) + 1)
    plain_ms = time_ms(
        torch, lambda: cuda_kernels.point_triangle_min_d2_reference(pts, tris, point_chunk=4096, tri_chunk=16384), 1)
    flops = float(DIST_OPS_PER_PAIR) * n_pts * n_tri
    nbytes = n_pts * 12 + n_tri * 36 + n_pts * 4
    bound_ops, bound_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "name": "point_triangle",
        "route": "cuda",
        "source": "oai_analysis_2_tpu_torch/csrc/point_triangle.cu",
        "replaces": "oai_analysis_2_tpu/ops/pallas_kernels.py:34",
        "shape": f"{n_pts} points x {n_tri} triangles",
        "launches": None,
        "max_abs_err": err,
        "tol": {"atol": 1e-3, "rtol": 1e-4},
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None,
        "was_ms": was_ms,
        "ops_per_pair": DIST_OPS_PER_PAIR,
        **clock,
    }


def shell_probmap(shape_zyx, r_inner=47.5, r_outer=52.5, center=None):
    """A curved cartilage-like shell (probability ~1 between two radii,
    limited to a polar cap) on the atlas grid (the bench fixture's,
    bench.py:70-84)."""
    d, h, w = shape_zyx
    c = center or (d * 0.5, h * 0.55, w * 0.5)
    z, y, x = np.meshgrid(
        np.arange(d, dtype=np.float32),
        np.arange(h, dtype=np.float32),
        np.arange(w, dtype=np.float32),
        indexing="ij",
    )
    rr = np.sqrt(((z - c[0]) * 2.4) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
    shell = np.clip(1.0 - np.abs(rr - (r_inner + r_outer) / 2) / ((r_outer - r_inner) / 2), 0, 1)
    cap = (y < c[1]).astype(np.float32)  # upper cap only
    return (shell * cap).astype(np.float32)


def knee_and_atlas(shape, fc, tc, atlas_fc, atlas_tc, seed=0):
    """The bench fixture (bench.py:128-153): a DESS-like knee carrying two
    shells, and an atlas with the same anatomy slightly shifted and matched
    background texture. fc/tc/atlas_*: (r_inner, r_outer, center or None)."""
    rng = np.random.default_rng(seed)
    anatomy = np.maximum(shell_probmap(shape, *fc), shell_probmap(shape, *tc))
    knee = (anatomy * 900.0 + rng.uniform(0.0, 250.0, shape)).astype(np.float32)
    atlas_anatomy = np.maximum(shell_probmap(shape, *atlas_fc), shell_probmap(shape, *atlas_tc))
    atlas = (atlas_anatomy * 0.78 + rng.uniform(0.0, 0.22, shape)).astype(np.float32)
    return knee, atlas


FULL = dict(shape=(160, 384, 384), fc=(47.5, 52.5, None), tc=(31.5, 35.5, (80, 230, 192)),
            atlas_fc=(47.5, 52.5, (80, 206, 184)), atlas_tc=(31.5, 35.5, (80, 222, 184)))
SMALL = dict(shape=(48, 96, 96), fc=(27.5, 31.5, (24, 53, 48)), tc=(15.5, 19.5, (24, 60, 48)),
             atlas_fc=(27.5, 31.5, (24, 51, 46)), atlas_tc=(15.5, 19.5, (24, 57, 46)))

# phase 5: a small instance registration, card against CPU. Tolerances set
# from the same run of the JAX package against the port on the CPU, whose
# largest gaps were: objective 3e-4 relative, mean inverse-consistency
# error 6e-4 voxel, fold fraction 2e-5, mean map gap 8e-4 (Adam's near
# sign steps turn rounding into whole steps at a few elements); the card's
# sums (and in "exact" the scatter-add of the outer field's gradient)
# round in other orders again
INSTANCE_SMALL = dict(scales=(2, 1), steps_per_scale=(20, 20), lr=0.3)
INSTANCE_SMALL_TOL = dict(objective_rel=5e-3, ice_mean_vox=0.02, fold_fraction=2e-3, map_mean=3e-3)
# phase 6: (a) the CLI's default registration, (b) the accurate mode
ACCURATE = {"a": dict(registration_mode="network", finetune_steps=20),
            "b": dict(registration_mode="instance")}


def build_pipeline(device, fixture, batch_size):
    from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject
    from oai_analysis_2_tpu_torch.core.image import image_from_array
    from oai_analysis_2_tpu_torch.engine.pipeline import KneePipeline

    knee_np, atlas_np = knee_and_atlas(**fixture)
    spacing = (0.36, 0.36, 0.7)
    # the offline configuration: threshold-weights production UNet (bf16)
    ao = AnalysisObject.offline(atlas_shape="phantom:48,96,96", batch_size=batch_size, device=device)
    atlas = image_from_array(atlas_np, spacing=spacing, device=device)
    pipe = KneePipeline(ao.segmenter, atlas, registration_mode="auto", device=device)
    return pipe, image_from_array(knee_np, spacing=spacing, device=device)


def summarize(result) -> dict:
    meshes = {"fc_inner": result.fc_inner, "fc_outer": result.fc_outer,
              "tc_inner": result.tc_inner, "tc_outer": result.tc_outer}
    out = {"points": {k: int(m.n_points) for k, m in meshes.items()},
           "cells": {k: int(m.n_cells) for k, m in meshes.items()}}
    for k, m in meshes.items():
        if m.n_points == 0 or m.point_data is None:
            raise AssertionError(f"empty {k} mesh")
        t = np.asarray(m.point_data)
        if not np.isfinite(t).all():
            raise AssertionError(f"non-finite thickness on {k}")
        out[f"{k}_thickness_mean_mm"] = float(t.mean())
        out[f"{k}_thickness_median_mm"] = float(np.median(t))
    return out


def small_knee_check(torch):
    """The pipeline on a small knee on the card and on the CPU (plain
    versions of both kernels): warped probability maps within 1e-3, mesh
    sizes within 1 %, mean thicknesses within 1 %."""
    res = {}
    for dev in ("cuda", "cpu"):
        pipe, knee = build_pipeline(dev, SMALL, batch_size=4)
        r = pipe.run(knee)
        res[dev] = (r, summarize(r))
    (g, gs), (c, cs) = res["cuda"], res["cpu"]
    for name in ("fc_probmap", "tc_probmap"):
        a, b = getattr(g, name).data.cpu(), getattr(c, name).data
        err = float((a - b).abs().max())
        if err > 1e-3:
            raise AssertionError(f"small knee: {name} card vs CPU max abs err {err} > 1e-3")
    for k, n_gpu in gs["points"].items():
        n_cpu = cs["points"][k]
        if abs(n_gpu - n_cpu) > 0.01 * n_cpu:
            raise AssertionError(f"small knee: {k} has {n_gpu} points on the card, {n_cpu} on the CPU")
        a, b = gs[f"{k}_thickness_mean_mm"], cs[f"{k}_thickness_mean_mm"]
        if abs(a - b) > 0.01 * abs(b):
            raise AssertionError(f"small knee: {k} mean thickness {a} on the card, {b} on the CPU")
    return {"card": gs, "cpu": cs}


def device_spans(prof):
    """(device events, busy microseconds as the union of their intervals,
    microseconds by event name) of a torch.profiler run."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    by_name, busy_us, cur = {}, 0.0, None
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if cur is None or start > cur[1]:
            busy_us += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy_us += 0.0 if cur is None else cur[1] - cur[0]
    return spans, busy_us, by_name


def profile_knee(torch, pipe, knee) -> dict:
    """One more run of the knee under torch.profiler: the device's busy time
    (union of its event intervals) against the run's wall time, and device
    milliseconds by kernel name. The profiler's own cost is in the wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run(knee)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, busy_us, by_name = device_spans(prof)
    # the "was" families are the builds that the enc0a (cin1), f32 and
    # distance kernels replaced: the main path must not reach them
    families = {"conv3d_sm90": "conv3d_sm90_kernel", "conv3d_cin1": "conv3d_cin1_kernel",
                "conv3d_cin1_was": "conv3d_bf16_kernel",
                "conv3d_f32": "conv3d_f32_ring_kernel", "point_triangle": "point_triangle_min_d2_fma_kernel",
                "conv3d_f32_was": "conv3d_f32_kernel", "point_triangle_was": "point_triangle_min_d2_kernel"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "profiled_knee_s": wall,
        "device_events": len(spans),
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall if spans else None,
        "top_device_ms": {name[:90]: us / 1e3 for name, us in top},
        "kernel_device_ms": {fam: sum(us for name, us in by_name.items() if key in name) / 1e3
                             for fam, key in families.items()},
    }


def instance_objective(TG, pab, pba, a, b) -> float:
    """The instance loss's value at given maps (gradicon.py:569-579 with f32
    image warps): the number both devices' runs are held to."""
    sim = TG.make_similarity("lncc+mse", 5)
    return float(sim(a, TG.warp(b, pab)) + sim(b, TG.warp(a, pba)) + 0.5 * TG.gradicon_penalty(pab, pba)
                 + 0.3 * (TG.diffusion_penalty(pab) + TG.diffusion_penalty(pba)))


def instance_small_check(torch) -> dict:
    """`register_pair_instance` on the small knee (scaled to [0, 1]) and its
    atlas, both 2x average-pooled to 24x48x48, on the card and on the CPU,
    in both gradient modes; the CPU evaluates both results."""
    from oai_analysis_2_tpu_torch.models import gradicon as TG

    knee, atlas = knee_and_atlas(**SMALL)
    knee = knee / knee.max()
    tol = INSTANCE_SMALL_TOL
    out = {}
    for mode in ("alternating", "exact"):
        res, maps = {}, {}
        for dev in ("cuda", "cpu"):
            a = TG.downsample2x(torch.tensor(knee, device=dev))
            b = TG.downsample2x(torch.tensor(atlas, device=dev))
            t0 = time.perf_counter()
            pab, pba = TG.register_pair_instance(a, b, gicon_grad=mode, **INSTANCE_SMALL)
            pab, pba = pab.cpu(), pba.cpu()
            secs = time.perf_counter() - t0
            q = {k: float(v) for k, v in TG.map_quality_stats(pab, pba).items()}
            res[dev] = {"seconds": secs, "objective": instance_objective(TG, pab, pba, a.cpu(), b.cpu()), **q}
            maps[dev] = (pab, pba)
        g, c = res["cuda"], res["cpu"]
        map_mean = max(float((maps["cuda"][i] - maps["cpu"][i]).abs().mean()) for i in range(2))
        res["map_mean_abs_diff"] = map_mean
        bad = []
        if not all(np.isfinite(v) for r in (g, c) for v in r.values()):
            bad.append("non-finite result")
        if abs(g["objective"] - c["objective"]) > tol["objective_rel"] * abs(c["objective"]):
            bad.append(f"objective {g['objective']} vs {c['objective']}")
        if abs(g["ice_mean_vox"] - c["ice_mean_vox"]) > tol["ice_mean_vox"]:
            bad.append(f"ice_mean_vox {g['ice_mean_vox']} vs {c['ice_mean_vox']}")
        for k in ("fold_fraction_ab", "fold_fraction_ba"):
            if abs(g[k] - c[k]) > tol["fold_fraction"]:
                bad.append(f"{k} {g[k]} vs {c[k]}")
        if map_mean > tol["map_mean"]:
            bad.append(f"mean map gap {map_mean}")
        if bad:
            raise AssertionError(f"instance small ({mode}): card and CPU disagree: {'; '.join(bad)}")
        out[mode] = res
    return out


def accurate_knee(torch, cuda_conv, cuda_kernels, base, knee, name, kwargs) -> dict:
    """One configuration of phase 6 on the full knee, sharing phase 4's
    segmenter and atlas."""
    from oai_analysis_2_tpu_torch.engine.atlas_products import thickness_map_stats
    from oai_analysis_2_tpu_torch.engine.pipeline import KneePipeline

    pipe = KneePipeline(base.segmenter, base.atlas, atlas_products=True, device="cuda", **kwargs)
    # the atlas mapper segments the atlas once, on first use: its launches
    # are counted apart from the knee's
    reset_launches(cuda_conv, cuda_kernels)
    t0 = time.perf_counter()
    mapper = pipe._get_mapper()
    torch.cuda.synchronize()
    atlas_s = time.perf_counter() - t0
    atlas_launches = read_launches(cuda_conv, cuda_kernels)
    check_bf16_routes(atlas_launches, f"({name}) atlas segmentation")
    if atlas_launches["conv3d_cin1"] <= 0:
        raise AssertionError(f"({name}) atlas segmentation launched no conv")
    t0 = time.perf_counter()
    pipe.run(knee)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_launches(cuda_conv, cuda_kernels)
    t0 = time.perf_counter()
    result = pipe.run(knee)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(cuda_conv, cuda_kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    summary = summarize(result)
    fc_med = summary["fc_inner_thickness_median_mm"]
    if not 0.2 < fc_med < 10.0:
        raise AssertionError(f"({name}) implausible FC thickness median {fc_med}")
    maps = result.thickness_2d
    for tissue in ("fc", "tc"):
        for key in ("x", "y", "thickness", "map"):
            arr = maps[f"{tissue}_{key}"]
            if arr.size == 0 or not np.isfinite(arr).all():
                raise AssertionError(f"({name}) {tissue}_{key}: empty or non-finite")
    stats = thickness_map_stats(maps)
    for tissue in ("fc", "tc"):
        if not stats[f"{tissue}_raster_coverage"] > 0:
            raise AssertionError(f"({name}) zero {tissue} raster coverage")
    quality = result.registration_quality
    if not quality or not all(np.isfinite(v) for v in quality.values()):
        raise AssertionError(f"({name}) registration quality missing or non-finite: {quality}")
    check_bf16_routes(launches, f"({name}) knee")
    for kname in ("conv3d_sm90", "conv3d_cin1", "point_triangle"):
        if launches[kname] <= 0:
            raise AssertionError(f"({name}) kernel {kname} was not launched on the main path")
    # the GradICON network is the only f32 conv: 3 stages x 2 directions x
    # 10 convs in (a), none in instance optimization (b)
    want_f32 = 60 if kwargs["registration_mode"] == "network" else 0
    if launches["conv3d_f32"] != want_f32:
        raise AssertionError(f"({name}) register took {launches['conv3d_f32']} f32 conv launches, want {want_f32}")
    return {
        "config": kwargs,
        "registration_mode": pipe.registerer.mode,
        "atlas_mapper_s": atlas_s,
        "atlas_segmentation_launches": atlas_launches,
        "atlas_points": {"fc": mapper.fc_atlas_inner.n_points, "tc": mapper.tc_atlas_inner.n_points},
        "first_run_s": first_s,
        "knee_seconds": wall,
        "stage_seconds": {k: v["seconds"] for k, v in result.timings.items()},
        "launches": launches,
        "max_memory_allocated_gb": peak_gb,
        "registration_quality": quality,
        "thickness_maps": stats,
        **summary,
    }


RELEASE_ATLAS = "atlas_60_LEFT_baseline_NMI"
# phase 8 (b): the CLI knee's launches (5 z-slabs x 14 bf16 convs, the
# network's 60 f32 convs, 2 tissues x 2 distance directions)
CLI_LAUNCHES = {"conv3d_sm90": 65, "conv3d_cin1": 5, "conv3d_wmma": 0, "conv3d_f32": 60, "point_triangle": 4}


def reference_state_dict(torch, params: dict, n_dec: int) -> dict:
    """The reference's torch state_dict (`ec*` / `dc*` Sequential names) of
    a UNet tree: the exact inverse of the port's converter
    (`oai_analysis_2_tpu_torch/utils/checkpoint.py`). Conv3d (O, I, D, H, W)
    from DHWIO; the k2s2 ConvTranspose3d (I, O, 2, 2, 2); the k3s1p1
    ConvTranspose3d from the forward kernel flipped back; BN as the
    Sequential's second module."""
    sd = {}

    def put(name, p, weight):
        sd[f"{name}.0.weight"] = torch.tensor(np.ascontiguousarray(weight))
        if "bias" in p:
            sd[f"{name}.0.bias"] = torch.tensor(p["bias"])
        if "bn" in p:
            for leaf, key in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"), ("var", "running_var")):
                sd[f"{name}.1.{key}"] = torch.tensor(p["bn"][leaf])

    for key, p in params.items():
        k = p["kernel"]
        if key.startswith("enc"):
            put(f"ec{2 * int(key[3]) + (key[4] == 'b')}", p, np.transpose(k, (4, 3, 0, 1, 2)))
        elif key.startswith("dec"):
            base, part = 3 * (n_dec - int(key[3])), key[4:]
            if part == "up":
                put(f"dc{base}", p, np.transpose(k, (3, 4, 0, 1, 2)))
            else:
                put(f"dc{base - 1 if part == 'a' else base - 2}", p,
                    np.transpose(k[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)))
        else:
            sd["dc0.weight"] = torch.tensor(np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2))))
            sd["dc0.bias"] = torch.tensor(p["bias"])
    return sd


def identity_bn(params: dict, eps: float = 1e-5) -> dict:
    """`params` with batch norm on every block but the head whose statistics
    make it the identity: mean 0, var 1 - eps, scale 1, bias 0."""
    out = {}
    for name, p in params.items():
        out[name] = dict(p)
        if not name.startswith("head"):
            c = p["kernel"].shape[-1]
            out[name]["bn"] = {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
                               "mean": np.zeros(c, np.float32), "var": np.full(c, 1.0 - eps, np.float32)}
    return out


def release_layout(torch, cuda_conv, cuda_kernels, base, knee, ref) -> dict:
    """Phase 8: the release layout on disk and the CLI, held against phase 6
    (a) (`ref`), which ran the same knee, atlas and weights in memory."""
    import shutil
    from pathlib import Path

    from oai_analysis_2_tpu_torch import __main__ as cli
    from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject
    from oai_analysis_2_tpu_torch.core.nifti import write_nifti
    from oai_analysis_2_tpu_torch.engine.pipeline import KneePipeline
    from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise
    from oai_analysis_2_tpu_torch.mesh.types import Mesh
    from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, make_threshold_params
    from oai_analysis_2_tpu_torch.ops.intensity import percentile_window

    out = {}
    # (a) a release-shaped tree: the production UNet's threshold weights as
    # the reference's torch checkpoint (and a variant with identity BN), the
    # atlas image and the segmenter's maps of it, and the knee
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "release_smoke"
    shutil.rmtree(root, ignore_errors=True)
    data = root / "data"
    spec = NETWORK_SPECS["UNet"].replace(bias=True)
    params = make_threshold_params(spec, gain=24.0, threshold=0.5)
    setting = {"in_channels": 1, "n_classes": 2, "bias": True}
    for name, tree, bn in (("models", params, False), ("models_bn", identity_bn(params), True)):
        d = data / name
        d.mkdir(parents=True)
        torch.save({"model_state_dict": reference_state_dict(torch, tree, len(spec.dec)), "epoch": 600},
                   d / "segmentation_model.pth.tar")
        (d / "segmentation_train_config.pth.tar").write_text(json.dumps(
            {"patch_size": [128, 128, 32], "model": "UNet", "model_setting": dict(setting, BN=bn)}))
    atlas_dir = data / "atlases" / RELEASE_ATLAS
    atlas_dir.mkdir(parents=True)
    fc_p, tc_p = base.segmenter.segment(base.atlas, if_output_prob_map=True)
    knee_path = root / "knee.nii.gz"
    t1 = time.perf_counter()
    for path, image in ((atlas_dir / "atlas_image.nii.gz", base.atlas), (atlas_dir / "atlas_fc.nii.gz", fc_p),
                        (atlas_dir / "atlas_tc.nii.gz", tc_p), (knee_path, knee)):
        write_nifti(image, path)
    out["nifti_write_s"] = time.perf_counter() - t1
    out["tree_s"] = time.perf_counter() - t0
    out["knee_nii_gz_mb"] = knee_path.stat().st_size / 1e6
    os.environ["OAI_TPU_DATA_DIR"] = str(data)

    def check_meshes(out_dir, meta):
        got = {}
        for tissue in ("FC", "TC"):
            for side in ("inner", "outer"):
                key = f"{tissue.lower()}_{side}"
                mesh = Mesh.load_vtk(out_dir / f"knee_{tissue}_{side}.vtk")
                n, n_ref = mesh.n_points, ref["points"][key]
                if mesh.point_data is None or len(mesh.point_data) != n or not np.isfinite(mesh.point_data).all():
                    raise AssertionError(f"{out_dir.name}/{key}: thickness missing or non-finite after the read-back")
                mean, mean_ref = float(mesh.point_data.mean()), ref[f"{key}_thickness_mean_mm"]
                if abs(n - n_ref) > 0.005 * n_ref or abs(mean - mean_ref) > 0.01 * abs(mean_ref):
                    raise AssertionError(f"{out_dir.name}/{key}: {n} points, mean {mean} mm; phase 6 (a) had "
                                         f"{n_ref}, {mean_ref} mm")
                got[key] = {"points": n, "thickness_mean_mm": mean}
        if (meta["fc_points"], meta["tc_points"]) != (got["fc_inner"]["points"], got["tc_inner"]["points"]):
            raise AssertionError(f"{out_dir.name}: VTK point counts differ from the run's {meta}")
        return got

    # (b) the CLI's pipeline command in this process, twice; the second run
    # is reported
    cli_dir = root / "out_cli"
    for _ in range(2):
        reset_launches(cuda_conv, cuda_kernels)
        t0 = time.perf_counter()
        meta = cli.main(["pipeline", str(knee_path), "-o", str(cli_dir)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = read_launches(cuda_conv, cuda_kernels)
    if launches != CLI_LAUNCHES:
        raise AssertionError(f"CLI pipeline launches {launches}, want {CLI_LAUNCHES}")
    out["cli"] = {"command_s": cli_s, "read_seconds": meta["read_seconds"], "write_seconds": meta["write_seconds"],
                  "stage_seconds": {k: v["seconds"] for k, v in meta["timings"].items()},
                  "registration_quality": meta["registration_quality"], "launches": launches,
                  "meshes": check_meshes(cli_dir, meta)}

    # (c) run_path with the atlas maps read from NIfTI: the mapper launches
    # no conv
    obj = AnalysisObject(device="cuda")
    pipe = KneePipeline(obj.segmenter, obj.atlas_image, registration_mode="auto", finetune_steps=20,
                        atlas_products=True, atlas_dir=obj.atlas_dir, device="cuda")
    reset_launches(cuda_conv, cuda_kernels)
    t0 = time.perf_counter()
    mapper = pipe._get_mapper()
    torch.cuda.synchronize()
    mapper_s = time.perf_counter() - t0
    mapper_launches = read_launches(cuda_conv, cuda_kernels)
    if any(mapper_launches[k] for k in ("conv3d_sm90", "conv3d_cin1", "conv3d_wmma", "conv3d_f32")):
        raise AssertionError(f"the atlas mapper segmented the atlas: {mapper_launches}")
    atlas_dir_out = root / "out_atlas"
    for _ in range(2):
        meta_c = pipe.run_path(knee_path, output_dir=atlas_dir_out)
    if not (atlas_dir_out / "knee_thickness_2d.npz").is_file() or meta_c.get("thickness_2d") is None:
        raise AssertionError("run_path wrote no knee_thickness_2d.npz")
    for tissue in ("fc", "tc"):
        cov, cov_ref = meta_c[f"{tissue}_raster_coverage"], ref["thickness_maps"][f"{tissue}_raster_coverage"]
        mean, mean_ref = meta_c[f"{tissue}_mean_thickness_mm"], ref["thickness_maps"][f"{tissue}_mean_thickness_mm"]
        if abs(cov - cov_ref) > 0.005 or abs(mean - mean_ref) > 0.01 * abs(mean_ref):
            raise AssertionError(f"atlas maps {tissue}: coverage {cov}, mean {mean} mm; phase 6 (a) had "
                                 f"{cov_ref}, {mean_ref} mm")
    out["atlas"] = {"mapper_s": mapper_s, "mapper_launches": mapper_launches,
                    "atlas_points": {"fc": mapper.fc_atlas_inner.n_points, "tc": mapper.tc_atlas_inner.n_points},
                    "read_seconds": meta_c["read_seconds"], "write_seconds": meta_c["write_seconds"],
                    "stage_seconds": {k: v["seconds"] for k, v in meta_c["timings"].items()},
                    "thickness_maps": {k: v for k, v in meta_c.items() if k.endswith(("_coverage", "_mm"))},
                    "meshes": check_meshes(atlas_dir_out, meta_c)}

    # (d) the segment stage of the full knee with identity batch norm: the
    # BN route (convs without ReLU, f32 out; BN, ReLU, cast after) against
    # the fused route's maps
    pre = percentile_window(knee, 0.1, 99.9, 0.0, 1.0)
    seg_bn = Segmenter3DInPatchClassWise(mode="pred", config=dict(
        ckpoint_path=str(data / "models_bn" / "segmentation_model.pth.tar"),
        training_config_file=str(data / "models_bn" / "segmentation_train_config.pth.tar"),
        batch_size=4, overlap_size=(16, 16, 8), compute_dtype="bfloat16", device="cuda"))
    seg_bn.pred_setup()
    if seg_bn.model.enc0a.bn is None or seg_bn.model.head.bn is not None:
        raise AssertionError("the BN checkpoint did not build a BN UNet")
    want = obj.segmenter.segment(pre, if_output_prob_map=True)
    seg_bn.segment(pre, if_output_prob_map=True)
    reset_launches(cuda_conv, cuda_kernels)
    t0 = time.perf_counter()
    got = seg_bn.segment(pre, if_output_prob_map=True)
    torch.cuda.synchronize()
    bn_s = time.perf_counter() - t0
    bn_launches = read_launches(cuda_conv, cuda_kernels)
    if (bn_launches["conv3d_sm90"], bn_launches["conv3d_cin1"], bn_launches["conv3d_wmma"]) != (65, 5, 0):
        raise AssertionError(f"BN segment launches {bn_launches}, want 65 sm90, 5 cin1, no wmma")
    err = max(float((g.data - w.data).abs().max()) for g, w in zip(got, want))
    if not err <= 1e-3 or not all(bool(g.data.isfinite().all()) for g in got):
        raise AssertionError(f"identity-BN segment differs from the fused route by {err} (> 1e-3)")
    out["bn_segment"] = {"segment_s": bn_s, "max_abs_err": err, "tol": 1e-3, "launches": bn_launches,
                         "profiled": {name: profile_segment(torch, seg, pre)
                                      for name, seg in (("bn", seg_bn), ("fused", obj.segmenter))}}
    return out


def profile_segment(torch, segmenter, pre) -> dict:
    """One segment call under torch.profiler: wall, device busy time and
    the largest device times by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        segmenter.segment(pre, if_output_prob_map=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, busy_us, by_name = device_spans(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_s": wall, "device_events": len(spans), "device_busy_s": busy_us / 1e6,
            "top_device_ms": {name[:90]: us / 1e3 for name, us in top}}


def instance_steps(torch, pipe, knee, steps=20) -> dict:
    """Milliseconds per Adam step of instance optimization at each scale of
    the 48x96x96 grid (the knee and atlas resampled onto it, identity
    bases), and one step at scale 1 under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from oai_analysis_2_tpu_torch.engine.registration import _net_grid_reference
    from oai_analysis_2_tpu_torch.models import gradicon as TG
    from oai_analysis_2_tpu_torch.ops.intensity import percentile_window
    from oai_analysis_2_tpu_torch.ops.resample import resample_image

    grid = pipe.reg_config.grid_shape
    pre = percentile_window(knee, 0.1, 99.9, 0.0, 1.0)
    a = resample_image(pre, _net_grid_reference(pre, grid)).data.float()
    b = resample_image(pipe.atlas, _net_grid_reference(pipe.atlas, grid)).data.float()
    ms, problems = {}, {}
    for scale in (4, 2, 1):
        a_s, b_s = TG.pyramid(a, scale), TG.pyramid(b, scale)
        ident = TG.identity_map(a_s.shape, a.device)
        for mode in ("alternating", "exact") if scale == 1 else ("alternating",):
            prob = TG.InstanceScale(ident, ident, a_s, b_s, gicon_grad=mode)
            for _ in range(3):
                prob.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                prob.step()
            torch.cuda.synchronize()
            ms[f"scale{scale}_{mode}"] = (time.perf_counter() - t0) / steps * 1e3
            problems[(scale, mode)] = prob
    prob = problems[(1, "alternating")]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prob.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, busy_us, by_name = device_spans(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    copies = sum(1 for _, _, n in spans if n.startswith(("Memcpy", "Memset")))
    return {
        "grid": list(grid),
        "ms_per_step": ms,
        "profiled_step": {
            "scale": 1,
            "gicon_grad": "alternating",
            "wall_ms": wall * 1e3,
            "device_events": len(spans),
            "memcpy_memset_events": copies,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / (wall * 1e3) if spans else None,
            "top_device_ms": {name[:90]: us / 1e3 for name, us in top},
        },
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from oai_analysis_2_tpu_torch.ops import cuda_build, cuda_conv, cuda_kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. build ------------------------------------------------------------
    card = card_line()
    log(f"phase build: card {card}")
    t0 = time.perf_counter()
    cuda_build.build_all()
    log(f"phase build: {len(cuda_build.EXTRA_FLAGS)} kernel libraries built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- 2. kernels against their plain versions -----------------------------
    t0 = time.perf_counter()
    # 5 reps at the slab's wide convs; enc0a (Cin = 1) takes 20, since its
    # 0.2 ms would carry the first launch's host time at 5
    kernels = [conv_case(torch, F, cuda_conv, name, shape, cin, cout, torch.bfloat16, 2e-2,
                         reps=5 if shape == SLAB and cin > 1 else 20)
               for name, shape, cin, cout in SEG_CONVS]
    # the batch-norm UNet's route (no ReLU, f32 out) at enc0b (sm90) and enc0a (cin1)
    kernels += [conv_case(torch, F, cuda_conv, name, shape, cin, cout, torch.bfloat16, 2e-2,
                          reps=5 if cin > 1 else 20, bn=True)
                for name, shape, cin, cout in SEG_CONVS if name in ("enc0b", "enc0a")]
    kernels += [conv_case(torch, F, cuda_conv, name, shape, cin, cout, torch.float32, 1e-4, reps=20,
                          clock=name == "stage2.dec1a")
                for name, shape, cin, cout in gradicon_convs()]
    kernels.append(distance_case(torch, cuda_kernels, reps=5))
    for k in kernels:
        more = f", was {k['was_ms']:.3f} ms" if "was_ms" in k else ""
        more += f", loads alone {k['loads_ms']:.3f} ms" if "loads_ms" in k else ""
        more += f", stores alone {k['stores_ms']:.3f} ms" if "stores_ms" in k else ""
        more += f", general paths {k['general_ms']:.3f} ms" if "general_ms" in k else ""
        more += f", multiplies alone {k['compute_ms']:.3f} ms" if "compute_ms" in k else ""
        more += f", SM clock {k['sm_clock_mhz']} MHz at {k['power_w']} W" if "sm_clock_mhz" in k else ""
        log(f"phase kernels: {k['name']} [{k['shape']}] max_abs_err {k['max_abs_err']:.3g} "
            f"kernel {k['ms']:.3f} ms, plain {k['plain_ms']:.3f} ms, library {k['library_ms']} ms, "
            f"bound {k['bound_ms']:.3f} ms ({k['bound_by']}){more}")
    log(f"phase kernels: done in {time.perf_counter() - t0:.1f} s")

    # ---- 3. small knee, card vs CPU -----------------------------------------
    t0 = time.perf_counter()
    small = small_knee_check(torch)
    log(f"phase small knee: card and CPU agree ({time.perf_counter() - t0:.1f} s): {json.dumps(small)}")

    # ---- 4. full-size knee ---------------------------------------------------
    t0 = time.perf_counter()
    pipe, knee = build_pipeline("cuda", FULL, batch_size=8)
    log(f"phase full knee: fixture and pipeline built in {time.perf_counter() - t0:.1f} s "
        f"(registration mode {pipe.registerer.mode}, grid {pipe.reg_config.grid_shape}, "
        f"width {pipe.reg_config.stage_width})")
    t0 = time.perf_counter()
    pipe.run(knee)
    torch.cuda.synchronize()
    log(f"phase full knee: first run {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    reset_launches(cuda_conv, cuda_kernels)
    t0 = time.perf_counter()
    result = pipe.run(knee)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(cuda_conv, cuda_kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for name in ("fc_probmap", "tc_probmap"):
        data = getattr(result, name).data
        if tuple(data.shape) != FULL["shape"] or not bool(data.isfinite().all()):
            raise AssertionError(f"{name}: shape {tuple(data.shape)} or non-finite values")
        if not (float(data.min()) >= 0.0 and float(data.max()) <= 1.0 and float(data.max()) > 0.5):
            raise AssertionError(f"{name}: values outside [0, 1] or no tissue")
    summary = summarize(result)
    fc_med = summary["fc_inner_thickness_median_mm"]
    if not 0.2 < fc_med < 10.0:
        raise AssertionError(f"implausible FC thickness median {fc_med}")
    quality = result.registration_quality
    if not quality or not all(np.isfinite(v) for v in quality.values()):
        raise AssertionError(f"registration quality missing or non-finite: {quality}")
    for name, n in launches.items():
        if name != "conv3d_wmma" and n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    check_bf16_routes(launches, "full knee")
    for k in kernels:
        k["launches"] = launches[k["name"].split(":")[0]]

    report = {
        "knee_seconds": wall,
        "stage_seconds": {k: v["seconds"] for k, v in result.timings.items()},
        "launches": launches,
        "max_memory_allocated_gb": peak_gb,
        "registration_quality": quality,
        **summary,
    }
    log(f"phase full knee: second run {wall:.3f} s: {json.dumps(report)}")

    # where the thickness stage's time goes: the same warped maps once more,
    # timed per substage with the card synchronized at each substage end
    from oai_analysis_2_tpu_torch.mesh.processing import get_thickness_meshes

    substages = {}
    get_thickness_meshes([result.fc_probmap, result.tc_probmap], ["FC", "TC"], timings_out=substages)
    log(f"phase full knee: thickness substage seconds {json.dumps(substages)}")
    profiled = profile_knee(torch, pipe, knee)
    log(f"phase full knee: profiled run {json.dumps(profiled)}")
    device_ms = profiled["kernel_device_ms"]
    for fam in ("conv3d_cin1", "conv3d_f32", "point_triangle"):
        if not device_ms[fam] > 0.0 or device_ms[f"{fam}_was"] != 0.0:
            raise AssertionError(f"profiled knee: {fam} ran {device_ms[fam]} ms in its kernel and "
                                 f"{device_ms[fam + '_was']} ms in the build it replaced")

    # ---- 5. instance optimization, card vs CPU ---------------------------------
    t0 = time.perf_counter()
    inst_small = instance_small_check(torch)
    log(f"phase instance small: card and CPU agree ({time.perf_counter() - t0:.1f} s): {json.dumps(inst_small)}")

    # ---- 6. the full knee with fine-tuning or instance optimization and the
    # atlas thickness maps ------------------------------------------------------
    accurate = {}
    for name, kwargs in ACCURATE.items():
        t0 = time.perf_counter()
        accurate[name] = accurate_knee(torch, cuda_conv, cuda_kernels, pipe, knee, name, kwargs)
        log(f"phase accurate knee ({name}): second run {accurate[name]['knee_seconds']:.3f} s "
            f"({time.perf_counter() - t0:.1f} s in all): {json.dumps(accurate[name])}")

    for k in kernels:
        fam = k["name"].split(":")[0]
        k["launches_by_path"] = {"network": k["launches"],
                                 **{f"{name}_atlas_segmentation": r["atlas_segmentation_launches"][fam]
                                    for name, r in accurate.items()},
                                 **{name: r["launches"][fam] for name, r in accurate.items()}}

    # ---- 7. instance steps ------------------------------------------------------
    t0 = time.perf_counter()
    steps = instance_steps(torch, pipe, knee)
    log(f"phase instance steps ({time.perf_counter() - t0:.1f} s): {json.dumps(steps)}")

    # ---- 8. the release layout on disk and the CLI -----------------------------
    t0 = time.perf_counter()
    release = release_layout(torch, cuda_conv, cuda_kernels, pipe, knee, accurate["a"])
    release["phase_s"] = time.perf_counter() - t0
    for k in kernels:
        fam = k["name"].split(":")[0]
        k["launches_by_path"].update(cli=release["cli"]["launches"][fam],
                                     bn_segment=release["bn_segment"]["launches"][fam])
        if k["name"].endswith(":bn"):  # the BN route's own path
            k["launches"] = release["bn_segment"]["launches"][fam]
    log(f"phase release layout ({release['phase_s']:.1f} s, card {card}): {json.dumps(release)}")

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
