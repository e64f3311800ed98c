"""Drive the PyTorch/CUDA port (`oai_analysis_2_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each fatal on failure (exit code 1, no result line):

1. build: compile the hand-written kernels in `oai_analysis_2_tpu_torch/csrc/`
   (one nvcc per source, all started together) and the host-geometry
   library `oai_analysis_2_tpu_torch/native/native.cpp` (g++), and print
   the card's name and power limit as nvidia-smi gives them;
2. kernels: hold each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it, and time the kernel, the plain version
   and (where one exists) one PyTorch library call computing the same
   function, with CUDA events. The conv routes
   (`cuda_conv.conv3d_route`): the TMA + wgmma kernel `sm90` at the segment
   UNet's three full-resolution shapes and one shape per lower level, the
   mma.sync kernel `cin1` at enc0a (Cin = 1), the narrow TMA + wgmma kernel
   `sm90n` at the segmentation trainer's enc0b data gradient (64 -> 32 at
   2x32x128x128; its other shapes are phase 11's), the f32 kernel at each
   of the ten convs of the finest GradICON stage (from the stage spec, at
   their grid sizes), the mma.sync kernel `cinsmall` at the bf16 GradICON
   trainer's enc0a forward (2 -> 24 at 1x48x96x96); the wmma build serves
   no path. A bf16 conv is checked with f32 output and with the bf16
   output the main path takes (each its own build of the kernel); enc0b
   (sm90) and enc0a (cin1) are checked once more on the batch-norm UNet's
   route, without ReLU and with f32 output (rows named `...:bn`), and
   enc0b, dec2a, enc1b, enc3b (sm90) and enc0a (cin1) once more at the
   knee batch's shapes (rows named `...:b16`: 16 tiles of 32x128x128 a
   step, the training tiling that two knees take). At each unbatched
   sm90, sm90n, cin1 and cinsmall shape it also times the wmma build (which
   ran those convs before) and the sm90 or sm90n kernel's loads-only or the cin1
   kernel's stores-only and general-path builds; at each f32 shape and at the
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
   launch, and the wmma build and the sm90n and cinsmall kernels none; the
   thickness stage's component filter (one call a tissue) and smoothing
   table (one adjacency and one fill) must have gone through the
   host-geometry library `native`, as in phases 6, 8, 9 (b) and 10 (b)
   and on the bench's JSON line. Then the thickness stage runs once
   more, timed per substage; on its filtered meshes (and their union) the
   native adjacency, table and components are held against the plain
   numpy / scipy versions (equal degrees and neighbour sets, the table of
   the plain CSR in the same order, the same partition) and both are
   timed; and the knee runs once more under torch.profiler
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
   and each route's segment once under torch.profiler;
9. cohort from disk: (a) phase 8's knee written as a zarr store (zlib
   chunks) under the git-ignored `build/cohort_smoke/` and read by
   `engine.stages.readimage` from the directory and over a loopback
   `http.server` thread: voxels and metadata exactly the NIfTI read's;
   (b) a directory of three copies of the knee through the CLI's `cohort`
   command in this process (the next knee decoded on the prefetch thread):
   3 done, no failed or retried record, launches exactly 3 x phase 8
   (b)'s, each knee's VTK files within phase 8's tolerances of phase 8
   (b)'s; per-knee decode, copy, stage and write seconds, the runner's wall
   time, items_per_hour and a lower bound on the read time the prefetch
   hid; then the same command again, which must run nothing; (c) `python
   -m oai_analysis_2_tpu_torch bench` and `prewarm --shape 48,96,96` in
   subprocesses: the bench's JSON line (FC median 0.2-10 mm, a positive
   fresh-process warm-up) and prewarm's report (every kernel library
   present after it, a first knee that took time), and every batched key
   of the bench line present and finite;
10. knee batch: (a) two distinct full-size knees (the fixture knee and one
   with shifted shells and another noise seed) through the segmenter at
   the training tiling, as a pair, alone and swapped: each knee's maps
   from the pair within 1e-3 of its maps alone (the two passes share
   tiles and differ in the conv batch alone), the swapped pair's outputs
   swapped; (b) `BatchKneePipeline.run_batch` on the two knees (network +
   20 fine-tuning steps, bf16 warp, segmenter batch 8), twice: the second
   run's launches exactly 2 x 130 sm90 + 2 x 10 cin1 (20 steps of 16
   tiles), 2 x 60 f32 conv and 8 distance, each knee's four meshes within
   phase 8's tolerances of the same knee through `KneePipeline.run`,
   device batch, thickness and per-knee seconds and peak memory; (c)
   `run_batches` over the pair twice: each batch's maps and meshes as
   (b)'s, and the overlap gain; (d) `CohortRunner` with the batch
   pipeline (a wrapper of `run_batch`, batch_size 2) over four knees (the
   two, twice): 4 done, no failed or retried record, the batch pipeline
   called twice and the single-item pipeline never, launches 2 x (b)'s;
   (e) marching tetrahedra on (b)'s first knee's warped maps: the
   iso-surfaces on the card and on the CPU with equal counts and faces and
   vertices within 1e-5 mm, the components, smoothing and split on both
   with equal counts and faces and vertices within 1e-5 mm, and
   `get_thickness_meshes(method="tets")` on the card with an FC median of
   0.2-10 mm and its thickness within 1e-3 mm of the CPU's plain distance
   at every 100th vertex of each surface (all of them would take minutes
   on the host);
11. training: (a) `cuda_conv.Conv3dFn` (the conv kernels under autograd)
   against autograd through the plain conv at every trainer shape (the
   w24 GradICON finest stage's ten convs in bf16, one f32 stage conv, the
   production UNet's 14 convs at 2x32x128x128): forward, data gradient,
   weight and bias gradients, with times (the sm90n rows add the wmma
   build's and the loads-only build's); (b) 3 f32 steps of the GradICON
   and UNet train steps on the card against the CPU; (c) 20 steps of the
   w24 GradICON recipe: launches a step exactly as `conv3d_route` gives
   them (12 sm90 + 12 cinsmall + 96 sm90n forward, 116 sm90n data
   gradients, no wmma), the checkpoint reloaded bit-equal, one step under
   torch.profiler; (d) 5 segmentation steps on the production UNet (13
   sm90 + 1 cin1 forward, 12 sm90 + 1 sm90n data gradients a step, no
   wmma), the loss falling; (e) the w24 recipe from scratch through
   `tools/port_train_w24_cycles.run_cycles`, cut to 3 warm-restart cycles
   of 10 steps on a pool of 8 (peak lr 3e-4, 1.5e-4, 8e-5; zero heads):
   the tool's gates (finite losses, (c)'s launches a step, a `.best` that
   never rises, each cycle resumed from the checkpoint on disk, every
   checkpoint reloaded bit-equal and giving its sidecar's eval), then
   `validate_registration --network 0 --weights` on the result, which
   must finish with a finite error;
12. examples: the port's modules of the JAX package's example scripts,
   as a user runs them: (a) `validate_registration.main` at its default
   80x192x192 phantom with `--network 0`, `--network 20`, in instance
   mode (scales 4, 2, 1 x 80, 60, 40 steps) and in the other three
   schedules of `tools/reg_accuracy_sweep.sh` (`--network 20 --ft-scales
   2,1 --ft-lr 0.4`, and Adam at lr 1.2 from the network's maps,
   `--network 30,20,15` and `--network 40,30,20` with `--ft-scales 4,2,1
   --ft-lr 1.2`): the known-deformation error in mm, its mean within
   `VALIDATE_TOL_MM` of the JAX package's CPU number (`VALIDATE_JAX_CPU`),
   60 f32 conv launches a network run and none in instance mode; (b)
   `validate_registration_cross.main` with
   `--network 0`, `--network 10` and in instance mode on the 48x96x96
   grid: the image match, inverse consistency, Jacobian statistics and
   folded fraction within `CROSS_TOL` of `CROSS_JAX_CPU`; (c)
   `full_demo.main(["phantom", dir])` at 160x384x384, then at
   `OAI_DEMO_SHAPE=80,192,192` within `FULL_DEMO_TOL_80` of the JAX
   package's CPU numbers: every output file, finite maps, non-empty
   inner meshes, an FC median of 0.2-10 mm, covered rasters, 13 sm90
   launches per cin1, none on wmma, sm90n or cinsmall, 60 f32 and 4
   distance; then four more times at 80x192x192 with the knee moved by
   one f32 ulp at 1 % of its voxels (`tools/port_full_demo_spread.py`'s
   `port_knee_perturbed`, seeds 1-4, the perturbations of its CPU runs),
   each run held as the unperturbed one, and the card's band of the
   mapped means printed beside both packages' CPU bands
   (`FULL_DEMO_CPU_BAND`); (d) on phase 8's release tree, the
   segmentation demo's voxel counts equal to the CLI route's on the same windowed knee, the
   thickness demo's inner mesh within phase 8's tolerances of
   `get_thickness_mesh` on the same map, and the cohort demo over two
   copies of the knee: 2 done, no failed or retried record; (e) instance
   mode again with the phantom moved by one f32 ulp at 1 % of its voxels
   (`validate_registration.main(perturb=(seed, 0.01))`, seeds 1-4, the
   perturbations of `tools/port_instance_spread.py`'s CPU runs): each
   run's mean error and seconds, the card's band, every run (and (a)'s)
   within the CPU runs' band (`INSTANCE_CPU_BAND`: its min to max or its
   mean +- 3 standard deviations), the card's band and mean printed beside
   each package's CPU band (`INSTANCE_CPU_PACKAGE_BANDS`);
13. sharding: the multi-card path (`parallel/sharding.py`,
   `BatchKneePipeline(mesh=...)`) in one process a rank: one rank a card
   over NCCL where there are two or more cards, else two ranks on the one
   card over gloo (NCCL refuses two ranks on one GPU; the ranks then show
   what the collectives cost, not scaling), loading the kernels this
   process built. Each rank: (a) 3 data-parallel steps of the production
   UNet in bf16 on a global batch of 2 tiles of 32x128x128 a rank,
   against rank 0's unsharded steps (`compare_train_runs`, the gradients
   by the bf16 rule), the parameters bit-equal on every rank, one step
   under torch.profiler (the collectives' share of it); (b) the
   production tile z-sharded over 2 ranks: the forward against the
   unsharded one (bf16 2e-2) and one spatial step's loss (1e-3) and
   gradients (2e-2 of each leaf's largest) against the unsharded step's;
   (c) 3 steps of the w24 GradICON in bf16 from the shipped weights, one
   pair a rank, against rank 0's unsharded steps (the first loss 1e-3,
   the first gradients 2e-2); (d) sharded inference of 5 tiles against
   the unsharded forward (2e-2); (e) phase 10's two knees through
   `BatchKneePipeline(mesh=...)` (network + 20 fine-tuning, bf16 warp):
   every rank returns both knees, each knee's meshes within phase 8's
   tolerances of phase 10 (b), each rank's launches equal to those of an
   unsharded `run_batch` of its own knees; (f) `CohortRunner` in every
   rank with the group up and no `host`, on 2 small knees a rank: each
   done once, every rank took some. One `phase sharding` JSON line
   carries the numbers per rank, beside the card, its power limit, the
   device count and the backend;
14. kmeans backends: `ops.clustering.kmeans_many` on the host (numpy, the
   default) and on the card (`backend="device"`): (a) phase 4's knee's
   split problems (its smoothed FC and TC meshes: 3 FC x-bands at d = 9,
   TC at d = 6), (b) phase 10's two knees' problems repeated to the B = 8
   set (32 problems); each problem's labels agree at least 99 % up to a
   permutation and each mesh's inner and outer face counts are within 0.5
   % of the host's; the host seconds and the device's end to end (upload,
   solve, copy back, the card synchronised), each the median of 3; (c)
   `KneePipeline.run` on phase 4's knee with `OAI_TPU_KMEANS_BACKEND=device`
   (then restored): its meshes within phase 8's tolerances of phase 4's,
   its launches equal to phase 4's (the device k-means launches no kernel
   of its own), and the thickness substages on its maps with each
   backend; (d) phases 4 and 14 once more with both TF32 switches on
   (`allow_tf32 = True`, `set_float32_matmul_precision("high")`):
   `GradICON.both_maps` on the knee and the atlas, the warp's upsampled
   field, the device k-means labels and centres of (a)'s problems and the
   knee's warped maps equal bit for bit to the same with the switches off,
   and the switches still as set after the port's products. Phase 11
   trained phase 4's segmenter in place, so this phase
   builds phase 4's pipeline afresh and holds its knee against phase 4's
   first. One `phase kmeans` JSON line carries the numbers beside the
   card and its power limit.

Before the last line it prints one JSON object `{"kernels": [...]}` (per
kernel and conv route: launches on the reported run, max error against the
plain version, kernel / plain / library milliseconds and the bound; sm90,
sm90n, cin1, cinsmall, f32 and distance rows add the replaced build's
milliseconds, sm90 and sm90n rows the loads-only build's, the cin1 row the
stores-only build's; the `:bn` rows count the launches of phase 8 (d), the
`:b16` rows those of phase 10 (b), phase 2's sm90n row those of phase 11
(d), its cinsmall row those of phase 11 (c), the `:train.` and `:dgrad`
rows those of phase 11; `launches_by_path.sharded_knee_batch` sums the
ranks' launches in phase 13 (e)), then the card line.
The last line is `{"ok": true, "device": {...}}`. Without a CUDA card it
exits with code 1 and prints no result. It imports nothing of JAX.
"""

import functools
import json
import math
import os
import subprocess
import sys
import time
import types

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
TILE = (16, 32, 128, 128)  # one step of the knee batch: 8 tiles x 2 knees
# segment-UNet convs at the knee batch's tiles: the two widest
# full-resolution ones, two lower levels, enc0a
BATCH_CONVS = [
    ("enc0b:b16", TILE, 32, 64), ("dec2a:b16", TILE, 192, 64), ("enc1b:b16", (16, 16, 64, 64), 128, 128),
    ("enc3b:b16", (16, 4, 16, 16), 512, 512), ("enc0a:b16", TILE, 1, 32),
]
REG_GRID = (48, 96, 96)  # the registration grid; the finest stage (scale 1) runs on it
REG_WIDTH = 24  # the shipped GradICON's stage width (oai_analysis_2_tpu/weights/gradicon.npz)
DIST_SHAPE = (32_500, 65_000)  # points x triangles, production mesh sizes
# the bf16 GradICON trainer's enc0a forward (the two images in, Cin 2), the
# cinsmall kernel's shape on the main path: (name, x shape, Cin, Cout)
CINSMALL_CONV = ("gradicon.stage2.enc0a", (1,) + REG_GRID, 2, REG_WIDTH)
CONV_SOURCES = {"sm90": "oai_analysis_2_tpu_torch/csrc/conv3d_sm90.cu",
                "sm90n": "oai_analysis_2_tpu_torch/csrc/conv3d_sm90n.cu",
                "cin1": "oai_analysis_2_tpu_torch/csrc/conv3d_cin1.cu",
                "cinsmall": "oai_analysis_2_tpu_torch/csrc/conv3d_cinsmall.cu",
                "wmma": "oai_analysis_2_tpu_torch/csrc/conv3d.cu",
                "f32": "oai_analysis_2_tpu_torch/csrc/conv3d_f32.cu"}


def log(*args):
    print(*args, flush=True)


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
    from oai_analysis_2_tpu_torch import native

    cuda_conv.reset_launches()
    cuda_kernels.point_triangle_min_d2.launches = 0
    native.reset_calls()


def read_launches(cuda_conv, cuda_kernels) -> dict:
    """The kernels' launches and the host-geometry library's calls
    (`native_<binding>`) since `reset_launches`."""
    from oai_analysis_2_tpu_torch import native

    return {
        **{f"native_{name}": n for name, n in native.read_calls().items()},
        "conv3d_sm90": cuda_conv.conv3d.launches_sm90,
        "conv3d_sm90n": cuda_conv.conv3d.launches_sm90n,
        "conv3d_cin1": cuda_conv.conv3d.launches_cin1,
        "conv3d_cinsmall": cuda_conv.conv3d.launches_cinsmall,
        "conv3d_wmma": cuda_conv.conv3d.launches_wmma,
        "conv3d_f32": cuda_conv.conv3d.launches_f32,
        "point_triangle": cuda_kernels.point_triangle_min_d2.launches,
    }


# the host-geometry library's calls a knee's thickness stage makes: the
# component filter once a tissue, one smoothing table (adjacency and fill)
# for the knee's FC + TC union; the port never asks for the bare edge list
NATIVE_CALLS = {"native_connected_components": 2, "native_smooth_adjacency": 1, "native_fill_table": 1,
                "native_mesh_edges": 0}


def check_native(launches, knees, what):
    """The thickness stage of `knees` knees went through `native`, exactly
    as `NATIVE_CALLS` counts a knee."""
    got = {k: v for k, v in launches.items() if k.startswith("native_")}
    want = {k: knees * v for k, v in NATIVE_CALLS.items()}
    if got != want:
        raise AssertionError(f"{what}: host-geometry library calls {got}, want {want}")


def check_bf16_routes(launches, what):
    """Each UNet forward runs 14 bf16 convs, enc0a's alone on the cin1
    route; no serving conv reaches the wmma build or the sm90n and cinsmall
    kernels (those serve the trainers' narrow convs)."""
    if launches["conv3d_sm90"] != 13 * launches["conv3d_cin1"] or launches["conv3d_wmma"] != 0 \
            or launches["conv3d_sm90n"] != 0 or launches["conv3d_cinsmall"] != 0:
        raise AssertionError(f"{what}: sm90 route took {launches['conv3d_sm90']} bf16 conv launches, want 13 per "
                             f"enc0a launch ({launches['conv3d_cin1']}); wmma took {launches['conv3d_wmma']}, "
                             f"sm90n {launches['conv3d_sm90n']}, cinsmall {launches['conv3d_cinsmall']}, want 0")


def unet_convs(spec, shape, prefix):
    """(name, x shape without channels, Cin, Cout) of every 3x3x3 conv of a
    UNet spec whose input is `shape` (B, D, H, W): a conv of encoder level
    l, or of the decoder level whose skip comes from l, runs on the input
    halved l times (maxpool floors odd sizes)."""
    from oai_analysis_2_tpu_torch.models.unet3d import param_shapes

    convs = []
    for name, leaves in param_shapes(spec).items():
        kshape = leaves["kernel"]
        if kshape[:3] != (3, 3, 3):
            continue
        li = int(name[3])
        level = li if name.startswith("enc") else len(spec.enc) - 2 - li
        convs.append((f"{prefix}{name}", shape[:1] + tuple(g >> level for g in shape[1:]), kshape[3], kshape[4]))
    return convs


def gradicon_convs(width=REG_WIDTH, grid=REG_GRID):
    """(name, x shape without channels, Cin, Cout) of every 3x3x3 conv of the
    finest GradICON stage, from the port's stage spec (`unet_convs`)."""
    from oai_analysis_2_tpu_torch.models.gradicon import _stage_spec

    return unet_convs(_stage_spec(width), (1,) + tuple(grid), "stage2.")


def conv_bounds(voxels, cin, cout, esize, out_size, bias=True):
    """(bound ms, bound_by) of one SAME 3x3x3 conv: operations over the
    type's peak against bytes (x, weights, bias, output once) over HBM."""
    flops = 2.0 * 27 * cin * cout * voxels
    nbytes = voxels * cin * esize + 27 * cin * cout * esize + (cout * 4 if bias else 0) + voxels * cout * out_size
    peak = BF16_FLOPS if esize == 2 else F32_FLOPS
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def conv_case(torch, F, cuda_conv, name, shape, cin, cout, dtype, tol, reps, clock=False, bn=False, others=True,
              dgrad=False):
    """One conv shape: kernel vs plain version, times and bound. `bn`: the
    batch-norm UNet's route (no ReLU, f32 output: BN runs after the conv).
    `dgrad`: a data gradient, the conv of an output gradient (Cin) with a
    flipped kernel (Cout), without bias and ReLU. `others`: also time the
    other builds at this shape."""
    route = cuda_conv.conv3d_route(cin, cout, dtype)
    relu = not bn and not dgrad
    out_dtype = torch.float32 if bn else dtype  # the output type the path takes
    gen = torch.Generator(device="cuda").manual_seed(len(name) * 1000 + cin)
    x = torch.randn(shape + (cin,), device="cuda", generator=gen).to(dtype)
    k = (torch.randn((3, 3, 3, cin, cout), device="cuda", generator=gen) / (27 * cin) ** 0.5).to(dtype)
    b = None if dgrad else torch.randn((cout,), device="cuda", generator=gen) * 0.1
    want = cuda_conv.conv3d_reference(x, k, b, relu=relu, out_dtype=torch.float32)
    # f32 output: the kernel's f32 accumulator and epilogue, held at 1e-4
    # where K is short (cin1: 27 products, cinsmall: 27 Cin) or the operands
    # are f32
    f32_tol = 1e-4 if route in ("cin1", "cinsmall", "f32") else tol
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
    b_lib = None if b is None else b.to(dtype)
    library_ms = time_ms(torch, lambda: F.conv3d(x_cl, w_cl, b_lib, padding=1), reps)
    voxels = int(np.prod(shape))
    flops = 2.0 * 27 * cin * cout * voxels
    bound_ms, bound_by = conv_bounds(voxels, cin, cout, x.element_size(), torch.finfo(out_dtype).bits // 8,
                                     bias=b is not None)
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
    if route == "sm90" and not bn and others:
        # uncounted launches of other builds at the same shape: the wmma
        # kernel, which ran every bf16 conv before the sm90 route, and the
        # sm90 kernel's load pipeline alone (no wgmma, no stores)
        extra = {
            "was_ms": time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="wmma", relu=True,
                                                               out_dtype=dtype), reps),
            "loads_ms": time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="sm90", relu=True,
                                                                 out_dtype=dtype, loads_only=True), reps),
        }
    if route == "sm90n" and not bn and others:
        # uncounted launches at the same shape: the wmma build, which ran
        # these convs before the sm90n route, and the sm90n kernel's load
        # pipeline alone (no wgmma, no stores)
        extra = {
            "was_ms": time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="wmma", relu=relu,
                                                               out_dtype=dtype), reps),
            "loads_ms": time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="sm90n", relu=relu,
                                                                 out_dtype=dtype, loads_only=True), reps),
        }
    if route == "cin1" and not bn and others:
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
    if route == "cinsmall" and others:
        # uncounted launches at the same shape: the wmma build, which ran
        # this conv before the cinsmall route, and the kernel's C call alone
        # (weights laid out once, none of the wrapper's checks): its time
        # between CUDA events, and its device time under torch.profiler
        # (both the kernel's own where the wrapper's host time exceeds it)
        from oai_analysis_2_tpu_torch.ops.cuda_build import load_library

        fn = load_library("conv3d_cinsmall").conv3d_cinsmall  # argtypes set by the launches above
        wt, out = cuda_conv.cinsmall_weights(k), torch.empty(shape + (cout,), dtype=out_dtype, device="cuda")
        args = [x.data_ptr(), wt.data_ptr(), b.data_ptr(), out.data_ptr(), *shape, cin, cout, int(relu),
                int(out_dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream]
        call_ms = time_ms(torch, lambda: fn(*args), reps)
        if fn(*args) != 0:
            raise AssertionError("conv3d_cinsmall: the C call failed")
        # the kernel's own device time: `reps` C calls under torch.profiler
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        device_ms = sum(us for n, us in device_spans(prof)[2].items() if "conv3d_cinsmall_kernel" in n) / reps / 1e3
        if not device_ms > 0:
            raise AssertionError("conv3d_cinsmall: the profiler saw no device time in its kernel")
        check_close(f"conv3d {name} (C call)", out, cuda_conv.conv3d(x, k, b, relu=relu, out_dtype=out_dtype), 0, 0)
        extra = {"was_ms": time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="wmma", relu=relu,
                                                                    out_dtype=dtype), reps),
                 "call_ms": call_ms, "device_ms": device_ms}
        del wt, out
    del x, k, b, x_cl, w_cl
    torch.cuda.empty_cache()
    return {
        "name": f"conv3d_{route}:{name}" + (":bn" if bn else ""),
        "route": "cuda",
        "source": CONV_SOURCES[route],
        "replaces": "oai_analysis_2_tpu/ops/pallas_conv.py:100",
        "shape": (f"dy {list(shape) + [cin]} -> Cin {cout}, a data gradient (flipped kernel, no bias, no ReLU)"
                  if dgrad else f"x {list(shape) + [cin]} -> Cout {cout}"
                  + (", no ReLU, f32 out (BN route)" if bn else "")),
        "launches": None,
        "max_abs_err": err,
        "tol": {"atol": tol, "rtol": tol},
        **({} if out_dtype == torch.float32 else {"max_abs_err_f32_out": err_f32, "tol_f32_out": f32_tol}),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
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


# the bench fixture (shell_probmap / knee_and_atlas / FULL) lives in the
# port's bench module, `oai_analysis_2_tpu_torch/bench.py`; SMALL is a
# 48x96x96 knee of it
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
    from oai_analysis_2_tpu_torch.bench import knee_and_atlas
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


def native_check(maps) -> dict:
    """Phase 4: the host-geometry library against its plain versions on the
    full-size knee's meshes. Per tissue, on the marching-cubes mesh, the
    union-find components against scipy's (the same partition); on the
    filtered meshes and on their union (what the smoothing takes) the CSR
    adjacency against the plain edge list (equal degrees, each row the
    vertex's neighbour set, ascending) and the table against the plain
    table of the CSR-ordered edge list (equal). Each side timed on the
    host. Fatal on any difference."""
    from oai_analysis_2_tpu_torch.mesh import components
    from oai_analysis_2_tpu_torch.mesh import ops as mops
    from oai_analysis_2_tpu_torch.mesh.marching_cubes import marching_cubes_multi
    from oai_analysis_2_tpu_torch.mesh.processing import _as_xyz, _spacing
    from oai_analysis_2_tpu_torch.mesh.types import Mesh

    def timed(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    raws = marching_cubes_multi([_as_xyz(m) for m in maps], 0.5, _spacing(maps[0]))
    out, filtered = {}, []
    for name, raw in zip(("fc", "tc"), raws):
        uf, uf_s = timed(lambda: components._union_find_labels(raw.n_points, raw.faces))
        sp, sp_s = timed(lambda: components.scipy_component_labels(raw.n_points, raw.faces))
        n_uf, n_sp = len(np.unique(uf)), len(np.unique(sp))
        if not len(np.unique(np.stack([uf, sp], 1), axis=0)) == n_uf == n_sp:
            raise AssertionError(f"native components of the {name} mesh: {n_uf} components, scipy {n_sp}, "
                                 "not the same partition")
        filtered.append(components.filter_small_components(raw, 3000))
        out[name] = {"raw_points": raw.n_points, "components": n_uf, "components_native_s": uf_s,
                     "components_scipy_s": sp_s}
    offset = filtered[0].n_points
    both = Mesh(np.concatenate([m.vertices for m in filtered]),
                np.concatenate([filtered[0].faces, filtered[1].faces + offset]).astype(np.int32))
    for name, mesh in (("fc", filtered[0]), ("tc", filtered[1]), ("union", both)):
        (deg, nbr), csr_s = timed(lambda: mops._csr_adjacency(mesh))
        nv = mesh.n_points + 1
        tbl, fill_s = timed(lambda: mops._table_from_csr(deg, nbr, nv, mops._table_width(deg.max()), nv - 1))
        (src, dst, pdeg), adj_s = timed(lambda: mops._adjacency(mesh))
        order = np.lexsort((dst, src))
        plain, table_s = timed(lambda: mops._neighbor_table(src[order], dst[order], nv, nv - 1))
        if not np.array_equal(deg, pdeg.astype(np.int64)) or not np.array_equal(nbr, dst[order]):
            raise AssertionError(f"native adjacency of the {name} mesh: degrees or neighbour sets differ from the "
                                 "plain version's")
        if tbl.shape != plain.shape or not np.array_equal(tbl, plain):
            raise AssertionError(f"native table of the {name} mesh differs from the plain CSR-ordered table")
        out.setdefault(name, {}).update(points=mesh.n_points, faces=mesh.n_cells, table_k=int(tbl.shape[1]),
                                        adjacency_native_s=csr_s, table_native_s=fill_s, adjacency_plain_s=adj_s,
                                        table_plain_s=table_s)
    return out


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
    families = {"conv3d_sm90": "conv3d_sm90_kernel", "conv3d_sm90n": "conv3d_sm90n_kernel",
                "conv3d_cin1": "conv3d_cin1_kernel", "conv3d_cin1_was": "conv3d_bf16_kernel",
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
    from oai_analysis_2_tpu_torch.bench import knee_and_atlas
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
    check_native(launches, 1, f"({name}) knee")
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
CLI_LAUNCHES = {"conv3d_sm90": 65, "conv3d_sm90n": 0, "conv3d_cin1": 5, "conv3d_cinsmall": 0, "conv3d_wmma": 0,
                "conv3d_f32": 60, "point_triangle": 4, **NATIVE_CALLS}


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
    if any(mapper_launches[k] for k in ("conv3d_sm90", "conv3d_sm90n", "conv3d_cin1", "conv3d_cinsmall",
                                        "conv3d_wmma", "conv3d_f32")):
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
    if (bn_launches["conv3d_sm90"], bn_launches["conv3d_cin1"], bn_launches["conv3d_wmma"],
            bn_launches["conv3d_sm90n"]) != (65, 5, 0, 0):
        raise AssertionError(f"BN segment launches {bn_launches}, want 65 sm90, 5 cin1, no wmma, no sm90n")
    err = max(float((g.data - w.data).abs().max()) for g, w in zip(got, want))
    if not err <= 1e-3 or not all(bool(g.data.isfinite().all()) for g in got):
        raise AssertionError(f"identity-BN segment differs from the fused route by {err} (> 1e-3)")
    out["bn_segment"] = {"segment_s": bn_s, "max_abs_err": err, "tol": 1e-3, "launches": bn_launches,
                         "profiled": {name: profile_segment(torch, seg, pre)
                                      for name, seg in (("bn", seg_bn), ("fused", obj.segmenter))}}
    return out

def run_child(cmd, timeout) -> str:
    """Run `cmd` from the checkout's root in its own session and return its
    standard output; on a time-out the whole session is killed, so no
    process it started outlives this call. Raises if it fails."""
    import signal

    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)), start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{' '.join(cmd[1:])} did not finish in {timeout} s") from None
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited {proc.returncode}:\n{err[-6000:]}")
    return out


def last_json(out: str, key: str) -> dict:
    """The last line of `out` that is a JSON object holding `key`."""
    for line in reversed(out.strip().splitlines()):
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and key in obj:
            return obj
    raise AssertionError(f"no JSON line with {key!r} in:\n{out[-3000:]}")


def shard_records(manifest) -> list:
    return [json.loads(line) for shard in sorted(manifest.parent.glob(manifest.name + ".h*.jsonl"))
            for line in shard.read_text().splitlines() if line.strip()]


def cohort_from_disk(torch, cuda_conv, cuda_kernels, cli_ref) -> dict:
    """Phase 9: phase 8's knee as a zarr store (read from the directory and
    over a loopback HTTP server), a directory of three copies of it through
    the CLI's `cohort` command, the command once more (resumed: nothing
    runs), and the `bench` and `prewarm` commands in subprocesses. `cli_ref`
    is phase 8 (b)'s CLI knee (its meshes read back, its stage seconds)."""
    import http.server
    import shutil
    import threading
    from functools import partial
    from pathlib import Path

    from oai_analysis_2_tpu_torch import __main__ as cli
    from oai_analysis_2_tpu_torch.core.nifti import read_nifti
    from oai_analysis_2_tpu_torch.engine.stages import readimage
    from oai_analysis_2_tpu_torch.mesh.types import Mesh
    from oai_analysis_2_tpu_torch.parallel.cohort import CohortManifest
    from oai_analysis_2_tpu_torch.utils.zarr_io import write_zarr_volume

    here = Path(__file__).resolve().parent
    knee_path = here / "build" / "release_smoke" / "knee.nii.gz"
    root = here / "build" / "cohort_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {}

    # (a) the knee as a zarr store (zlib chunks), read from the directory
    # and over HTTP: exactly the NIfTI read's voxels and metadata
    nii = read_nifti(knee_path, device="cuda")
    t0 = time.perf_counter()
    write_zarr_volume(nii, root / "knee.zarr")
    out["zarr"] = {"write_s": time.perf_counter() - t0,
                   "store_mb": sum(f.stat().st_size for f in (root / "knee.zarr").rglob("*") if f.is_file()) / 1e6}

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), partial(Quiet, directory=str(root)))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        for name, src in (("directory", root / "knee.zarr"),
                          ("http", f"http://127.0.0.1:{httpd.server_address[1]}/knee.zarr")):
            t0 = time.perf_counter()
            img = readimage(src, device="cuda")
            torch.cuda.synchronize()
            out["zarr"][f"{name}_read_s"] = time.perf_counter() - t0
            for k in ("data", "origin", "spacing", "direction"):
                a, b = getattr(img, k), getattr(nii, k)
                if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                    raise AssertionError(f"zarr read ({name}): {k} differs from the NIfTI read")
            del img
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    del nii

    # (b) three copies of the knee through the CLI's cohort command
    knees = root / "knees"
    knees.mkdir()
    for i in range(3):
        shutil.copyfile(knee_path, knees / f"knee{i}.nii.gz")
    out_dir = root / "out"
    manifest = out_dir / "manifest.json"
    reset_launches(cuda_conv, cuda_kernels)
    t0 = time.perf_counter()
    summary = cli.main(["cohort", str(knees), "-o", str(out_dir)])
    torch.cuda.synchronize()
    command_s = time.perf_counter() - t0
    launches = read_launches(cuda_conv, cuda_kernels)
    want = {k: 3 * v for k, v in CLI_LAUNCHES.items()}
    records = shard_records(manifest)
    bad = [r for r in records if r["status"] in ("failed", "retry")]
    if summary != {"done": 3} or bad:
        raise AssertionError(f"cohort summary {summary}; failed or retried records: {bad}")
    if launches != want:
        raise AssertionError(f"cohort launches {launches}, want {want}")
    items = CohortManifest.open(manifest, host=0).items
    run_summary = json.loads((out_dir / "manifest.json.summary.json").read_text())
    per_knee, accounted = {}, 0.0
    for i in range(3):
        rec = items[f"knee{i}.nii.gz"]
        meta = rec["result"]
        stages = {k: v["seconds"] for k, v in meta["timings"].items()}
        meshes = {}
        for tissue in ("FC", "TC"):
            for side in ("inner", "outer"):
                key = f"{tissue.lower()}_{side}"
                mesh = Mesh.load_vtk(out_dir / f"knee{i}_{tissue}_{side}.vtk")
                n, n_ref = mesh.n_points, cli_ref["meshes"][key]["points"]
                if mesh.point_data is None or not np.isfinite(mesh.point_data).all():
                    raise AssertionError(f"cohort knee{i} {key}: thickness missing or non-finite")
                mean, mean_ref = float(mesh.point_data.mean()), cli_ref["meshes"][key]["thickness_mean_mm"]
                if abs(n - n_ref) > 0.005 * n_ref or abs(mean - mean_ref) > 0.01 * abs(mean_ref):
                    raise AssertionError(f"cohort knee{i} {key}: {n} points, mean {mean} mm; phase 8 (b) had "
                                         f"{n_ref}, {mean_ref} mm")
                meshes[key] = {"points": n, "thickness_mean_mm": mean}
        per_knee[f"knee{i}"] = {"seconds": rec["seconds"], "decode_seconds": meta["decode_seconds"],
                                "read_seconds": meta["read_seconds"], "stage_seconds": stages,
                                "write_seconds": meta["write_seconds"], "meshes": meshes}
        accounted += meta["decode_seconds"] + meta["read_seconds"] + sum(stages.values()) + meta["write_seconds"]
    wall = run_summary["wall_seconds"]
    out["cohort"] = {
        "command_s": command_s, "runner_wall_s": wall, "items_per_hour": run_summary["items_per_hour"],
        "mean_item_seconds": run_summary["mean_item_seconds"], "launches": launches, "knees": per_knee,
        # a lower bound on the read time the prefetch hid: each knee's decode
        # (on the prefetch thread), copy to the card, stages and writes,
        # summed, less the runner's wall time, which also holds the claim
        # probes, the manifest appends and the summary
        "accounted_s": accounted, "hidden_read_s": accounted - wall,
        "phase8_cli_stage_seconds": cli_ref["stage_seconds"],
    }

    # the same command again: every knee is done, nothing runs
    reset_launches(cuda_conv, cuda_kernels)
    t0 = time.perf_counter()
    again = cli.main(["cohort", str(knees), "-o", str(out_dir)])
    torch.cuda.synchronize()
    resumed = read_launches(cuda_conv, cuda_kernels)
    if again != {"done": 3} or any(resumed.values()) or len(shard_records(manifest)) != len(records):
        raise AssertionError(f"the resumed cohort ran again: summary {again}, launches {resumed}")
    out["cohort"]["resumed_command_s"] = time.perf_counter() - t0

    # (c) the bench and prewarm commands, each in a fresh process (bench's
    # fresh-process probe is what prewarm pays for)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench = last_json(run_child([sys.executable, "-m", "oai_analysis_2_tpu_torch", "bench"], 900), "metric")
    out["bench_command_s"] = time.perf_counter() - t0
    fc_med = bench.get("fc_thickness_median_mm")
    fresh = bench.get("warmup_seconds_fresh_process")
    if not (bench.get("value") or 0) > 0 or fc_med is None or not 0.2 < fc_med < 10.0:
        raise AssertionError(f"bench line implausible: {bench}")
    if not isinstance(fresh, (int, float)) or not math.isfinite(fresh) or fresh <= 0:
        raise AssertionError(f"bench's fresh-process probe gave no time: {fresh!r}")
    bad = [k for k in BENCH_BATCH_KEYS
           if not isinstance(bench.get(k), (int, float)) or not math.isfinite(bench[k]) or not bench[k] > 0]
    if bad or any(k.startswith("projected") for k in bench):
        raise AssertionError(f"bench line: batched keys missing, not finite or not positive: {bad}")
    # its three timed knees' thickness stages went through the host-geometry library
    want = {k[len("native_"):]: 3 * v for k, v in NATIVE_CALLS.items()}
    if bench.get("native_calls_3_knees") != want:
        raise AssertionError(f"bench line: host-geometry library calls {bench.get('native_calls_3_knees')}, "
                             f"want {want}")
    out["bench"] = bench
    t0 = time.perf_counter()
    report = last_json(run_child([sys.executable, "-m", "oai_analysis_2_tpu_torch", "prewarm",
                                  "--shape", "48,96,96"], 600), "prewarm_seconds")
    out["prewarm_command_s"] = time.perf_counter() - t0
    from oai_analysis_2_tpu_torch.ops import cuda_build

    # every kernel library and the host-geometry library
    if report.get("compile_cache_entries_after") != len(cuda_build.EXTRA_FLAGS) + 1 or \
            not (report.get("first_knee_seconds") or 0) > 0:
        raise AssertionError(f"prewarm report: want {len(cuda_build.EXTRA_FLAGS)} kernel libraries and the "
                             f"host-geometry library after and a first knee that took time, got {report}")
    out["prewarm"] = report
    return out


# phase 9 (c): the bench line's batched keys
BENCH_BATCH_KEYS = (
    "batch2_seconds_per_knee", "batch_efficiency_vs_single", "batch8_seconds_total", "batch8_device_seconds",
    "batch8_thickness_seconds", "batch8_thickness_smooth_seconds", "batch8_thickness_distance_seconds",
    "batch8_thickness_mc_seconds", "batch4_seconds_total", "batch4_pipelined_seconds_per_batch",
    "batch_overlap_gain", "segment_seconds_reference_tiling", "seconds_per_knee_reference_tiling",
    "batch2_peak_memory_gb", "batch8_peak_memory_gb", "batch4_peak_memory_gb", "reference_tiling_peak_memory_gb",
)
# phase 10 (b): the batched path's launches on two knees: 20 steps of 16
# tiles through the 14 bf16 convs (enc0a on cin1), the network's 60 f32
# convs a knee, 2 tissues x 2 directions of the distance a knee
BATCH_LAUNCHES = {"conv3d_sm90": 2 * 130, "conv3d_sm90n": 0, "conv3d_cin1": 2 * 10, "conv3d_cinsmall": 0,
                  **{k: 2 * v for k, v in NATIVE_CALLS.items()}, "conv3d_wmma": 0,
                  "conv3d_f32": 2 * 60, "point_triangle": 8}


# phase 10's second knee: the bench fixture with both shells moved a few
# voxels (and noise seed 1)
SECOND_KNEE_SHELLS = dict(fc=(47.5, 52.5, (84, 205, 198)), tc=(31.5, 35.5, (76, 236, 186)))


def check_meshes_close(got: dict, ref: dict, size_tol: float, mean_tol: float, what: str) -> None:
    """Each mesh's size and mean thickness in `got` (a `summarize` dict)
    within `size_tol` and `mean_tol` (relative) of `ref`'s."""
    for key, n_ref in ref["points"].items():
        n = got["points"][key]
        mean, mean_ref = got[f"{key}_thickness_mean_mm"], ref[f"{key}_thickness_mean_mm"]
        if abs(n - n_ref) > size_tol * n_ref or abs(mean - mean_ref) > mean_tol * abs(mean_ref):
            raise AssertionError(f"{what} {key}: {n} points, mean {mean} mm; want {n_ref}, {mean_ref} mm")


def probmap_gap(a, b) -> dict:
    d = (a.float() - b.float()).abs()
    return {"max": float(d.max()), "mean": float(d.mean()), "share_over_0.05": float((d > 0.05).float().mean())}


def knee_batch(torch, cuda_conv, cuda_kernels, pipe, knee) -> dict:
    """Phase 10: two distinct full-size knees through the knee-batched path
    (`parallel/batch.py`), sharing phase 4's segmenter (batch 8) and atlas."""
    import shutil
    from pathlib import Path

    from oai_analysis_2_tpu_torch.bench import FULL, knee_and_atlas
    from oai_analysis_2_tpu_torch.core.image import image_from_array
    from oai_analysis_2_tpu_torch.engine.pipeline import KneePipeline
    from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise
    from oai_analysis_2_tpu_torch.mesh.components import filter_small_components
    from oai_analysis_2_tpu_torch.mesh.ops import distance_to_surface, smooth_meshes
    from oai_analysis_2_tpu_torch.mesh.processing import get_mesh_from_probability_map, get_thickness_meshes
    from oai_analysis_2_tpu_torch.mesh.split import split_meshes
    from oai_analysis_2_tpu_torch.ops.intensity import percentile_window
    from oai_analysis_2_tpu_torch.parallel import BatchKneePipeline, CohortRunner

    out = {}
    knees = [knee, image_from_array(knee_and_atlas(**dict(FULL, **SECOND_KNEE_SHELLS), seed=1)[0],
                                    spacing=(0.36, 0.36, 0.7), device="cuda")]

    # (a) the pair, each knee alone and the swapped pair through the
    # segmenter at the training tiling, which all three passes share
    t0 = time.perf_counter()
    seg = Segmenter3DInPatchClassWise(mode="pred", config={**pipe.segmenter.config, "inference_patch_size": "train"})
    seg.pred_setup()
    shape, bs = knee.shape, int(seg.config.get("batch_size", 4))
    pre = [percentile_window(k, 0.1, 99.9, 0.0, 1.0).data for k in knees]
    pair_fn = seg.volume_fn_batched(2, shape, bs, threshold=False)
    alone_fn = seg.volume_fn_batched(1, shape, bs, threshold=False)
    reset_launches(cuda_conv, cuda_kernels)
    pair = pair_fn(torch.stack(pre))
    torch.cuda.synchronize()
    pair_launches = read_launches(cuda_conv, cuda_kernels)
    swapped = pair_fn(torch.stack(pre[::-1]))
    errs = {}
    for i in range(2):
        alone = alone_fn(pre[i][None])[0]
        errs[f"knee{i}_pair_vs_alone"] = float((pair[i] - alone).abs().max())
        errs[f"knee{i}_swapped_vs_pair"] = float((swapped[1 - i] - pair[i]).abs().max())
    distinct = float((pair[0] - pair[1]).abs().max())
    finite = bool(pair.isfinite().all()) and bool(swapped.isfinite().all())
    if not finite or not distinct > 0.5 or not all(e <= 1e-3 for e in errs.values()):
        raise AssertionError(f"batch integrity: pair vs alone / swapped max abs err {errs} (tol 1e-3), the knees' "
                             f"maps differ by {distinct}, finite {finite}")
    check_bf16_routes(pair_launches, "(a) the pair's segment")
    out["integrity"] = {"tiles_a_knee": seg.partition.num_tiles(shape), "tile": list(seg.partition.tile_size),
                        "pair_launches": pair_launches, "max_abs_err": errs, "tol": 1e-3,
                        "bit_equal": all(e == 0.0 for e in errs.values()), "knees_differ_by": distinct,
                        "seconds": time.perf_counter() - t0}
    del pair, swapped, alone, pre
    torch.cuda.empty_cache()

    # (b) run_batch on the pair, twice; the second run is reported
    bpipe = BatchKneePipeline(pipe.segmenter, pipe.atlas, registration_mode="network", finetune_steps=20,
                              warp_dtype="bfloat16", device="cuda")
    t0 = time.perf_counter()
    first = bpipe.run_batch(knees)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches(cuda_conv, cuda_kernels)
    t0 = time.perf_counter()
    results = bpipe.run_batch(knees)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(cuda_conv, cuda_kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != BATCH_LAUNCHES:
        raise AssertionError(f"run_batch launches {launches}, want {BATCH_LAUNCHES}")
    single = KneePipeline(pipe.segmenter, pipe.atlas, registration_mode="network", finetune_steps=20,
                          warp_dtype="bfloat16", device="cuda")
    refs, got = [], []
    for i, (k, r) in enumerate(zip(knees, results)):
        for name in ("fc_probmap", "tc_probmap"):
            data = getattr(r, name).data
            if tuple(data.shape) != pipe.atlas.shape or not bool(data.isfinite().all()) or \
                    not (float(data.min()) >= 0.0 and 0.5 < float(data.max()) <= 1.0):
                raise AssertionError(f"run_batch knee{i} {name}: shape {tuple(data.shape)}, out of range or no tissue")
        got.append(summarize(r))
        refs.append(summarize(single.run(k)))
        check_meshes_close(got[i], refs[i], 0.005, 0.01, f"run_batch knee{i} against KneePipeline.run:")
        if not 0.2 < got[i]["fc_inner_thickness_median_mm"] < 10.0:
            raise AssertionError(f"run_batch knee{i}: implausible FC median {got[i]['fc_inner_thickness_median_mm']}")
    timings = {k: v["seconds"] for k, v in results[0].timings.items()}
    out["run_batch"] = {
        "first_run_s": first_s, "batch_seconds": wall, "seconds_a_knee": wall / 2, "stage_seconds": timings,
        "launches": launches, "max_memory_allocated_gb": peak_gb, "knees": got, "single_knees": refs,
        # the two runs of one batch: the fine-tuning's gradient scatter-adds
        # sum in the card's order of arrival
        "rerun_gap": [probmap_gap(a.fc_probmap.data, b.fc_probmap.data) for a, b in zip(first, results)],
    }
    del first

    # (c) run_batches over the pair twice: each batch as (b)'s (maps: mean
    # gap <= 1e-3 and at most 0.5 % of voxels off by more than 0.05, the JAX
    # package's batch criterion, tests/test_batch_pipeline.py:79; meshes
    # within phase 8's tolerances)
    t0 = time.perf_counter()
    batches = bpipe.run_batches([knees, knees])
    torch.cuda.synchronize()
    pipelined = time.perf_counter() - t0
    gaps = []
    for bi, res in enumerate(batches):
        for i, r in enumerate(res):
            for name in ("fc_probmap", "tc_probmap"):
                gap = probmap_gap(getattr(r, name).data, getattr(results[i], name).data)
                if not (gap["mean"] <= 1e-3 and gap["share_over_0.05"] <= 0.005):
                    raise AssertionError(f"run_batches batch {bi} knee{i} {name}: {gap} against run_batch")
                gaps.append(gap)
            check_meshes_close(summarize(r), got[i], 0.005, 0.01, f"run_batches batch {bi} knee{i}:")
    out["run_batches"] = {"seconds": pipelined, "seconds_a_batch": pipelined / 2, "run_batch_seconds": wall,
                          "overlap_gain": wall / (pipelined / 2), "max_map_gap": max(g["max"] for g in gaps),
                          "stage_seconds": [{k: v["seconds"] for k, v in res[0].timings.items()} for res in batches]}
    del batches

    # (d) the cohort runner with the batch pipeline: 4 knees, batches of 2
    root = Path(__file__).resolve().parent / "build" / "batch_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    calls = {"batch": 0, "single": 0}

    def batch_fn(images):
        calls["batch"] += 1
        return [{"fc_points": r.fc_inner.n_points, "tc_points": r.tc_inner.n_points,
                 "timings": r.timings} for r in bpipe.run_batch(images)]

    def single_fn(image):
        calls["single"] += 1
        raise AssertionError("the single-item pipeline ran")

    manifest = root / "manifest.json"
    runner = CohortRunner(single_fn, manifest, batch_pipeline=batch_fn, batch_size=2, verbose=False)
    reset_launches(cuda_conv, cuda_kernels)
    t0 = time.perf_counter()
    summary = runner.run([knees[0], knees[1], knees[0], knees[1]], keys=[f"knee{i}" for i in range(4)])
    torch.cuda.synchronize()
    cohort_s = time.perf_counter() - t0
    cohort_launches = read_launches(cuda_conv, cuda_kernels)
    bad = [r for r in shard_records(manifest) if r["status"] in ("failed", "retry")]
    if summary != {"done": 4} or bad or calls != {"batch": 2, "single": 0}:
        raise AssertionError(f"batch cohort: summary {summary}, calls {calls}, failed or retried records {bad}")
    if cohort_launches != {k: 2 * v for k, v in BATCH_LAUNCHES.items()}:
        raise AssertionError(f"batch cohort launches {cohort_launches}, want 2 x {BATCH_LAUNCHES}")
    run_summary = json.loads((root / "manifest.json.summary.json").read_text())
    out["cohort"] = {"seconds": cohort_s, "runner_wall_s": run_summary["wall_seconds"],
                     "items_per_hour": run_summary["items_per_hour"], "calls": calls, "launches": cohort_launches}

    # (e) marching tetrahedra on (b)'s first knee's warped maps
    maps = [results[0].fc_probmap, results[0].tc_probmap]
    iso = {}
    for name, img in zip(("fc", "tc"), maps):
        g = get_mesh_from_probability_map(img, method="tets")
        c = get_mesh_from_probability_map(img.to("cpu"), method="tets")
        if g.n_points == 0 or (g.n_points, g.n_cells) != (c.n_points, c.n_cells) or not np.array_equal(g.faces, c.faces):
            raise AssertionError(f"tets {name}: card {g.n_points} points {g.n_cells} faces, CPU {c.n_points} {c.n_cells}"
                                 " (or other faces)")
        err = float(np.abs(g.vertices - c.vertices).max())
        if not err <= 1e-5:
            raise AssertionError(f"tets {name}: card and CPU vertices differ by {err} mm (> 1e-5)")
        iso[name] = {"points": g.n_points, "cells": g.n_cells, "max_abs_err_mm": err}
    sub = {}
    t0 = time.perf_counter()
    thick = get_thickness_meshes(maps, ["FC", "TC"], method="tets", timings_out=sub)
    tets_s = time.perf_counter() - t0
    # the CPU's meshes up to the distance: components, smoothing, split
    raws = [filter_small_components(get_mesh_from_probability_map(m.to("cpu"), method="tets"), 3000) for m in maps]
    cpu_splits = split_meshes(smooth_meshes(raws, device="cpu"), ["FC", "TC"])
    split_err = 0.0
    for tissue, pair_g, pair_c in zip(("fc", "tc"), thick, cpu_splits):
        for side, g, c in zip(("inner", "outer"), pair_g, pair_c):
            if g.n_points == 0 or (g.n_points, g.n_cells) != (c.n_points, c.n_cells) or \
                    not np.array_equal(g.faces, c.faces):
                raise AssertionError(f"tets {tissue}_{side}: card {g.n_points} points {g.n_cells} faces, CPU "
                                     f"{c.n_points} {c.n_cells} (or other faces)")
            split_err = max(split_err, float(np.abs(g.vertices - c.vertices).max()))
    if not split_err <= 1e-5:
        raise AssertionError(f"tets: smoothed meshes on the card and the CPU differ by {split_err} mm (> 1e-5)")
    # the CPU's plain distance at every 100th vertex of each surface (all of
    # them would take minutes on the host): the card's thickness within 1e-3 mm
    t0 = time.perf_counter()
    thick_err, n_checked = 0.0, 0
    for pair_g, (c_in, c_out) in zip(thick, cpu_splits):
        for g, c, other in ((pair_g[0], c_in, c_out), (pair_g[1], c_out, c_in)):
            want = distance_to_surface(c.vertices[::100], other, device="cpu")
            thick_err = max(thick_err, float(np.abs(g.point_data[::100] - want).max()))
            n_checked += len(want)
    if not thick_err <= 1e-3:
        raise AssertionError(f"tets: card and CPU thickness differ by {thick_err} mm at {n_checked} points (> 1e-3)")
    cpu_distance_s = time.perf_counter() - t0
    tets = summarize(types.SimpleNamespace(fc_inner=thick[0][0], fc_outer=thick[0][1], tc_inner=thick[1][0],
                                           tc_outer=thick[1][1]))
    if not 0.2 < tets["fc_inner_thickness_median_mm"] < 10.0:
        raise AssertionError(f"tets: implausible FC median {tets['fc_inner_thickness_median_mm']}")
    out["tets"] = {"iso_surface": iso, "smoothed_max_abs_err_mm": split_err, "card_seconds": tets_s,
                   "thickness_max_abs_err_mm": thick_err, "thickness_points_checked": n_checked,
                   "cpu_distance_seconds": cpu_distance_s,
                   "substage_seconds": sub, **tets,
                   "mc_fc_inner_thickness_median_mm": got[0]["fc_inner_thickness_median_mm"]}
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


# ---- phase 11: training -------------------------------------------------------

TRAIN_TILE = (2, 32, 128, 128)  # the segmentation trainer's batch: 2 patches of 32x128x128
TRAIN_SMALL_LR = 1e-4  # (b): Adam's step, small so that sign-noise moves stay small
TRAIN_STEPS = 20  # (c)
SEG_TRAIN_STEPS = 5  # (d)
RECIPE_CUT = dict(steps_per_cycle=10, pool=8)  # (e): the uncut recipe is the tool's own run


def conv_train_case(torch, cuda_conv, name, shape, cin, cout, dtype, reps, dgrad=True):
    """One conv of a trainer under autograd: `Conv3dFn`'s forward, dx, dW and
    db against autograd through the plain version, at bf16 2e-2 / f32 1e-4
    (the forward and dx elementwise; dW and db against their largest
    element, as they sum over every voxel). The output gradient is zero
    where the plain pre-ReLU value is within 1e-3 of the kink, where the
    two accumulation orders may pick another side. Times: the forward and
    the data gradient (its own launch, `conv3d` of the masked gradient with
    the flipped kernel), the weight gradient (cuDNN), their plain versions
    and cuDNN's forward and data gradient. Returns the forward row and the
    data gradient's row (None when `dgrad` is off, as for enc0a)."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    route = cuda_conv.conv3d_route(cin, cout, dtype)
    droute = cuda_conv.conv3d_route(cout, cin, dtype)
    gen = torch.Generator(device="cuda").manual_seed(len(name) * 1000 + cin + cout)
    x = torch.randn(shape + (cin,), device="cuda", generator=gen).to(dtype)
    k = (torch.randn((3, 3, 3, cin, cout), device="cuda", generator=gen) / (27 * cin) ** 0.5).to(dtype)
    b = torch.randn((cout,), device="cuda", generator=gen) * 0.1
    pre = cuda_conv.conv3d_reference(x, k, b, relu=False, out_dtype=torch.float32)
    dy = (torch.randn(shape + (cout,), device="cuda", generator=gen) * (pre.abs() > 1e-3)).to(dtype)
    del pre

    def grads(fn):
        leaves = [x.clone().requires_grad_(dgrad), k.clone().requires_grad_(), b.clone().requires_grad_()]
        out = fn(*leaves, relu=True, out_dtype=dtype)
        got = torch.autograd.grad(out, leaves if dgrad else leaves[1:], dy)
        return [out.detach()] + ([None] if not dgrad else []) + list(got)

    got = grads(cuda_conv.conv3d_train)
    want = grads(cuda_conv.conv3d_reference)
    errs = {"fwd": check_close(f"train {name} forward", got[0], want[0], tol, tol)}
    if dgrad:
        errs["dx"] = check_close(f"train {name} dx", got[1], want[1], tol, tol)
    for key, g, w in (("dW", got[2], want[2]), ("db", got[3], want[3])):
        scale = float(w.float().abs().max())
        errs[key] = check_close(f"train {name} {key}", g.float() / scale, w.float() / scale, tol, tol) * scale
    del got, want
    g = (dy * (cuda_conv.conv3d(x, k, b, relu=True, out_dtype=dtype) > 0)).contiguous()
    kd = cuda_conv.dgrad_kernel(k)
    voxels = int(np.prod(shape))
    esize = x.element_size()
    fwd_ms = time_ms(torch, lambda: cuda_conv.conv3d(x, k, b, relu=True, out_dtype=dtype), reps)
    wgrad_ms = time_ms(torch, lambda: cuda_conv.conv3d_weight_grad(x, g), reps)
    wgrad_plain_ms = time_ms(torch, lambda: cuda_conv.conv3d_weight_grad_reference(x, g), 1)
    # yardsticks, never called by the port: cuDNN's forward (bias fused,
    # no ReLU) and data gradient on the channels-last views
    x_cl, g_cl = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
    w_cl = k.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    b_lib = b.to(dtype)
    fwd_lib_ms = time_ms(torch, lambda: torch.nn.functional.conv3d(x_cl, w_cl, b_lib, padding=1), reps)
    wb, wb_by = conv_bounds(voxels, cin, cout, esize, esize)
    # weight gradient: x and dy read once, dW written once, the same products
    w_bytes = voxels * (cin + cout) * esize + 27 * cin * cout * esize
    w_ops = 2.0 * 27 * cin * cout * voxels / (BF16_FLOPS if esize == 2 else F32_FLOPS) * 1e3
    fwd = {
        "name": f"conv3d_{route}:train.{name}",
        "route": "cuda",
        "source": CONV_SOURCES[route],
        "replaces": "oai_analysis_2_tpu/ops/pallas_conv.py:100",
        "shape": f"x {list(shape) + [cin]} -> Cout {cout}, forward under autograd",
        "launches": None,
        "max_abs_err": errs["fwd"],
        "tol": {"atol": tol, "rtol": tol},
        "grad_errs": errs,
        "ms": fwd_ms,
        "plain_ms": time_ms(torch, lambda: cuda_conv.conv3d_reference(x, k, b, relu=True, out_dtype=dtype), 1),
        "bound_ms": wb,
        "bound_by": wb_by,
        "library_ms": fwd_lib_ms,
        "wgrad_ms": wgrad_ms,
        "wgrad_plain_ms": wgrad_plain_ms,
        "wgrad_bound_ms": max(w_ops, w_bytes / HBM_BYTES_PER_S * 1e3),
        "tflops": 2.0 * 27 * cin * cout * voxels / fwd_ms * 1e-9,
    }
    if route == "cinsmall":
        # uncounted: the wmma build that ran this conv before
        fwd["was_ms"] = time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="wmma", relu=True, out_dtype=dtype),
                                reps)
    if route == "sm90n":
        # uncounted: the wmma build that ran this conv before, the load pipeline alone
        fwd["was_ms"] = time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="wmma", relu=True, out_dtype=dtype),
                                reps)
        fwd["loads_ms"] = time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="sm90n", relu=True, out_dtype=dtype,
                                                                  loads_only=True), reps)
    rows = [fwd, None]
    if dgrad:
        dgrad_ms = time_ms(torch, lambda: cuda_conv.conv3d(g, kd, None, relu=False, out_dtype=dtype), reps)
        dlib_ms = time_ms(torch, lambda: torch.nn.grad.conv3d_input(x_cl.shape, w_cl, g_cl, padding=1), reps)
        db, db_by = conv_bounds(voxels, cout, cin, esize, esize, bias=False)
        rows[1] = {
            "name": f"conv3d_{droute}:train.{name}:dgrad",
            "route": "cuda",
            "source": CONV_SOURCES[droute],
            "replaces": "oai_analysis_2_tpu/ops/pallas_conv.py:100",
            "shape": f"dy {list(shape) + [cout]} -> Cin {cin}, the data gradient (flipped kernel)",
            "launches": None,
            "max_abs_err": errs["dx"],
            "tol": {"atol": tol, "rtol": tol},
            "ms": dgrad_ms,
            "plain_ms": time_ms(torch, lambda: cuda_conv.conv3d_reference(g, kd, None, out_dtype=dtype), 1),
            "bound_ms": db,
            "bound_by": db_by,
            "library_ms": dlib_ms,
            "tflops": 2.0 * 27 * cin * cout * voxels / dgrad_ms * 1e-9,
        }
        if droute == "sm90n":
            rows[1]["was_ms"] = time_ms(torch, lambda: cuda_conv.launch(g, kd, None, route="wmma", out_dtype=dtype),
                                        reps)
            rows[1]["loads_ms"] = time_ms(torch, lambda: cuda_conv.launch(g, kd, None, route="sm90n", out_dtype=dtype,
                                                                          loads_only=True), reps)
    del x, k, b, dy, g, kd, x_cl, g_cl, w_cl
    torch.cuda.empty_cache()
    return rows


def route_counts(cuda_conv) -> dict:
    """Forward and data-gradient launches by route since the last reset."""
    c = cuda_conv.conv3d
    out = {}
    for route in cuda_conv.ROUTES:
        dg = getattr(c, f"launches_dgrad_{route}")
        out[f"fwd_{route}"] = getattr(c, f"launches_{route}") - dg
        out[f"dgrad_{route}"] = dg
    return out


def expected_train_counts(cuda_conv, convs, dtype, forwards, no_input_grad) -> dict:
    """Route counts of `forwards` UNet forwards (and backwards) over `convs`;
    `no_input_grad` of those forwards take no enc0a data gradient."""
    from collections import Counter

    fwd = Counter(cuda_conv.conv3d_route(cin, cout, dtype) for _, _, cin, cout in convs)
    dg = Counter(cuda_conv.conv3d_route(cout, cin, dtype) for _, _, cin, cout in convs)
    enc0a = [c for c in convs if c[0].endswith("enc0a")][0]
    out = {}
    for route in cuda_conv.ROUTES:
        out[f"fwd_{route}"] = forwards * fwd[route]
        out[f"dgrad_{route}"] = forwards * dg[route]
    out[f"dgrad_{cuda_conv.conv3d_route(enc0a[3], enc0a[2], dtype)}"] -= no_input_grad
    return out


def compare_train_runs(card: dict, cpu: dict, lr: float, steps: int, what: str, grad_rel: float = 1e-3) -> dict:
    """Card against CPU from the same params, f32; every gap is measured,
    then any beyond its tolerance fails. Every step's outputs within 1e-3
    relative (GradICON's small reg term 1e-2): a max-pool or ReLU kink can
    move a later step by 1e-4 between two rounding orders (the JAX package
    against the port on the CPU: 1.3e-4 at step 2 of (b)'s GradICON). The
    first step's gradients within `grad_rel` (1e-3 for f32) of the leaf's
    largest plus 1e-5 of the model's largest (the deepest leaves' gradients are sums that
    cancel, so their rounding follows the model's scale: on the card the
    gathers' backward adds with atomics in another order). The first
    step's params within 2e-2 lr on elements whose gradient is above 1e-2
    of that tolerance's scale; the last params within 0.1 x steps x lr on
    leaves whose largest first gradient is above 5e-2 (Adam moves a
    near-zero gradient by +-lr, its sign set by rounding, and that moves
    later gradients)."""
    gaps = {"loss_rel": [], "grad_over_tol": 0.0, "worst_grad_leaf": None, "params1": 0.0, "params_last": 0.0}
    bad = []
    for i, (a, b) in enumerate(zip(card["losses"], cpu["losses"])):
        rels = [abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b)]
        gaps["loss_rel"].append(rels)
        bad += [f"step {i} output {j}: card {a[j]}, CPU {b[j]}" for j, rel in enumerate(rels)
                if not rel <= (1e-2 if j == 2 else 1e-3)]  # GradICON's reg term is small and kinked
    top = max(float(np.abs(g).max()) for g in cpu["grads1"].values())
    for key, g in cpu["grads1"].items():
        gmax = float(np.abs(g).max())
        tol = grad_rel * gmax + 1e-5 * top
        over = float(np.abs(card["grads1"][key] - g).max()) / tol
        if over > gaps["grad_over_tol"]:
            gaps["grad_over_tol"], gaps["worst_grad_leaf"] = over, key
        if not over <= 1.0:
            bad.append(f"first gradient of {key}: {over} x its tolerance {tol}")
        mask = np.abs(g) > 1e-2 * (gmax + 1e-2 * top)
        d1 = float(np.abs(card["params1"][key] - cpu["params1"][key])[mask].max()) if mask.any() else 0.0
        gaps["params1"] = max(gaps["params1"], d1)
        if not d1 <= 2e-2 * lr:
            bad.append(f"first step's {key} off by {d1}")
        if gmax > 5e-2:
            dl = float(np.abs(card["params"][key] - cpu["params"][key]).max())
            gaps["params_last"] = max(gaps["params_last"], dl)
            if not dl <= 0.1 * steps * lr:
                bad.append(f"{key} after {steps} steps off by {dl}")
    if bad:
        raise AssertionError(f"{what}: {bad[:8]} ({len(bad)} in all); gaps {json.dumps(gaps)}")
    return gaps


def small_train_runs(torch, cuda_conv) -> dict:
    """Phase 11 (b): 3 f32 steps on the card and on the CPU from the same
    params: `make_augmented_train_step` (GradICON width 4, grid 16x32x32,
    scales (2, 1), sup 1.0, sim 0.1) and `make_train_step` on UNet_light4
    (2 patches of 16x32x32)."""
    from oai_analysis_2_tpu_torch.engine.training import make_train_step
    from oai_analysis_2_tpu_torch.models.gradicon import GradICON, GradICONConfig
    from oai_analysis_2_tpu_torch.models.synthetic import (
        make_augmented_train_step,
        make_phantom_pool,
        random_lowres_field,
    )
    from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, UNet3D
    from oai_analysis_2_tpu_torch.utils import optim
    from oai_analysis_2_tpu_torch.utils.checkpoint import carry_params, export_params, flatten_tree

    steps, lr = 3, TRAIN_SMALL_LR
    cfg = GradICONConfig(grid_shape=(16, 32, 32), scales=(2, 1), stage_width=4)
    init = GradICON(cfg, device="cpu").init(torch.Generator().manual_seed(0), zero_heads=False).params_list()
    pool = make_phantom_pool(3, cfg.grid_shape, seed=1)
    rng = np.random.default_rng(0)
    batches = [(pool[[0, 1]], pool[[0, 2]],
                np.stack([random_lowres_field(rng, (2, 4, 4), 0.05, 0.04) for _ in range(2)]),
                np.stack([random_lowres_field(rng, (2, 4, 4), 0.05, 0.04) for _ in range(2)]),
                np.asarray([1.0, 0.0], np.float32)) for _ in range(steps)]
    spec = NETWORK_SPECS["UNet_light4"].replace(bias=True)
    unet_init = export_params(UNet3D(spec, device="cpu").init(torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(2)
    seg_batches = [(rng.uniform(0, 1, (2, 16, 32, 32, 1)).astype(np.float32),
                    (rng.uniform(0, 1, (2, 16, 32, 32, 2)) > 0.6).astype(np.float32)) for _ in range(steps)]

    def run(dev, kind):
        if kind == "gradicon":
            model = GradICON(cfg, device=dev)
            model.load_params(init)
            step = make_augmented_train_step(model, optim.adam(list(model.parameters()), lr), 1.0, 0.1)
            data = [[torch.as_tensor(v, device=dev) for v in b] for b in batches]
        else:
            model = UNet3D(spec, device=dev)
            carry_params(model, unet_init)
            step = make_train_step(model, optim.adam(list(model.parameters()), lr))
            data = seg_batches
        out = {"losses": []}
        for i, batch in enumerate(data):
            res = step(*batch)
            out["losses"].append([float(v) for v in (res if isinstance(res, tuple) else (res,))])
            if i == 0:
                out["grads1"] = {k: p.grad.detach().cpu().numpy().copy() for k, p in model.named_parameters()}
                out["params1"] = flatten_tree(export_params(model))
                out["params1"] = {k.replace("/", "."): v for k, v in out["params1"].items()}
        out["params"] = {k.replace("/", "."): v for k, v in flatten_tree(export_params(model)).items()}
        return out

    report = {}
    for kind in ("gradicon", "unet_light4"):
        cuda_conv.reset_launches()
        card = run("cuda", kind)
        torch.cuda.synchronize()
        launches = route_counts(cuda_conv)
        cpu = run("cpu", kind)
        report[kind] = {"gaps": compare_train_runs(card, cpu, lr, steps, f"small {kind} steps"),
                        "card_losses": card["losses"], "cpu_losses": cpu["losses"], "launches": launches}
        if launches["fwd_f32"] <= 0 or launches["dgrad_f32"] <= 0:
            raise AssertionError(f"small {kind} steps: f32 route launches {launches}")
    return report


def gradicon_training(torch, cuda_conv, tmp_root) -> dict:
    """Phase 11 (c): the w24 recipe of `tools/train_w24_cycles.sh` (bf16,
    width 24, grid 48x96x96, batch 2, sup 1.0, sim 0.1, peak lr 3e-4)
    resumed from the shipped weights, through the port's
    `examples.train_gradicon_synthetic` for 20 steps on a pool of 8
    phantoms; the checkpoint reloaded bit-equal and registering a pair."""
    from oai_analysis_2_tpu_torch.core.image import image_from_array
    from oai_analysis_2_tpu_torch.engine.registration import register_pair
    from oai_analysis_2_tpu_torch.examples import train_gradicon_synthetic as trainer
    from oai_analysis_2_tpu_torch.models.gradicon import (
        GradICON,
        GradICONConfig,
        _stage_spec,
        default_gradicon_weights_path,
        load_gradicon_checkpoint,
    )
    from oai_analysis_2_tpu_torch.models.synthetic import make_augmented_train_step, random_phantom
    from oai_analysis_2_tpu_torch.utils import optim
    from oai_analysis_2_tpu_torch.utils.checkpoint import flatten_tree

    env = dict(GRADICON_WIDTH=str(REG_WIDTH), GRADICON_GRID=",".join(map(str, REG_GRID)), GRADICON_SUP_W="1.0",
               GRADICON_SIM_W="0.1", GRADICON_LR="3e-4", GRADICON_POOL="8",
               GRADICON_RESUME=str(default_gradicon_weights_path()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    cfg = GradICONConfig(grid_shape=REG_GRID, stage_width=REG_WIDTH)
    shipped = GradICON(cfg, device="cuda")
    shipped.load_params(load_gradicon_checkpoint()[0])
    shipped_eval = trainer.make_eval(cfg, "cuda")(shipped)
    out = tmp_root / "gradicon.npz"
    try:
        cuda_conv.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary = trainer.main([str(TRAIN_STEPS), "2", str(out)], device="cuda")
        wall = time.perf_counter() - t0
        launches = route_counts(cuda_conv)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    losses = summary["losses"]
    if not np.isfinite(losses).all():
        raise AssertionError(f"GradICON training: non-finite losses {losses}")
    # the eval's f32 forward (one direction, 3 stages x 10 convs) is the f32 route's only use
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items() if not k.endswith("f32")}
    convs = unet_convs(_stage_spec(REG_WIDTH), (1,) + REG_GRID, "")
    # 2 pairs x 2 directions x 3 stages; stage 0's input needs no gradient
    want = expected_train_counts(cuda_conv, convs, torch.bfloat16, 12, 4)
    want = {k: v for k, v in want.items() if not k.endswith("f32")}
    if per_step != want or launches["fwd_f32"] != 30 or launches["dgrad_f32"] != 0:
        raise AssertionError(f"GradICON training launches a step {per_step}, want {want}; f32 {launches}")
    # enc0a's forward (Cin 2) on the cinsmall kernel, nothing on the wmma build
    if per_step["fwd_cinsmall"] != 12 or launches["fwd_wmma"] != 0 or launches["dgrad_wmma"] != 0:
        raise AssertionError(f"GradICON training: {per_step['fwd_cinsmall']} cinsmall launches a step (want 12), "
                             f"wmma {launches['fwd_wmma']} forward and {launches['dgrad_wmma']} data gradients "
                             "(want 0)")
    params, meta = load_gradicon_checkpoint(out)
    trained = flatten_tree({f"stage{k}": p for k, p in enumerate(summary["model"].params_list())})
    for key, v in flatten_tree({f"stage{k}": p for k, p in enumerate(params)}).items():
        if not np.array_equal(v, trained[key]):
            raise AssertionError(f"GradICON checkpoint {key} differs from the trained params")
    if meta != {"stage_width": REG_WIDTH, "grid_shape": REG_GRID, "scales": cfg.scales}:
        raise AssertionError(f"GradICON checkpoint metadata {meta}")
    reloaded = GradICON(cfg, device="cuda")
    rng = np.random.default_rng(5)
    a = image_from_array(random_phantom(rng, REG_GRID), spacing=(0.7, 0.36, 0.36), device="cuda")
    b = image_from_array(random_phantom(rng, REG_GRID), spacing=(0.7, 0.36, 0.36), device="cuda")
    quality = {}
    phi_ab, phi_ba = register_pair(a, b, model=reloaded, params=params, quality_out=quality)
    if not bool(phi_ab.field.isfinite().all()) or phi_ab.field.grad_fn is not None:
        raise AssertionError("register_pair with the trained weights: non-finite field or a graph")
    # where a step's device time goes: one more step under torch.profiler
    model = summary["model"]
    step = make_augmented_train_step(model, optim.adam(list(model.parameters()), 1e-5), 1.0, 0.1)
    pool = torch.as_tensor(np.stack([random_phantom(rng, REG_GRID) for _ in range(2)]), device="cuda")
    u = torch.zeros((2, 6, 12, 12, 3), device="cuda")
    batch = (pool, pool.flip(0), u, u, torch.zeros(2, device="cuda"))
    profiled = profile_train_step(torch, lambda: step(*batch))
    step_s = summary["step_seconds"]
    return {
        "steps": TRAIN_STEPS, "wall_s": wall,
        "s_per_step_median_3_20": float(np.median(step_s[2:])), "first_steps_s": step_s[:2],
        "max_memory_allocated_gb": peak_gb,
        "launches_per_step": per_step, "eval_f32_launches": launches["fwd_f32"],
        "losses_first_last": [losses[0], losses[-1]],
        "eval_shipped_vox": shipped_eval, "eval_after_vox": summary["eval"][TRAIN_STEPS - 1],
        "checkpoint": str(out), "register_pair_quality": {k: float(v) for k, v in quality.items()},
        "profiled_step": profiled,
    }


def load_tool(name: str):
    """The module `tools/<name>.py` of this checkout."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def recipe_cycles(root) -> dict:
    """Phase 11 (e): the w24 recipe from scratch through
    `tools/port_train_w24_cycles.run_cycles` at `RECIPE_CUT` (its gates
    raise), then `validate_registration --network 0` on the result; adds
    the conv launches of the three cycles by route and direction."""
    report = load_tool("port_train_w24_cycles").run_cycles(root / "gradicon.npz", device="cuda", validators=(0,),
                                                           shipped=False, **RECIPE_CUT)
    launches = {}
    for c in report["cycles"]:
        for k, v in c["launches_per_step"].items():
            launches[k] = launches.get(k, 0) + int(v * c["steps"])
        launches["fwd_f32"] = launches.get("fwd_f32", 0) + c["eval_f32_launches"]
    report["launches"] = launches
    return report


def profile_train_step(torch, fn) -> dict:
    """One training step under torch.profiler: wall, the device's busy time
    and device ms by kernel family: the conv kernels (wmma, sm90, sm90n, cin1, cinsmall, f32;
    forward and data gradient share a kernel), everything else by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, busy_us, by_name = device_spans(prof)
    families = {"conv3d_wmma": "conv3d_bf16_kernel", "conv3d_sm90": "conv3d_sm90_kernel",
                "conv3d_sm90n": "conv3d_sm90n_kernel", "conv3d_cin1": "conv3d_cin1_kernel",
                "conv3d_cinsmall": "conv3d_cinsmall_kernel", "conv3d_f32": "conv3d_f32_ring_kernel"}
    fam_us = {fam: sum(us for n, us in by_name.items() if key in n) for fam, key in families.items()}
    rest = {n: us for n, us in by_name.items() if not any(key in n for key in families.values())}
    top = sorted(rest.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_s": wall, "device_events": len(spans), "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall if spans else None,
            "conv_kernel_device_ms": {k: v / 1e3 for k, v in fam_us.items()},
            "other_device_ms": sum(rest.values()) / 1e3,
            "top_other_device_ms": {n[:90]: us / 1e3 for n, us in top}}


def segmentation_training(torch, cuda_conv, pipe, knee) -> dict:
    """Phase 11 (d): `Segmenter3DInPatchClassWise.train` on the production
    UNet in bf16 (the segmenter's serving dtype, phase 4's segmenter),
    `BalancedPatchSampler` on the bench fixture knee with its two shell
    masks as labels, patch 32x128x128, batch 2, Adam 1e-3, 5 steps on one
    fixed batch; then `segment` of the knee builds no graph."""
    import itertools

    from oai_analysis_2_tpu_torch.bench import FULL, knee_and_atlas, shell_probmap
    from oai_analysis_2_tpu_torch.engine.sampling import BalancedPatchSampler
    from oai_analysis_2_tpu_torch.utils.checkpoint import export_params, flatten_tree

    seg = pipe.segmenter
    model = seg.model
    knee_np, _ = knee_and_atlas(**FULL)
    volume = (knee_np - knee_np.min()) / (knee_np.max() - knee_np.min())
    labels = np.stack([shell_probmap(FULL["shape"], *FULL[t]) > 0.5 for t in ("fc", "tc")], axis=-1)
    sampler = BalancedPatchSampler([volume], [labels.astype(np.float32)], TRAIN_TILE[1:], batch_size=2, seed=0)
    batch = next(sampler)
    if float(batch[1].sum()) <= 0:
        raise AssertionError("segmentation training: the fixed batch holds no foreground")
    init = export_params(model.init(torch.Generator().manual_seed(0)))
    stamps = []
    cuda_conv.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, losses = seg.train(model, itertools.repeat(batch), SEG_TRAIN_STEPS, 1e-3, params=init,
                                    log_every=1, callback=lambda i, loss: stamps.append(time.perf_counter()))
    wall = time.perf_counter() - t0
    launches = route_counts(cuda_conv)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: v / SEG_TRAIN_STEPS for k, v in launches.items()}
    convs = unet_convs(model.spec, TRAIN_TILE, "")
    want = expected_train_counts(cuda_conv, convs, torch.bfloat16, 1, 1)
    if per_step != want:
        raise AssertionError(f"segmentation training launches a step {per_step}, want {want} (no enc0a dgrad)")
    if launches["fwd_wmma"] != 0 or launches["dgrad_wmma"] != 0:
        raise AssertionError(f"segmentation training reached the wmma build: {launches}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"segmentation training losses {losses}: want finite and falling")
    moved = flatten_tree(params)
    for key, v in flatten_tree(init).items():
        p = dict(model.named_parameters())[key.replace("/", ".")]
        if np.array_equal(moved[key], v) or p.grad is None or not bool(p.grad.isfinite().all()):
            raise AssertionError(f"segmentation training: leaf {key} did not move or has no finite gradient")
    fc, tc = seg.segment(knee, if_output_itk=False)
    if fc.grad_fn is not None or tc.grad_fn is not None or fc.requires_grad:
        raise AssertionError("segment after training built a graph")
    return {"steps": SEG_TRAIN_STEPS, "wall_s": wall, "step_s": np.diff([t0] + stamps).tolist(),
            "max_memory_allocated_gb": peak_gb, "launches_per_step": per_step, "losses": losses,
            "leaves": len(moved), "trainable_parameters": sum(int(v.size) for v in moved.values())}


def training(torch, cuda_conv, pipe, knee, kernels) -> dict:
    """Phase 11: (a) the conv kernels under autograd at the trainers'
    shapes, (b) small steps card against CPU, (c) full-width GradICON
    training, (d) full-width segmentation training, (e) the w24 recipe's
    warm-restart cycles from scratch, cut. Appends the training rows to
    `kernels` with their launches from (b)-(d)."""
    from pathlib import Path

    from oai_analysis_2_tpu_torch.models.gradicon import _stage_spec

    report = {}
    t0 = time.perf_counter()
    rows = []
    # (a): the bf16 GradICON w24 finest stage (every route the GradICON
    # trainer takes), one f32 stage conv, the production UNet's 14 convs
    for name, shape, cin, cout in unet_convs(_stage_spec(REG_WIDTH), (1,) + REG_GRID, "gradicon.stage2."):
        rows.append(("gradicon", conv_train_case(torch, cuda_conv, name, shape, cin, cout, torch.bfloat16, 10)))
    (name, shape, cin, cout), = [c for c in unet_convs(_stage_spec(REG_WIDTH), (1,) + REG_GRID, "gradicon_f32.stage2.")
                                 if c[0].endswith("enc1b")]
    rows.append(("f32", conv_train_case(torch, cuda_conv, name, shape, cin, cout, torch.float32, 10)))
    for name, shape, cin, cout in unet_convs(pipe.segmenter.model.spec, TRAIN_TILE, "unet."):
        rows.append(("unet", conv_train_case(torch, cuda_conv, name, shape, cin, cout, torch.bfloat16, 10,
                                             dgrad=not name.endswith("enc0a"))))
    report["a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["b"] = small_train_runs(torch, cuda_conv)
    report["b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    root = Path(os.path.dirname(os.path.abspath(__file__))) / "build" / "train_smoke"
    report["c"] = gradicon_training(torch, cuda_conv, root)
    report["c_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["d"] = segmentation_training(torch, cuda_conv, pipe, knee)
    report["d_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["e"] = recipe_cycles(root.parent / "recipe_smoke")
    report["e_s"] = time.perf_counter() - t0
    # launches: (c)'s 20 steps, (b)'s GradICON card steps, (d)'s 5 steps
    counts = {"gradicon": {k: v * TRAIN_STEPS for k, v in report["c"]["launches_per_step"].items()},
              "f32": report["b"]["gradicon"]["launches"],
              "unet": {k: v * SEG_TRAIN_STEPS for k, v in report["d"]["launches_per_step"].items()}}
    for path, (fwd, dg) in rows:
        for row, key in ((fwd, "fwd"), (dg, "dgrad")):
            if row is None:
                continue
            route = row["name"].split(":")[0][len("conv3d_"):]
            row["launches"] = int(counts[path][f"{key}_{route}"])
            kernels.append(row)
    return report


# ---- phase 12: the example scripts ------------------------------------------------

# The JAX package's numbers for the same arguments, taken with the unchanged
# root scripts on a CPU (not a device number), e.g.
#   JAX_PLATFORMS=cpu python examples/validate_registration.py --network 0
#   JAX_PLATFORMS=cpu python examples/validate_registration.py --network 20
#   JAX_PLATFORMS=cpu python examples/validate_registration.py
# and the other three schedules of tools/reg_accuracy_sweep.sh with their
# `argv` (80x192x192 phantom, 48x96x96 grid, the shipped width-24 weights):
# image MSE ratio after / before and the field error's mean, median and p95 (mm)
VALIDATE_JAX_CPU = {
    "network0": dict(argv=["--network", "0"], mse_ratio=0.4639, err_mean_mm=0.960, err_median_mm=0.887,
                     err_p95_mm=1.572),
    "network20": dict(argv=["--network", "20"], mse_ratio=0.4285, err_mean_mm=0.787, err_median_mm=0.792,
                      err_p95_mm=1.233),
    "instance": dict(argv=[], mse_ratio=0.4441, err_mean_mm=0.830, err_median_mm=0.896, err_p95_mm=1.272),
    "network20_ft21_lr0.4": dict(argv=["--network", "20", "--ft-scales", "2,1", "--ft-lr", "0.4"],
                                 mse_ratio=0.4255, err_mean_mm=0.700, err_median_mm=0.701, err_p95_mm=1.123),
    "warm30_20_15_lr1.2": dict(argv=["--network", "30,20,15", "--ft-scales", "4,2,1", "--ft-lr", "1.2"],
                               mse_ratio=0.4469, err_mean_mm=1.333, err_median_mm=1.225, err_p95_mm=2.581),
    "warm40_30_20_lr1.2": dict(argv=["--network", "40,30,20", "--ft-scales", "4,2,1", "--ft-lr", "1.2"],
                               mse_ratio=0.4317, err_mean_mm=0.981, err_median_mm=0.965, err_p95_mm=1.696),
}
# the tolerance on the mean error (mm) against the JAX CPU number. The
# network modes, and fine-tuning at lr 0.15 or 0.4, are deterministic up to
# summation order: the port on the CPU was at most 7.5e-4 mm off (lr 0.4),
# an H100 80GB HBM3 (700 W) 1e-5 to 4.5e-4. Adam at lr 1.2 (instance
# mode, and the two warm starts) is chaotic: its near-sign steps turn
# rounding into whole steps. Moving 1 % of the phantom's voxels by one ulp
# moves the instance run's mean error over INSTANCE_CPU_BAND on the CPU in
# either package, and the card's runs lie inside that band (phase 12 (e)).
# The two packages' CPU runs are two distributions all the same (JAX's mean
# 0.038 mm above the port's, Welch t 4.9 over 32 runs each) though no op
# of a step departs from JAX's beyond rounding
# (tools/port_instance_handoff.py); the card's runs are a third (0.019 mm
# below the port's CPU runs, t 2.5). The unperturbed card run is held at
# the gate of 0.125 mm all the same, and the warm starts at no more
VALIDATE_TOL_MM = {"network0": 0.02, "network20": 0.02, "instance": 0.125, "network20_ft21_lr0.4": 0.02,
                   "warm30_20_15_lr1.2": 0.125, "warm40_30_20_lr1.2": 0.125}
# phase 12 (e): the seeds and share of `validate_registration.ulp_perturb`
# for the card's instance runs, those of tools/port_instance_spread.py's
# perturbed CPU runs
SPREAD_SEEDS, SPREAD_SHARE = (1, 2, 3, 4), 0.01
#   JAX_PLATFORMS=cpu python tools/port_instance_spread.py --runs 32
# (instance mode, both packages, 32 runs each: the phantom as it is at 2
# and at 1 thread, seeds 1-30 at 2 threads): the band of the mean error
# (mm) over both packages' runs (its reach, `instance_band_limits`,
# 0.6887-0.9071 mm, inside the 16-run band's 0.6828-0.9268), and each
# package's own
INSTANCE_CPU_BAND = dict(n=64, min=0.7181760668754578, max=0.8958392143249512, mean=0.7978664059191942,
                         std=0.036396427091269855)
INSTANCE_CPU_PACKAGE_BANDS = {
    "jax": dict(n=32, min=0.7649707198143005, max=0.8958392143249512, mean=0.8168395180255175,
                std=0.03262831021589917),
    "port": dict(n=32, min=0.7181760668754578, max=0.8512800335884094, mean=0.778893293812871,
                 std=0.029737905456863133),
}


def instance_band_limits() -> tuple:
    """The CPU band's reach: its min to max, or its mean +- 3 standard
    deviations, whichever is wider on each side."""
    b = INSTANCE_CPU_BAND
    return min(b["min"], b["mean"] - 3 * b["std"]), max(b["max"], b["mean"] + 3 * b["std"])
#   JAX_PLATFORMS=cpu python examples/validate_registration_cross.py --network 0
#   JAX_PLATFORMS=cpu python examples/validate_registration_cross.py --network 10
#   JAX_PLATFORMS=cpu python examples/validate_registration_cross.py
# (two random phantoms from default_rng(2024) on the 48x96x96 grid)
CROSS_JAX_CPU = {
    "network0": dict(argv=["--network", "0"], mse_ratio=0.799, lncc_after=0.9969, ic_mean_vox=0.996,
                     ic_median_vox=0.989, ic_p95_vox=1.712, jac_median=0.981, jac_p1=0.783, jac_p99=1.203,
                     folded=0.0),
    "network10": dict(argv=["--network", "10"], mse_ratio=0.603, lncc_after=0.9941, ic_mean_vox=2.341,
                      ic_median_vox=2.189, ic_p95_vox=4.463, jac_median=0.878, jac_p1=-0.402, jac_p99=3.621,
                      folded=0.0531),
    "instance": dict(argv=[], mse_ratio=0.373, lncc_after=0.9810, ic_mean_vox=6.666, ic_median_vox=6.827,
                     ic_p95_vox=12.053, jac_median=1.179, jac_p1=-0.013, jac_p99=3.009, folded=0.0908),
}
# tolerances (absolute) of the gated cross metrics against the JAX CPU
# numbers, the folded fraction within 0.005 in every mode. The largest
# gaps seen (the port on the CPU, and an H100 at 700 W): network ft0
# 4e-4 vox of inverse consistency, 3e-4 of the Jacobian median; ft10
# (lr 1.2) 0.0023 vox, 6e-4 folded; instance (lr 1.2, 180 steps) 0.035
# vox, 0.0043 of the median, 0.0037 folded, 3e-4 of the MSE ratio
CROSS_TOL = {
    "network0": dict(mse_ratio=0.002, lncc_after=2e-4, ic_mean_vox=0.01, jac_median=0.005, folded=0.005),
    "network10": dict(mse_ratio=0.005, lncc_after=5e-4, ic_mean_vox=0.05, jac_median=0.01, folded=0.005),
    "instance": dict(mse_ratio=0.005, lncc_after=1e-3, ic_mean_vox=0.2, jac_median=0.02, folded=0.005),
}
#   JAX_PLATFORMS=cpu python tools/port_full_demo_parity.py --shape 80,192,192
# (its JAX run: `OAI_DEMO_SHAPE=80,192,192 examples/full_demo.py phantom`):
# inner mesh points and mean thickness (mm), raster coverage and mean
# mapped thickness (mm), as printed
FULL_DEMO_JAX_CPU_80 = dict(fc_points=6228, fc_mean_thickness=0.390, tc_points=6152, tc_mean_thickness=0.334,
                            fc_coverage=0.349, tc_coverage=0.307, fc_mapped_mean_mm=0.721,
                            tc_mapped_mean_mm=0.170)
# tolerances against those, relative but for the coverage (absolute). The
# TC mapped mean is ill-conditioned on this phantom: 36 % of the knee's TC
# inner points have a thickness under 0.05 mm and 68 % of the atlas's TC
# points take one of them, so 2 voxels of the warped TC map across 0.5
# moved it from 0.170 to 0.154 mm. That gap was two faults of the port,
# found by `tools/port_full_demo_handoff.py` (each port stage fed JAX's
# output of the stage before, on the CPU): the percentile window's
# position (hi 552.29260 against JAX's 552.21167) and the UNet head's bf16
# rounding before its bias (maps off by up to 0.0078). Repaired, every
# stage is within f32 rounding of JAX's (segment maps 3.0e-8, field 3.1e-5
# mm, no voxel across 0.5), the port's CPU run prints JAX's numbers, and
# the card gave TC 6152 points and 0.17024 mm (H100, 700 W). The sizes and
# means take phase 8's tolerances (0.5 %, 1 %), the coverage phase 8 (c)'s
# (0.005), both mapped means 3 %. Rounding alone uses little of that: with
# the knee moved by one ulp at 1 % of its voxels (FULL_DEMO_CPU_BAND and
# the card's runs, an H100 80GB HBM3 at 700 W, 0.17024140-0.17024156 mm)
# no warped voxel crossed 0.5, and every run of the three bands lies
# 0.141-0.142 % above the printed 0.170 (FC 0.004 % above 0.721), so the
# widest band, JAX's, leaves 2.86 % of the TC gate
FULL_DEMO_TOL_80 = dict(fc_points=0.005, tc_points=0.005, fc_mean_thickness=0.01, tc_mean_thickness=0.01,
                        fc_coverage=0.005, tc_coverage=0.005, fc_mapped_mean=0.03, tc_mapped_mean=0.03)
#   JAX_PLATFORMS=cpu python tools/port_full_demo_spread.py --runs 9
# (the 80x192x192 full demo in both packages, 9 runs each: the knee as it
# is, then moved by one f32 ulp at 1 % of its voxels at seeds 1-8): each
# package's band of the mean mapped thickness (mm)
FULL_DEMO_CPU_BAND = {
    "jax": dict(tc_mapped_mean_mm=dict(n=9, min=0.1702393740415573, max=0.17024163901805878,
                                       mean=0.17023992207315233, std=9.678524377280306e-07),
                fc_mapped_mean_mm=dict(n=9, min=0.7210277318954468, max=0.7210291624069214,
                                       mean=0.7210287517971463, std=5.514995607448423e-07)),
    "port": dict(tc_mapped_mean_mm=dict(n=9, min=0.17024151980876923, max=0.170241579413414,
                                        mean=0.17024154629972246, std=1.9396964897480248e-08),
                 fc_mapped_mean_mm=dict(n=9, min=0.7210279703140259, max=0.7210281491279602,
                                        mean=0.7210280895233154, std=7.300048299977713e-08)),
}
# `jnp.percentile(knee, 0.1)` and `(knee, 99.9)` of the 80x192x192 phantom
# before its window, on the CPU (JAX 0.9; `tools/port_full_demo_handoff.py`
# prints them)
FULL_DEMO_WINDOW_JAX_CPU_80 = [0.2456759363412857, 552.211669921875]
# the full demo's launches a run: the knee and the atlas through the UNet
# (14 bf16 convs a slab), the network's 60 f32 convs, 2 tissues x 2
# distance directions
FULL_DEMO_F32, FULL_DEMO_DISTANCE = 60, 4


def check_finite(what, values: dict) -> None:
    bad = {k: v for k, v in values.items() if isinstance(v, float) and not math.isfinite(v)}
    if bad:
        raise AssertionError(f"{what}: non-finite numbers {bad}")


def run_validator(cuda_conv, cuda_kernels, main, argv, network, what):
    """One validator run: its numbers (finite), wall seconds and launches;
    a network run takes the GradICON's 60 f32 convs, an instance run no
    conv."""
    reset_launches(cuda_conv, cuda_kernels)
    t0 = time.perf_counter()
    got = main(argv)
    wall = time.perf_counter() - t0
    launches = read_launches(cuda_conv, cuda_kernels)
    check_finite(what, got)
    want_f32 = 60 if network else 0
    if launches["conv3d_f32"] != want_f32 or \
            sum(v for k, v in launches.items() if k.startswith("conv3d_")) != want_f32:
        raise AssertionError(f"{what}: conv launches {launches}, want {want_f32} f32 and no other")
    return got, wall, launches


def spread_band(values) -> dict:
    """min, max, mean and standard deviation (n - 1) of a set of runs."""
    v = np.asarray(values, np.float64)
    return {"n": int(v.size), "min": float(v.min()), "max": float(v.max()), "mean": float(v.mean()),
            "std": float(v.std(ddof=1)) if v.size > 1 else 0.0}


def instance_spread(cuda_conv, cuda_kernels, validate_registration, unperturbed) -> dict:
    """Phase 12 (e): instance mode with the phantom moved by one ulp at the
    seeds of `SPREAD_SEEDS` (`validate_registration.ulp_perturb`, as
    `tools/port_instance_spread.py` moves it on the CPU), each run's mean
    error within `INSTANCE_CPU_BAND` of the CPU runs; the card's band of
    these runs and `unperturbed` (phase 12 (a)'s instance run), beside each
    package's CPU band."""
    runs = [{"seed": 0, "err_mean_mm": unperturbed["err_mean_mm"], "seconds": unperturbed["seconds"]}]
    for seed in SPREAD_SEEDS:
        main = functools.partial(validate_registration.main, perturb=(seed, SPREAD_SHARE))
        got, wall, _ = run_validator(cuda_conv, cuda_kernels, main, [], False,
                                     f"validate_registration instance, ulp seed {seed}")
        runs.append({"seed": seed, "err_mean_mm": got["err_mean_mm"], "err_median_mm": got["err_median_mm"],
                     "err_p95_mm": got["err_p95_mm"], "seconds": got["seconds"], "wall_s": wall})
    lo, hi = instance_band_limits()
    outside = [r for r in runs if not lo <= r["err_mean_mm"] <= hi]
    if outside:
        raise AssertionError(f"instance spread: runs {outside} outside the CPU runs' band [{lo}, {hi}] mm")
    return {"runs": runs, "band": spread_band([r["err_mean_mm"] for r in runs]), "cpu_band": INSTANCE_CPU_BAND,
            "package_bands": INSTANCE_CPU_PACKAGE_BANDS, "limits_mm": [lo, hi]}


def example_validators(torch, cuda_conv, cuda_kernels) -> dict:
    """Phase 12 (a), (b), (e): the two registration validators on the card
    (the known-field one in the six schedules of `VALIDATE_JAX_CPU`, the
    cross one in three modes), gated against the JAX package's CPU
    numbers, and the instance run's rounding spread."""
    from oai_analysis_2_tpu_torch.examples import validate_registration, validate_registration_cross

    out = {"validate": {}, "cross": {}}
    for mode, ref in VALIDATE_JAX_CPU.items():
        got, wall, launches = run_validator(cuda_conv, cuda_kernels, validate_registration.main, ref["argv"],
                                            mode != "instance", f"validate_registration {mode}")
        gap = got["err_mean_mm"] - ref["err_mean_mm"]
        if abs(gap) > VALIDATE_TOL_MM[mode]:
            raise AssertionError(f"validate_registration {mode}: mean error {got['err_mean_mm']} mm, the JAX "
                                 f"package's {ref['err_mean_mm']} on the CPU (tolerance {VALIDATE_TOL_MM[mode]})")
        out["validate"][mode] = {**{k: got[k] for k in ("seconds", "mse_ratio", "err_mean_mm", "err_median_mm",
                                                        "err_p95_mm")},
                                 "wall_s": wall, "jax_cpu": {k: v for k, v in ref.items() if k != "argv"},
                                 "err_mean_gap_mm": gap, "tol_mm": VALIDATE_TOL_MM[mode],
                                 "f32_launches": launches["conv3d_f32"]}
    out["spread"] = instance_spread(cuda_conv, cuda_kernels, validate_registration, out["validate"]["instance"])
    for mode, ref in CROSS_JAX_CPU.items():
        got, wall, launches = run_validator(cuda_conv, cuda_kernels, validate_registration_cross.main, ref["argv"],
                                            mode != "instance", f"validate_registration_cross {mode}")
        gaps = {k: got[k] - ref[k] for k in CROSS_TOL[mode]}
        bad = {k: v for k, v in gaps.items() if abs(v) > CROSS_TOL[mode][k]}
        if bad:
            raise AssertionError(f"validate_registration_cross {mode}: {got} against the JAX package's CPU "
                                 f"{ref}: gaps {bad} beyond {CROSS_TOL[mode]}")
        out["cross"][mode] = {**{k: v for k, v in got.items() if k not in ("mode", "shape")}, "wall_s": wall,
                              "gaps": gaps, "tol": CROSS_TOL[mode], "f32_launches": launches["conv3d_f32"]}
    return out


def check_full_demo_outputs(torch, got, out_dir, what) -> None:
    """The files of a full-demo run present, its maps finite, its meshes
    non-empty with a plausible FC median, its rasters covered."""
    from pathlib import Path

    from oai_analysis_2_tpu_torch.core.nifti import read_nifti
    from oai_analysis_2_tpu_torch.examples.full_demo import OUTPUT_FILES

    missing = [f for f in OUTPUT_FILES if not (Path(out_dir) / f).is_file()]
    if missing:
        raise AssertionError(f"{what}: missing outputs {missing}")
    for name in OUTPUT_FILES[:3]:
        data = read_nifti(Path(out_dir) / name, device="cpu").data
        if not bool(data.isfinite().all()):
            raise AssertionError(f"{what}: {name} reads back non-finite")
    with np.load(Path(out_dir) / "thickness_2d.npz") as z:
        if set(z.files) != {f"{t}_{k}" for t in ("fc", "tc")
                            for k in ("x", "y", "thickness", "map", "counts", "bounds")}:
            raise AssertionError(f"{what}: thickness_2d.npz keys {z.files}")
    if not (got["fc_points"] > 0 and got["tc_points"] > 0):
        raise AssertionError(f"{what}: empty inner mesh {got}")
    if not 0.2 <= got["fc_median_thickness"] <= 10.0:
        raise AssertionError(f"{what}: FC median thickness {got['fc_median_thickness']} mm outside 0.2-10")
    if not (got["fc_coverage"] > 0 and got["tc_coverage"] > 0):
        raise AssertionError(f"{what}: raster coverage {got['fc_coverage']}, {got['tc_coverage']}")
    check_finite(what, got)


def run_full_demo(torch, cuda_conv, cuda_kernels, out_dir, shape, what) -> dict:
    """One `full_demo.main(["phantom", out_dir])` at `OAI_DEMO_SHAPE=shape`
    (None: the default grid): its printed numbers, stage seconds, wall
    seconds and launches; its files, maps and meshes checked, and 13 sm90
    launches per cin1, 60 f32 and 4 distance."""
    from oai_analysis_2_tpu_torch.examples import full_demo

    if shape is None:
        os.environ.pop("OAI_DEMO_SHAPE", None)
    else:
        os.environ["OAI_DEMO_SHAPE"] = shape
    reset_launches(cuda_conv, cuda_kernels)
    t0 = time.perf_counter()
    try:
        got = full_demo.main(["phantom", str(out_dir)])
    finally:
        os.environ.pop("OAI_DEMO_SHAPE", None)
    wall = time.perf_counter() - t0
    launches = read_launches(cuda_conv, cuda_kernels)
    check_full_demo_outputs(torch, got, out_dir, what)
    check_bf16_routes(launches, what)
    if launches["conv3d_cin1"] <= 0 or launches["conv3d_f32"] != FULL_DEMO_F32 \
            or launches["point_triangle"] != FULL_DEMO_DISTANCE:
        raise AssertionError(f"{what}: launches {launches}, want cin1 > 0, {FULL_DEMO_F32} f32 and "
                             f"{FULL_DEMO_DISTANCE} distance")
    return {**{k: v for k, v in got.items() if k not in ("stages", "out_dir")},
            "stage_seconds": {k: v["seconds"] for k, v in got["stages"].items()}, "wall_s": wall,
            "launches": launches}


def full_demo_gaps(got, what) -> dict:
    """An 80x192x192 run's gaps to the JAX package's CPU numbers, fatal
    beyond `FULL_DEMO_TOL_80`."""
    ref, tol = FULL_DEMO_JAX_CPU_80, FULL_DEMO_TOL_80
    gaps = {}
    for t in ("fc", "tc"):
        gaps[f"{t}_points"] = (got[f"{t}_points"] - ref[f"{t}_points"]) / ref[f"{t}_points"]
        gaps[f"{t}_mean_thickness"] = (got[f"{t}_mean_thickness"] - ref[f"{t}_mean_thickness"]) / \
            ref[f"{t}_mean_thickness"]
        gaps[f"{t}_coverage"] = got[f"{t}_coverage"] - ref[f"{t}_coverage"]
        gaps[f"{t}_mapped_mean"] = (got[f"{t}_mapped_mean_mm"] - ref[f"{t}_mapped_mean_mm"]) / \
            ref[f"{t}_mapped_mean_mm"]
    bad = {k: v for k, v in gaps.items() if abs(v) > tol[k]}
    if bad:
        raise AssertionError(f"{what}: {got} against the JAX package's CPU {ref}: gaps {bad} beyond {tol}")
    return gaps


def full_demo_spread(torch, cuda_conv, cuda_kernels, root, unperturbed) -> dict:
    """Phase 12 (c), continued: the 80x192x192 knee moved by one ulp at 1 %
    of its voxels at the seeds of `SPREAD_SEEDS` (the perturbation of
    `tools/port_full_demo_spread.py`'s CPU runs), each run as
    `run_full_demo` checks it and within `FULL_DEMO_TOL_80` of the JAX
    package's CPU numbers; the card's band of these runs and `unperturbed`
    beside both packages' CPU bands (`FULL_DEMO_CPU_BAND`)."""
    tool = load_tool("port_full_demo_spread")
    runs = [{"seed": 0, **{k: unperturbed[k] for k in tool.NUMBERS}, "wall_s": unperturbed["wall_s"]}]
    for seed in SPREAD_SEEDS:
        what = f"full demo at 80x192x192, ulp seed {seed}"
        with tool.port_knee_perturbed((seed, SPREAD_SHARE)) as seen:
            got = run_full_demo(torch, cuda_conv, cuda_kernels, root / f"shape80_seed{seed}", "80,192,192", what)
        if seen["knees"] != 1:
            raise AssertionError(f"{what}: {seen['knees']} knees made, want 1")
        runs.append({"seed": seed, **{k: got[k] for k in tool.NUMBERS}, "wall_s": got["wall_s"],
                     "jax_cpu_gaps": full_demo_gaps(got, what), "launches": got["launches"]})
        print(f"{what}: " + ", ".join(f"{k} {got[k]!r}" for k in tool.NUMBERS) + f", {got['wall_s']:.2f} s",
              flush=True)
    band = {k: spread_band([r[k] for r in runs]) for k in ("fc_mapped_mean_mm", "tc_mapped_mean_mm")}
    inside = {k: all(min(b[k]["min"] for b in FULL_DEMO_CPU_BAND.values()) <= r[k]
                     <= max(b[k]["max"] for b in FULL_DEMO_CPU_BAND.values()) for r in runs) for k in band}
    print(f"full demo spread at 80x192x192 on the card ({len(runs)} runs): {json.dumps(band)}; the CPU bands "
          f"{json.dumps(FULL_DEMO_CPU_BAND)}; every card run inside their span: {inside}", flush=True)
    return {"runs": runs, "band": band, "cpu_band": FULL_DEMO_CPU_BAND, "inside_cpu_span": inside}


def example_full_demo(torch, cuda_conv, cuda_kernels) -> dict:
    """Phase 12 (c): `full_demo.main(["phantom", dir])` at the default
    160x384x384, then at `OAI_DEMO_SHAPE=80,192,192` against the JAX
    package's CPU numbers there, then `full_demo_spread`."""
    from pathlib import Path

    from oai_analysis_2_tpu_torch.examples import full_demo
    from oai_analysis_2_tpu_torch.ops.intensity import _percentiles

    root = Path(__file__).resolve().parent / "build" / "examples_smoke"
    out = {}
    for name, shape in (("full", None), ("shape80", "80,192,192")):
        # the phantom's window ends on the card and from the port on the CPU
        raw = torch.from_numpy(full_demo._phantom_knee(tuple(int(v) for v in (shape or "160,384,384").split(","))))
        window = {"card": _percentiles(raw.cuda(), (0.1, 99.9)), "cpu": _percentiles(raw, (0.1, 99.9))}
        print(f"full demo ({name}) window lo / hi: card {window['card']}, CPU port {window['cpu']}", flush=True)
        if window["card"] != window["cpu"] or (shape and window["card"] != FULL_DEMO_WINDOW_JAX_CPU_80):
            raise AssertionError(f"full demo ({name}): the card's percentile window {window['card']} is not the "
                                 f"CPU port's {window['cpu']} (at 80x192x192, JAX's {FULL_DEMO_WINDOW_JAX_CPU_80})")
        del raw
        out[name] = {**run_full_demo(torch, cuda_conv, cuda_kernels, root / name, shape, f"full demo ({name})"),
                     "window_lo_hi": window}
    out["shape80"]["jax_cpu_gaps"] = full_demo_gaps(out["shape80"], "full demo at 80x192x192")
    out["spread"] = full_demo_spread(torch, cuda_conv, cuda_kernels, root, out["shape80"])
    return out


def example_nifti_demos(torch, cuda_conv, cuda_kernels) -> dict:
    """Phase 12 (d): the NIfTI demos on phase 8's release tree
    (`OAI_TPU_DATA_DIR`): the segmentation demo on the windowed knee
    against the CLI's route (the release segmenter on the same windowed
    knee), the thickness demo on its FC map against `get_thickness_mesh`,
    the cohort demo on two copies of the knee."""
    import shutil
    from pathlib import Path

    from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject
    from oai_analysis_2_tpu_torch.core.nifti import read_nifti, write_nifti
    from oai_analysis_2_tpu_torch.examples import cohort_demo, segmentation_demo, thickness_demo
    from oai_analysis_2_tpu_torch.mesh.processing import get_thickness_mesh
    from oai_analysis_2_tpu_torch.ops.intensity import percentile_window

    release = Path(__file__).resolve().parent / "build" / "release_smoke"
    root = Path(__file__).resolve().parent / "build" / "examples_smoke"
    out = {}
    # the demo takes a preprocessed knee: phase 8's knee, windowed as the
    # pipeline windows it
    knee = read_nifti(release / "knee.nii.gz", device="cuda")
    pre = percentile_window(knee, 0.1, 99.9, 0.0, 1.0)
    pre_path = root / "knee_preprocessed.nii.gz"
    root.mkdir(parents=True, exist_ok=True)
    write_nifti(pre, pre_path)
    fc_ref, tc_ref = AnalysisObject(device="cuda").segment(pre)
    want = {"fc_voxels": int((fc_ref.data > 0.5).sum()), "tc_voxels": int((tc_ref.data > 0.5).sum())}

    seg_dir = root / "seg"
    reset_launches(cuda_conv, cuda_kernels)
    got = segmentation_demo.main([str(pre_path), str(seg_dir)])
    launches = read_launches(cuda_conv, cuda_kernels)
    check_bf16_routes(launches, "segmentation demo")
    if {k: got[k] for k in want} != want or min(want.values()) <= 0:
        raise AssertionError(f"segmentation demo voxel counts {got}, the CLI route's {want}")
    out["segmentation"] = {**got, "cli_route": want, "launches": launches}

    thick_dir = root / "thickness"
    got = thickness_demo.main([str(seg_dir / "FC_probmap.nii.gz"), "FC", str(thick_dir)])
    inner, _ = get_thickness_mesh(read_nifti(seg_dir / "FC_probmap.nii.gz", device="cuda"), "FC")
    n_ref, mean_ref = inner.n_points, float(np.mean(inner.point_data))
    if not (got["inner_points"] > 0 and abs(got["inner_points"] - n_ref) <= 0.005 * n_ref
            and abs(got["inner_mean_thickness"] - mean_ref) <= 0.01 * abs(mean_ref)):
        raise AssertionError(f"thickness demo {got}; get_thickness_mesh gave {n_ref} points, mean {mean_ref} mm")
    files = {p.name for p in thick_dir.iterdir()}
    if files != {"FC_inner_thickness.vtk", "FC_outer_thickness.vtk", "FC_thickness_2d.npz"}:
        raise AssertionError(f"thickness demo wrote {files}")
    out["thickness"] = {**got, "direct": {"points": n_ref, "mean_mm": mean_ref}}

    knees = root / "cohort_in"
    shutil.rmtree(knees, ignore_errors=True)
    shutil.rmtree(root / "cohort", ignore_errors=True)
    knees.mkdir()
    for name in ("knee_a.nii.gz", "knee_b.nii.gz"):
        shutil.copy(release / "knee.nii.gz", knees / name)
    t0 = time.perf_counter()
    summary = cohort_demo.main([str(knees), str(root / "cohort")])
    wall = time.perf_counter() - t0
    bad = [r for r in shard_records(root / "cohort" / "manifest.json") if r["status"] in ("failed", "retry")]
    if summary != {"done": 2} or bad:
        raise AssertionError(f"cohort demo summary {summary}, want {{'done': 2}}; failed or retried records: {bad}")
    out["cohort"] = {"summary": summary, "wall_s": wall}
    return out


# ---- phase 13: the multi-card path --------------------------------------------------

SHARD_STEPS = 3  # (a) and (c): data-parallel steps
SHARD_LR = {"unet": TRAIN_SMALL_LR, "gradicon": 3e-4}  # (a): phase 11 (b)'s step; (c): the w24 recipe's peak
SHARD_TILES = 5  # (d)
SHARD_COHORT_KNEES_A_RANK = 2  # (f)
SHARD_DEADLINE_S = 600  # ranks still running after this are killed
SHARD_BF16_TOL = 2e-2  # phase 11 (a)'s bf16 rule: values, and gradients against their leaf's largest


def sharding_layout(torch):
    """(ranks, backend): one rank a card over NCCL where there are two or
    more cards; on one card two ranks over gloo, as NCCL refuses two ranks
    on one GPU. Two ranks on one card show what the collectives cost, not
    scaling."""
    n = torch.cuda.device_count()
    return (n, "nccl") if n >= 2 else (2, "gloo")


def leaves_np(model) -> dict:
    return {k: p.detach().float().cpu().numpy().copy() for k, p in model.named_parameters()}


def grads_np(model) -> dict:
    return {k: p.grad.detach().float().cpu().numpy().copy() for k, p in model.named_parameters()}


def train_run(torch, model, step, batches) -> dict:
    """`step` on each batch: the record `compare_train_runs` reads, and
    each step's seconds (the card synchronized around it)."""
    out = {"losses": [], "step_s": []}
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append([float(loss)])
        if i == 0:
            out["grads1"], out["params1"] = grads_np(model), leaves_np(model)
    out["params"] = leaves_np(model)
    return out


def check_grads_bf16(got: dict, want: dict, what: str) -> float:
    """Every leaf's gradient within SHARD_BF16_TOL of the leaf's largest;
    returns the worst gap over that scale."""
    worst = 0.0
    for key, g in want.items():
        gap = float(np.abs(got[key] - g).max()) / max(float(np.abs(g).max()), 1e-30)
        worst = max(worst, gap)
        if not gap <= SHARD_BF16_TOL:
            raise AssertionError(f"{what}: the gradient of {key} is off by {gap} of its largest element")
    return worst


def same_on_every_rank(torch, dist, model) -> bool:
    """Every rank's parameters bit-equal to rank 0's."""
    flat = torch.cat([p.detach().reshape(-1).float() for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, bool(torch.equal(flat, ref)))
    return all(flags)


COLLECTIVE_KEYS = ("allreduce", "all_reduce", "broadcast", "allgather", "all_gather", "record_param_comms",
                   "gloo", "nccl")


def profile_collectives(torch, dist, fn) -> dict:
    """One call of `fn` under torch.profiler, every rank at once (a barrier
    first): its wall time, the host time inside the collectives (the union
    of the profiler's host spans named after them), the device's busy time
    and the device time of NCCL's kernels and of the copies (gloo moves a
    CUDA tensor through the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    host = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == DeviceType.CPU and any(k in e.name.lower() for k in COLLECTIVE_KEYS))
    host_us, cur = 0.0, None
    for start, end in host:
        if cur is None or start > cur[1]:
            host_us += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    host_us += 0.0 if cur is None else cur[1] - cur[0]
    spans, busy_us, by_name = device_spans(prof)
    return {"wall_s": wall, "collective_host_s": host_us / 1e6, "collective_share": host_us / 1e6 / wall,
            "collective_spans": len(host), "device_busy_s": busy_us / 1e6,
            "nccl_device_ms": sum(us for n, us in by_name.items() if "nccl" in n.lower()) / 1e3,
            "copy_device_ms": sum(us for n, us in by_name.items() if "memcpy" in n.lower()) / 1e3}


def sharding_rank(rank, world, backend, out_dir):
    """One rank of phase 13: joins the group, runs (a)-(f) and writes its
    report to `out_dir/rank<r>.json`; a failed gate raises."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # the kernels the parent built: loaded from build/kernels/, no nvcc
    from oai_analysis_2_tpu_torch.ops import cuda_build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{out_dir}/rendezvous", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        cuda_build.build_all()
        report = sharding_rank_body(torch, dist, rank, world, out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def sharding_rank_body(torch, dist, rank, world, out_dir) -> dict:
    from pathlib import Path

    from oai_analysis_2_tpu_torch.bench import FULL, knee_and_atlas
    from oai_analysis_2_tpu_torch.core.image import image_from_array
    from oai_analysis_2_tpu_torch.engine.training import dice_bce_loss, make_train_step
    from oai_analysis_2_tpu_torch.models.gradicon import (
        GradICON,
        GradICONConfig,
        load_gradicon_params,
        make_gradicon_train_step,
    )
    from oai_analysis_2_tpu_torch.models.synthetic import make_phantom_pool
    from oai_analysis_2_tpu_torch.models.unet3d import NETWORK_SPECS, UNet3D
    from oai_analysis_2_tpu_torch.ops import cuda_conv, cuda_kernels
    from oai_analysis_2_tpu_torch.parallel import BatchKneePipeline, CohortRunner, make_device_mesh
    from oai_analysis_2_tpu_torch.parallel.sharding import (
        ZHalo,
        gather_slots,
        make_sharded_gradicon_train_step,
        make_sharded_inference,
        make_sharded_train_step,
        shard_batch,
    )
    from oai_analysis_2_tpu_torch.utils import optim

    mesh = make_device_mesh()  # world x 1
    dev = torch.device("cuda", torch.cuda.current_device())
    report = {"rank": rank, "card": dev.index, "card_name": torch.cuda.get_device_name(dev)}
    spec = NETWORK_SPECS["UNet"].replace(bias=True)

    def unet():
        return UNet3D(spec, torch.bfloat16, device=dev).init(torch.Generator().manual_seed(0))

    # (a) the production UNet, bf16: SHARD_STEPS data-parallel steps on a
    # global batch of 2 tiles a rank, against rank 0's unsharded steps
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    batch = (2 * world,) + TRAIN_TILE[1:]
    batches = [(rng.uniform(0, 1, batch + (1,)).astype(np.float32),
                (rng.uniform(0, 1, batch + (2,)) > 0.6).astype(np.float32)) for _ in range(SHARD_STEPS)]
    model = unet()
    lr = SHARD_LR["unet"]
    sharded = train_run(torch, model, make_sharded_train_step(model, optim.adam(list(model.parameters()), lr), mesh),
                        batches)
    a = {"global_batch": list(batch), "sharded_step_s": sharded["step_s"], "losses": sharded["losses"],
         "bit_equal_across_ranks": same_on_every_rank(torch, dist, model)}
    if not a["bit_equal_across_ranks"]:
        raise AssertionError("(a) the ranks' parameters differ after the sharded steps")
    if rank == 0:
        ref = unet()
        ref_step = make_train_step(ref, optim.adam(list(ref.parameters()), lr))
        alone = train_run(torch, ref, ref_step, [(torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
                                                 for x, y in batches])
        a["unsharded_step_s"] = alone["step_s"]
        a["unsharded_losses"] = alone["losses"]
        # bf16: the gradients take phase 11 (a)'s bf16 rule
        a["gaps"] = compare_train_runs(sharded, alone, lr, SHARD_STEPS, "(a) sharded against unsharded UNet steps",
                                       grad_rel=SHARD_BF16_TOL)
        del ref, ref_step, alone
    step = make_sharded_train_step(model, optim.adam(list(model.parameters()), lr), mesh)
    a["profiled_step"] = profile_collectives(torch, dist, lambda: step(*batches[0]))
    a["seconds"] = time.perf_counter() - t0
    report["a"] = a

    # (b) the production tile z-sharded: the forward against the unsharded
    # forward, one spatial step's gradients against the unsharded step's
    t0 = time.perf_counter()
    smesh = make_device_mesh(n_data=world // 2, n_space=2)
    tiles = (2 * (world // 2),) + TRAIN_TILE[1:]
    x = rng.uniform(0, 1, tiles + (1,)).astype(np.float32)
    y = (rng.uniform(0, 1, tiles + (2,)) > 0.6).astype(np.float32)
    model = unet()
    with torch.no_grad():
        block = model(shard_batch(smesh, x, spatial_axis=1), halo=ZHalo(smesh))
        got = torch.cat(list(gather_slots(block, smesh.get_group("space"))), dim=1)
        want = model(shard_batch(smesh, x))
    b = {"tiles": list(tiles), "z_block": tiles[1] // 2,
         "forward_max_abs_err": check_close("(b) z-sharded forward", got, want, SHARD_BF16_TOL, SHARD_BF16_TOL)}
    del block, got, want
    spatial = make_sharded_train_step(model, optim.adam(list(model.parameters()), lr), smesh, spatial_shard=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss = float(spatial(x, y))
    torch.cuda.synchronize()
    b["spatial_step_s"] = time.perf_counter() - t1
    b["bit_equal_across_ranks"] = same_on_every_rank(torch, dist, model)
    grads = grads_np(model)
    ref = unet()
    for p in ref.parameters():
        p.requires_grad_(True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref_loss = dice_bce_loss(ref(torch.as_tensor(x, device=dev)), torch.as_tensor(y, device=dev))
    ref_loss.backward()
    torch.cuda.synchronize()
    b["unsharded_step_s"] = time.perf_counter() - t1
    b["loss"], b["unsharded_loss"] = loss, float(ref_loss.detach())
    if not abs(loss - b["unsharded_loss"]) <= 1e-3 * abs(b["unsharded_loss"]) or not b["bit_equal_across_ranks"]:
        raise AssertionError(f"(b) spatial step: loss {loss} against {b['unsharded_loss']} unsharded, parameters "
                             f"equal across ranks {b['bit_equal_across_ranks']}")
    b["worst_grad_gap"] = check_grads_bf16(grads, grads_np(ref), "(b) spatial step against the unsharded step")
    b["seconds"] = time.perf_counter() - t0
    report["b"] = b
    del model, ref, spatial, ref_loss

    # (c) the w24 GradICON, bf16, shipped weights: SHARD_STEPS data-parallel
    # steps, one pair a rank, against rank 0's unsharded steps
    t0 = time.perf_counter()
    cfg = GradICONConfig(grid_shape=REG_GRID, stage_width=REG_WIDTH)
    shipped = load_gradicon_params()

    def gradicon():
        g = GradICON(cfg, compute_dtype=torch.bfloat16, device=dev)
        g.load_params(shipped)
        return g

    pool = make_phantom_pool(2 * world, REG_GRID, seed=0)
    pairs = [(pool[:world], pool[world:])] * SHARD_STEPS
    glr = SHARD_LR["gradicon"]
    model = gradicon()
    gsharded = train_run(torch, model, make_sharded_gradicon_train_step(
        model, optim.adam(list(model.parameters()), glr), mesh), pairs)
    c = {"pairs": world, "sharded_step_s": gsharded["step_s"], "losses": gsharded["losses"],
         "bit_equal_across_ranks": same_on_every_rank(torch, dist, model)}
    if not c["bit_equal_across_ranks"] or not np.isfinite(gsharded["losses"]).all():
        raise AssertionError(f"(c) GradICON steps: losses {gsharded['losses']}, parameters equal across ranks "
                             f"{c['bit_equal_across_ranks']}")
    if rank == 0:
        ref = gradicon()
        ref_step = make_gradicon_train_step(ref, optim.adam(list(ref.parameters()), glr))
        alone = train_run(torch, ref, ref_step, [tuple(torch.as_tensor(v, device=dev) for v in p) for p in pairs])
        c["unsharded_step_s"] = alone["step_s"]
        c["unsharded_losses"] = alone["losses"]
        first = abs(gsharded["losses"][0][0] - alone["losses"][0][0]) / abs(alone["losses"][0][0])
        c["first_loss_rel_gap"] = first
        if not first <= 1e-3:
            raise AssertionError(f"(c) first GradICON loss {gsharded['losses'][0]} against {alone['losses'][0]}")
        c["worst_grad_gap"] = check_grads_bf16(gsharded["grads1"], alone["grads1"], "(c) GradICON first gradients")
        del ref, ref_step, alone
    c["seconds"] = time.perf_counter() - t0
    report["c"] = c
    del model, gsharded

    # (d) sharded inference: SHARD_TILES production tiles over the ranks
    t0 = time.perf_counter()
    model = unet()
    tiles = rng.uniform(0, 1, (SHARD_TILES,) + TRAIN_TILE[1:] + (1,)).astype(np.float32)
    infer = make_sharded_inference(model, mesh)
    probs = infer(tiles)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    probs = infer(tiles)
    torch.cuda.synchronize()
    d = {"tiles": SHARD_TILES, "sharded_s": time.perf_counter() - t1}
    with torch.no_grad():
        t1 = time.perf_counter()
        want = torch.sigmoid(model(torch.as_tensor(tiles, device=dev)))
        torch.cuda.synchronize()
        d["unsharded_s"] = time.perf_counter() - t1
    if tuple(probs.shape) != tuple(want.shape):
        raise AssertionError(f"(d) sharded inference shape {tuple(probs.shape)}, want {tuple(want.shape)}")
    d["max_abs_err"] = check_close("(d) sharded inference", probs, want, SHARD_BF16_TOL, 0.0)
    d["seconds"] = time.perf_counter() - t0
    report["d"] = d
    del model, probs, want, infer
    torch.cuda.empty_cache()

    # (e) the knee batch: phase 10's two full-size knees split over the
    # data axis; each rank's launches against an unsharded run_batch of its
    # own knees, counted here
    t0 = time.perf_counter()
    pipe, knee = build_pipeline("cuda", FULL, batch_size=8)
    knees = [knee, image_from_array(knee_and_atlas(**dict(FULL, **SECOND_KNEE_SHELLS), seed=1)[0],
                                    spacing=(0.36, 0.36, 0.7), device="cuda")]
    kw = dict(registration_mode="network", finetune_steps=20, warp_dtype="bfloat16")
    bpipe = BatchKneePipeline(pipe.segmenter, pipe.atlas, mesh=mesh, **kw)
    bpipe.run_batch(knees)
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches(cuda_conv, cuda_kernels)
    t1 = time.perf_counter()
    results = bpipe.run_batch(knees)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = read_launches(cuda_conv, cuda_kernels)
    own = bpipe._own_knees(len(knees))
    alone_pipe = BatchKneePipeline(pipe.segmenter, pipe.atlas, device=dev, **kw)
    dist.barrier()
    reset_launches(cuda_conv, cuda_kernels)
    t1 = time.perf_counter()
    alone_pipe.run_batch([knees[i] for i in own])
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t1
    alone_launches = read_launches(cuda_conv, cuda_kernels)
    if launches != alone_launches:
        raise AssertionError(f"(e) rank {rank}'s sharded run_batch launched {launches}; its knees {own} alone "
                             f"launched {alone_launches}")
    if len(results) != len(knees):
        raise AssertionError(f"(e) rank {rank} returned {len(results)} knees of {len(knees)}")
    report["e"] = {"own_knees": own, "batch_seconds": wall, "seconds_a_knee": wall / len(knees),
                   "own_knees_alone_s": alone_s, "launches": launches,
                   "stage_seconds": {k: v["seconds"] for k, v in results[0].timings.items()},
                   "knees": [summarize(r) for r in results], "seconds": time.perf_counter() - t0}
    del pipe, knee, knees, bpipe, alone_pipe, results
    torch.cuda.empty_cache()

    # (f) the cohort runner in every rank with the group up and no `host`
    t0 = time.perf_counter()
    small_pipe, _ = build_pipeline("cuda", SMALL, batch_size=4)
    n_small = SHARD_COHORT_KNEES_A_RANK * world
    small = [image_from_array(knee_and_atlas(**SMALL, seed=s)[0], spacing=(0.36, 0.36, 0.7), device="cuda")
             for s in range(n_small)]
    done = []

    def run_knee(i):
        r = small_pipe.run(small[i])
        done.append(i)
        return {"rank": rank, "fc_inner_points": int(r.fc_inner.n_points)}

    dist.barrier()
    runner = CohortRunner(run_knee, Path(out_dir) / "cohort" / "manifest.json", verbose=False, poll_seconds=0.2)
    summary = runner.run(list(range(n_small)), keys=[f"knee{i}" for i in range(n_small)])
    if summary.get("done") != n_small or (runner.host, runner.n_hosts) != (rank, world):
        raise AssertionError(f"(f) cohort summary {summary}, host {runner.host} of {runner.n_hosts}")
    report["f"] = {"done": done, "summary": summary, "seconds": time.perf_counter() - t0}
    return report


def sharding(torch, card, knee_batch_ref) -> dict:
    """Phase 13: the multi-card path (`parallel/sharding.py`,
    `BatchKneePipeline(mesh=...)`) in one process a rank; the gates that
    need every rank's report."""
    import shutil
    from pathlib import Path

    import torch.multiprocessing as mp

    world, backend = sharding_layout(torch)
    out_dir = Path(__file__).resolve().parent / "build" / "sharding_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    log(f"phase sharding: {world} ranks over {backend} on {torch.cuda.device_count()} card(s) ({card})")
    t0 = time.perf_counter()
    ctx = mp.start_processes(sharding_rank, args=(world, backend, str(out_dir)), nprocs=world, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > SHARD_DEADLINE_S:
                raise AssertionError(f"phase sharding: ranks still running after {SHARD_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
    for r, rep in enumerate(ranks):
        for i, (got, ref) in enumerate(zip(rep["e"]["knees"], knee_batch_ref)):
            check_meshes_close(got, ref, 0.005, 0.01, f"(e) rank {r} knee{i} against phase 10 (b):")
    done = [i for rep in ranks for i in rep["f"]["done"]]
    if sorted(done) != list(range(SHARD_COHORT_KNEES_A_RANK * world)) or not all(rep["f"]["done"] for rep in ranks):
        raise AssertionError(f"(f) cohort: knees done by rank {[rep['f']['done'] for rep in ranks]}")
    return {"ranks": world, "backend": backend, "device_count": torch.cuda.device_count(), "card": card,
            "phase_s": time.perf_counter() - t0, "per_rank": ranks}


# ---- phase 14: the k-means backends ------------------------------------------------

KMEANS_REPS = 3
# phase 10's two knees' split problems, repeated to the B = 8 set's
B8_REPEAT = 4


def split_specs(knees) -> list:
    """Per knee (its FC and TC warped maps): the smoothed meshes as the
    thickness stage makes them, then each mesh's split problems and
    finisher (`mesh/split._split_problems`), in FC, TC order."""
    from oai_analysis_2_tpu_torch.mesh.components import filter_small_components
    from oai_analysis_2_tpu_torch.mesh.marching_cubes import marching_cubes_multi
    from oai_analysis_2_tpu_torch.mesh.ops import smooth_meshes
    from oai_analysis_2_tpu_torch.mesh.processing import _as_xyz, _spacing
    from oai_analysis_2_tpu_torch.mesh.split import _split_problems

    specs = []
    for fc, tc in knees:
        raws = [filter_small_components(m) for m in marching_cubes_multi([_as_xyz(fc), _as_xyz(tc)], 0.5,
                                                                         _spacing(fc))]
        specs += [_split_problems(m, kind) for m, kind in zip(smooth_meshes(raws, device=fc.device), ("FC", "TC"))]
    return specs


def label_agreement(a, b) -> float:
    """The share of equal k = 2 labels under the better of the two
    numberings."""
    same = float(np.mean(np.asarray(a) == np.asarray(b)))
    return max(same, 1.0 - same)


def kmeans_backends(torch, specs, what) -> dict:
    """`kmeans_many` on the specs' problems on the host and on the card:
    seconds (median of `KMEANS_REPS`; the card's end to end, synchronised),
    each problem's agreement and each mesh's inner and outer face counts
    (gated: 99 %, 0.5 %), and one device call under torch.profiler (the
    card's busy share of it, device milliseconds by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from oai_analysis_2_tpu_torch.ops.clustering import kmeans_many

    problems = [p for probs, _ in specs for p in probs]
    runs, labels = {"host": [], "device": []}, {}
    kmeans_many(problems, backend="device", device="cuda")  # the first call's allocations
    for _ in range(KMEANS_REPS):
        for backend in runs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels[backend] = kmeans_many(problems, backend=backend, device="cuda")
            torch.cuda.synchronize()
            runs[backend].append(time.perf_counter() - t0)
    host, dev = labels["host"], labels["device"]
    agree = [label_agreement(h, d) for h, d in zip(host, dev)]
    faces, i = [], 0
    for probs, finish in specs:
        n = len(probs)
        (hi, ho), (di, do) = finish(host[i: i + n]), finish(dev[i: i + n])
        faces.append({"host": [int(hi.n_cells), int(ho.n_cells)], "device": [int(di.n_cells), int(do.n_cells)]})
        i += n
    bad_faces = [f for f in faces if any(abs(d - h) > 0.005 * h for h, d in zip(f["host"], f["device"]))]
    if min(agree) < 0.99 or bad_faces:
        raise AssertionError(f"kmeans {what}: device labels agree {agree} with the host's (want >= 0.99), "
                             f"inner / outer faces {faces} (want within 0.5 %)")
    # one more device call under torch.profiler: where its time goes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kmeans_many(problems, backend="device", device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, busy_us, by_name = device_spans(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"problems": len(problems), "n_d": [list(p.shape) for p in problems],
            "padded_n_max": max(len(p) for p in problems),
            "host_s": runs["host"], "device_s": runs["device"],
            "host_median_s": float(np.median(runs["host"])), "device_median_s": float(np.median(runs["device"])),
            "agreement": agree, "faces": faces,
            "device_profile": {"wall_s": wall, "device_events": len(spans), "device_busy_s": busy_us / 1e6,
                               "device_busy_share": busy_us / 1e6 / wall if spans else None,
                               "top_device_ms": {name[:90]: us / 1e3 for name, us in top}}}


def tf32_products(torch, pipe, knee, field, problems) -> dict:
    """The f32 products that cuBLAS computes on the main path, each as the
    port computes it: `GradICON.both_maps` on the knee and the atlas on the
    registration grid, the warp's separable upsampling of `field` onto the
    atlas grid, the device k-means labels and centres of `problems`, and
    the knee's warped maps through `KneePipeline.run`. All on the host."""
    from oai_analysis_2_tpu_torch.engine.registration import _net_grid_reference
    from oai_analysis_2_tpu_torch.ops.clustering import kmeans
    from oai_analysis_2_tpu_torch.ops.resample import _separable_resize_weights, _upsample_field_separable, \
        resample_image

    reg = pipe.registerer
    on_grid = [resample_image(img, _net_grid_reference(img, reg.config.grid_shape)).data.float()
               for img in (knee, pipe.atlas)]
    with torch.no_grad():
        pab, pba = reg.model.both_maps(on_grid[0] / on_grid[0].max(), on_grid[1])
        up = _upsample_field_separable(field.field, *_separable_resize_weights(field, pipe.atlas))
    out = {"both_maps.ab": pab.cpu().numpy(), "both_maps.ba": pba.cpu().numpy(), "upsampled_field": up.cpu().numpy()}
    for i, p in enumerate(problems):
        out[f"kmeans{i}.labels"], out[f"kmeans{i}.centres"] = kmeans(p, backend="device", device="cuda")
    res = pipe.run(knee)
    out["warped_fc"], out["warped_tc"] = res.fc_probmap.numpy(), res.tc_probmap.numpy()
    return out


def tf32_switches(torch, pipe, knee, specs) -> dict:
    """Phase 14 (d): phases 4 and 14 once more with both TF32 switches on
    (`torch.backends.cuda.matmul.allow_tf32 = True` and
    `torch.set_float32_matmul_precision("high")`, as a caller that trains
    in TF32 sets them): every product of `tf32_products` equal bit for bit
    to the same with the switches off, and the caller's switches as it set
    them after each. The ops hold their products in IEEE f32 themselves
    (`core.device.ieee_f32_matmul`)."""
    field = pipe.registerer.register(knee, pipe.atlas)
    problems = [p for probs, _ in specs for p in probs]
    t0 = time.perf_counter()
    off = tf32_products(torch, pipe, knee, field, problems)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        on = tf32_products(torch, pipe, knee, field, problems)
        flags = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                 "float32_matmul_precision": torch.get_float32_matmul_precision()}
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    if flags != {"allow_tf32": True, "float32_matmul_precision": "high"}:
        raise AssertionError(f"(d) the TF32 switches after the port's products: {flags}, set to True / high")
    gaps = {k: float(np.max(np.abs(on[k].astype(np.float64) - off[k]))) if on[k].size else 0.0 for k in off}
    unequal = {k: gaps[k] for k in off if not np.array_equal(on[k], off[k])}
    if unequal:
        raise AssertionError(f"(d) with TF32 on, products not equal to the TF32-off ones (largest gaps): {unequal}")
    return {"seconds": time.perf_counter() - t0, "flags_after": flags, "compared": sorted(off),
            "kmeans_problems": len(problems), "max_abs_gap": gaps}


def kmeans_phase(torch, cuda_conv, cuda_kernels, card, phase4=None) -> dict:
    """Phase 14: the k-means backends at the main path's problem sizes, on
    a pipeline built afresh in phase 4's configuration (phase 11 trained
    phase 4's segmenter in place). `phase4`: phase 4's report (its summary
    and launches), which (c) is held against; None (this phase alone): the
    fresh pipeline's own host-backend run."""
    from oai_analysis_2_tpu_torch.bench import FULL, knee_and_atlas
    from oai_analysis_2_tpu_torch.core.image import image_from_array
    from oai_analysis_2_tpu_torch.mesh.processing import get_thickness_meshes

    t_phase = time.perf_counter()
    out = {"card": card}
    if os.environ.get("OAI_TPU_KMEANS_BACKEND", "host") != "host":
        raise AssertionError("phase 14 needs the host k-means backend as the default")
    pipe, knee = build_pipeline("cuda", FULL, batch_size=8)
    pipe.run(knee)
    reset_launches(cuda_conv, cuda_kernels)
    result = pipe.run(knee)
    torch.cuda.synchronize()
    launches = read_launches(cuda_conv, cuda_kernels)
    summary = summarize(result)
    if phase4 is not None:
        check_meshes_close(summary, phase4, 0.005, 0.01, "the fresh pipeline's knee against phase 4:")
        if launches != phase4["launches"]:
            raise AssertionError(f"the fresh pipeline's launches {launches}, phase 4 {phase4['launches']}")
        summary, launches = phase4, phase4["launches"]
    # (a) the network knee's four problems
    out["a"] = kmeans_backends(torch, split_specs([(result.fc_probmap, result.tc_probmap)]), "(a) one knee")
    # (b) phase 10's two knees, repeated to the B = 8 set
    knee2 = image_from_array(knee_and_atlas(**dict(FULL, **SECOND_KNEE_SHELLS), seed=1)[0],
                             spacing=(0.36, 0.36, 0.7), device="cuda")
    second = pipe.run(knee2)
    pair = split_specs([(result.fc_probmap, result.tc_probmap), (second.fc_probmap, second.tc_probmap)])
    out["b"] = kmeans_backends(torch, pair * B8_REPEAT, f"(b) {2 * B8_REPEAT} knees")
    del knee2, second

    # (c) the network knee with the variable set, then restored
    before = os.environ.get("OAI_TPU_KMEANS_BACKEND")
    os.environ["OAI_TPU_KMEANS_BACKEND"] = "device"
    try:
        pipe.run(knee)
        reset_launches(cuda_conv, cuda_kernels)
        t0 = time.perf_counter()
        res = pipe.run(knee)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got_launches = read_launches(cuda_conv, cuda_kernels)
        substages = {"device": [], "host": []}
        for _ in range(KMEANS_REPS):
            sub = {}
            get_thickness_meshes([res.fc_probmap, res.tc_probmap], ["FC", "TC"], timings_out=sub)
            substages["device"].append(sub)
    finally:
        if before is None:
            os.environ.pop("OAI_TPU_KMEANS_BACKEND", None)
        else:
            os.environ["OAI_TPU_KMEANS_BACKEND"] = before
    if os.environ.get("OAI_TPU_KMEANS_BACKEND") != before:
        raise AssertionError("OAI_TPU_KMEANS_BACKEND was not restored")
    for _ in range(KMEANS_REPS):
        sub = {}
        get_thickness_meshes([res.fc_probmap, res.tc_probmap], ["FC", "TC"], timings_out=sub)
        substages["host"].append(sub)
    got = summarize(res)
    check_meshes_close(got, summary, 0.005, 0.01, "(c) the knee with the device k-means against phase 4:")
    if got_launches != launches:
        raise AssertionError(f"(c) launches {got_launches} with the device k-means, phase 4 {launches}")
    # (d) the knee and its split problems once more with the TF32 switches on
    out["d"] = tf32_switches(torch, pipe, knee, split_specs([(result.fc_probmap, result.tc_probmap)]))
    out["c"] = {"knee_seconds": wall, "stage_seconds": {k: v["seconds"] for k, v in res.timings.items()},
                "launches": got_launches, "knee": got, "thickness_substages": substages,
                "split_median_s": {b: float(np.median([s["split"] for s in subs])) for b, subs in substages.items()},
                "thickness_median_s": {b: float(np.median([sum(s.values()) for s in subs]))
                                       for b, subs in substages.items()}}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from oai_analysis_2_tpu_torch import native
    from oai_analysis_2_tpu_torch.bench import FULL, card_line
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
    t0 = time.perf_counter()
    log(f"phase build: host-geometry library {native.build()} built with g++ and loaded in "
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
    # the knee batch's shapes: 16 tiles of 32x128x128 a step
    kernels += [conv_case(torch, F, cuda_conv, name, shape, cin, cout, torch.bfloat16, 2e-2,
                          reps=5 if shape == TILE and cin > 1 else 20, others=False)
                for name, shape, cin, cout in BATCH_CONVS]
    # the segmentation trainer's enc0b data gradient (64 -> 32 at its batch of
    # 2 x 32x128x128), the sm90n kernel at the widest input it takes
    kernels.append(conv_case(torch, F, cuda_conv, "unet.enc0b:dgrad", TRAIN_TILE, 64, 32, torch.bfloat16, 2e-2,
                             reps=10, dgrad=True))
    # the bf16 GradICON trainer's enc0a forward (2 -> 24 at 1x48x96x96), the
    # cinsmall kernel; 20 reps, as its time is a few tens of microseconds
    kernels.append(conv_case(torch, F, cuda_conv, *CINSMALL_CONV, torch.bfloat16, 2e-2, reps=20))
    kernels += [conv_case(torch, F, cuda_conv, name, shape, cin, cout, torch.float32, 1e-4, reps=20,
                          clock=name == "stage2.dec1a")
                for name, shape, cin, cout in gradicon_convs()]
    kernels.append(distance_case(torch, cuda_kernels, reps=5))
    for k in kernels:
        more = f", was {k['was_ms']:.3f} ms" if "was_ms" in k else ""
        more += f", loads alone {k['loads_ms']:.3f} ms" if "loads_ms" in k else ""
        more += f", stores alone {k['stores_ms']:.3f} ms" if "stores_ms" in k else ""
        more += f", general paths {k['general_ms']:.3f} ms" if "general_ms" in k else ""
        more += f", C call alone {k['call_ms']:.4f} ms" if "call_ms" in k else ""
        more += f", device time (profiler) {k['device_ms']:.4f} ms" if "device_ms" in k else ""
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
        if name not in ("conv3d_wmma", "conv3d_sm90n", "conv3d_cinsmall") and not name.startswith("native_") \
                and n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    check_bf16_routes(launches, "full knee")
    check_native(launches, 1, "full knee")
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
    native_report = native_check([result.fc_probmap, result.tc_probmap])
    log(f"phase full knee: the host-geometry library against its plain versions {json.dumps(native_report)}")
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

    # ---- 9. a cohort from disk: zarr, the cohort command, bench, prewarm --------
    t0 = time.perf_counter()
    cohort = cohort_from_disk(torch, cuda_conv, cuda_kernels, release["cli"])
    cohort["phase_s"] = time.perf_counter() - t0
    for k in kernels:
        k["launches_by_path"]["cohort_3_knees"] = cohort["cohort"]["launches"][k["name"].split(":")[0]]
    log(f"phase cohort from disk ({cohort['phase_s']:.1f} s, card {card}): {json.dumps(cohort)}")

    # ---- 10. the knee batch -------------------------------------------------------
    t0 = time.perf_counter()
    batch = knee_batch(torch, cuda_conv, cuda_kernels, pipe, knee)
    batch["phase_s"] = time.perf_counter() - t0
    for k in kernels:
        fam = k["name"].split(":")[0]
        k["launches_by_path"]["knee_batch"] = batch["run_batch"]["launches"][fam]
        if k["name"].endswith(":b16"):  # the batched path's own shapes
            k["launches"] = batch["run_batch"]["launches"][fam]
    log(f"phase knee batch ({batch['phase_s']:.1f} s, card {card}): {json.dumps(batch)}")

    # ---- 11. training -------------------------------------------------------------
    t0 = time.perf_counter()
    n_before = len(kernels)
    train = training(torch, cuda_conv, pipe, knee, kernels)
    train["phase_s"] = time.perf_counter() - t0
    per_step = {"train_gradicon_step": train["c"]["launches_per_step"],
                "train_segment_step": train["d"]["launches_per_step"],
                "train_recipe_cut": train["e"]["launches"]}
    for k in kernels[:n_before]:
        route = k["name"].split(":")[0][len("conv3d_"):]
        for path, counts in per_step.items():
            k["launches_by_path"][path] = sum(v for key, v in counts.items() if key.endswith(f"_{route}"))
        if route == "sm90n":  # phase 2's data-gradient row: the launches of (d)'s 5 steps
            k["launches"] = int(train["d"]["launches_per_step"]["dgrad_sm90n"] * SEG_TRAIN_STEPS)
        if route == "cinsmall":  # phase 2's enc0a row: the launches of (c)'s 20 steps
            k["launches"] = int(train["c"]["launches_per_step"]["fwd_cinsmall"] * TRAIN_STEPS)
    for k in kernels[n_before:]:
        log(f"phase training: {k['name']} [{k['shape']}] errs {json.dumps(k.get('grad_errs', k['max_abs_err']))} "
            f"kernel {k['ms']:.3f} ms, plain {k['plain_ms']:.3f} ms, library {k['library_ms']:.3f} ms, "
            f"bound {k['bound_ms']:.3f} ms ({k['bound_by']}), launches {k['launches']}"
            + (f", weight gradient {k['wgrad_ms']:.3f} ms (bound {k['wgrad_bound_ms']:.3f})"
               if "wgrad_ms" in k else "")
            + (f", was {k['was_ms']:.3f} ms" if "was_ms" in k else "")
            + (f", loads alone {k['loads_ms']:.3f} ms" if "loads_ms" in k else ""))
    for c in train["e"]["cycles"]:
        log(f"phase training: (e) cycle {c['cycle']} (lr {c['lr']}): eval {c['eval']}, best {c['best_after']:.6f}, "
            f"checkpoint {'written' if c['checkpoint_written'] else 'not written'}, step median "
            f"{c['step_s']['median_s']:.4f} s, wall {c['wall_s']:.1f} s")
    log(f"phase training: (e) validate_registration --network 0 on the recipe's weights: "
        f"{json.dumps(train['e']['validators'])} ({train['e_s']:.1f} s in all)")
    log(f"phase training ({train['phase_s']:.1f} s, card {card}): {json.dumps(train)}")

    # ---- 12. the example scripts ----------------------------------------------------
    t0 = time.perf_counter()
    examples = example_validators(torch, cuda_conv, cuda_kernels)
    examples["validators_s"] = time.perf_counter() - t0
    for mode, r in examples["validate"].items():
        log(f"phase examples: validate_registration {mode}: registration {r['seconds']:.3f} s, MSE ratio "
            f"{r['mse_ratio']:.4f}, field error mean {r['err_mean_mm']:.4f} median {r['err_median_mm']:.4f} "
            f"p95 {r['err_p95_mm']:.4f} mm (JAX CPU mean {r['jax_cpu']['err_mean_mm']}, tolerance "
            f"{r['tol_mm']} mm; card {card})")
    sp = examples["spread"]
    log(f"phase examples: (e) instance mode, phantom moved by one ulp: "
        + ", ".join(f"seed {r['seed']} {r['err_mean_mm']:.6f} mm in {r['seconds']:.3f} s" for r in sp["runs"])
        + f"; card band {json.dumps(sp['band'])} (mean {sp['band']['mean']:.6f} mm), within the CPU runs' "
          f"[{sp['limits_mm'][0]:.6f}, {sp['limits_mm'][1]:.6f}] mm; CPU bands, JAX "
          f"{json.dumps(sp['package_bands']['jax'])}, port {json.dumps(sp['package_bands']['port'])} (card {card})")
    for mode, r in examples["cross"].items():
        log(f"phase examples: validate_registration_cross {mode}: registration {r['seconds']:.3f} s, MSE ratio "
            f"{r['mse_ratio']:.4f}, LNCC {r['lncc_after']:.4f}, inverse consistency mean {r['ic_mean_vox']:.4f} "
            f"median {r['ic_median_vox']:.4f} p95 {r['ic_p95_vox']:.4f} vox, Jacobian median "
            f"{r['jac_median']:.4f} [p1 {r['jac_p1']:.4f}, p99 {r['jac_p99']:.4f}], folded {r['folded']:.5f}")
    t0 = time.perf_counter()
    examples["full_demo"] = example_full_demo(torch, cuda_conv, cuda_kernels)
    examples["full_demo_s"] = time.perf_counter() - t0
    for name in ("full", "shape80"):
        r = examples["full_demo"][name]
        log(f"phase examples: full demo ({name}): stage seconds {json.dumps(r['stage_seconds'])}, wall "
            f"{r['wall_s']:.2f} s")
    sp = examples["full_demo"]["spread"]
    log(f"phase examples: (c) full demo at 80x192x192, knee moved by one ulp: "
        + ", ".join(f"seed {r['seed']} TC {r['tc_mapped_mean_mm']!r} FC {r['fc_mapped_mean_mm']!r} mm in "
                    f"{r['wall_s']:.2f} s" for r in sp["runs"])
        + f"; card band {json.dumps(sp['band'])}, every run inside the CPU bands' span {sp['inside_cpu_span']} "
          f"(card {card})")
    t0 = time.perf_counter()
    examples["nifti_demos"] = example_nifti_demos(torch, cuda_conv, cuda_kernels)
    examples["nifti_demos_s"] = time.perf_counter() - t0
    for k in kernels[:n_before]:  # the rows of phases 2-10 (phase 11's rows count their own paths)
        k["launches_by_path"]["full_demo"] = examples["full_demo"]["full"]["launches"][k["name"].split(":")[0]]
    log(f"phase examples (card {card}): {json.dumps(examples)}")

    # ---- 13. the multi-card path ------------------------------------------------------
    shard = sharding(torch, card, batch["run_batch"]["knees"])
    for k in kernels[:n_before]:
        fam = k["name"].split(":")[0]
        k["launches_by_path"]["sharded_knee_batch"] = sum(r["e"]["launches"][fam] for r in shard["per_rank"])
    for r in shard["per_rank"]:
        prof = r["a"]["profiled_step"]
        log(f"phase sharding: rank {r['rank']} (card {r['card']}): UNet step {r['a']['sharded_step_s'][-1]:.3f} s "
            f"sharded, {r['a'].get('unsharded_step_s', [float('nan')])[-1]:.3f} s unsharded at the same global "
            f"batch (rank 0); collectives {prof['collective_host_s']:.3f} s of a {prof['wall_s']:.3f} s step "
            f"({prof['collective_share']:.3f}); z-sharded step {r['b']['spatial_step_s']:.3f} s; GradICON step "
            f"{r['c']['sharded_step_s'][-1]:.3f} s; knee batch {r['e']['seconds_a_knee']:.3f} s a knee "
            f"(own knees {r['e']['own_knees']} alone {r['e']['own_knees_alone_s']:.3f} s)")
    log(f"phase sharding ({shard['phase_s']:.1f} s, card {card}, {shard['ranks']} ranks over {shard['backend']}, "
        f"device_count {shard['device_count']}): {json.dumps(shard)}")

    # ---- 14. the k-means backends ----------------------------------------------------
    km = kmeans_phase(torch, cuda_conv, cuda_kernels, card, phase4=report)
    for part in ("a", "b"):
        r = km[part]
        log(f"phase kmeans: ({part}) {r['problems']} problems (n_max {r['padded_n_max']}): host "
            f"{r['host_median_s']:.4f} s, device {r['device_median_s']:.4f} s end to end; agreement "
            f"{min(r['agreement']):.5f} at worst (card {card})")
    log(f"phase kmeans: (c) knee {km['c']['knee_seconds']:.3f} s with the device k-means; split "
        f"{km['c']['split_median_s']['device']:.4f} s on the device, {km['c']['split_median_s']['host']:.4f} s "
        f"on the host; thickness {km['c']['thickness_median_s']['device']:.4f} / "
        f"{km['c']['thickness_median_s']['host']:.4f} s")
    log(f"phase kmeans ({km['phase_s']:.1f} s, card {card}): {json.dumps(km)}")

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
