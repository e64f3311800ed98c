"""Driver of knee-pipeline configurations: builds `KneePipeline` as the
port's CLI builds it for `pipeline` and `cohort`, feeds it the traffic's
pool of distinct knees in a closed loop, and judges the knees sampled from
the seed against the plain reference (`portbench/reference/knee.py`,
`thickness.py`).

Set-up (counted in `setup_s`): the segmenter's weights drawn on the card
from the seed and handed over as a weights file in TMPDIR (the segmenter
reads weights from a file only), the shipped GradICON weights read by the
program itself, the pool and the atlas made on the card, one warm-up
knee. The window starts whole knees until `--seconds` have passed and
finishes the knee in flight; with `--trace 1` the traffic's `trace_knees`
knees run under the profiler after it. The program's segment and register outputs
are caught at the layer boundary (`segmenter.segment`,
`registerer.register`) for the sampled knees only. A configuration value
that the program does not run as stated refuses the run
(`honour_settings`)."""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

from portbench import gen, roofline
from portbench.harness import Cell, Run

STAGES = ("segment", "register", "warp", "thickness")


def _unet_blocks(spec: dict) -> List[tuple]:
    """[(block, kernel shape DHWIO)] of the UNet in the weights file's order."""
    enc, dec = spec["enc"], spec["dec"]
    blocks = []
    cin = spec["in_channels"]
    for li, (ca, cb) in enumerate(enc):
        blocks += [(f"enc{li}a", (3, 3, 3, cin, ca)), (f"enc{li}b", (3, 3, 3, ca, cb))]
        cin = cb
    cur = enc[-1][1]
    for li, (cu, c1, c2) in enumerate(dec):
        skip = enc[len(enc) - 2 - li][1]
        blocks += [(f"dec{li}up", (2, 2, 2, cur, cu)), (f"dec{li}a", (3, 3, 3, cu + skip, c1)),
                   (f"dec{li}b", (3, 3, 3, c1, c2))]
        cur = c2
    blocks.append(("head", (1, 1, 1, dec[-1][2], spec["n_classes"])))
    return blocks


def segmenter_weights(spec: dict, wcfg: dict, seed: int, device) -> dict:
    """The UNet's weights (JAX layout: DHWIO kernels, biases; numpy f32),
    drawn on `device` from the seed in one call. Channel 0 is a threshold
    path: identity centre taps input -> enc0a -> enc0b -> the last
    decoder's skip -> its a and b convs, and the head's `gain` and shift
    make it sigmoid(gain (x - threshold)) per class. Every other output
    channel of every conv and upconv is dense: He-normal (std sqrt(2 /
    fan-in)) times `dense_gain` on every tap and input channel, so each
    level's convs reach the logits through the last decoder's other
    channels, which the head weighs with N(0, head_scale^2 / (C - 1))."""
    import torch

    blocks = _unet_blocks(spec)
    last = len(spec["dec"]) - 1
    path_in = {"enc0a": 0, "enc0b": 0, f"dec{last}a": spec["dec"][last][0], f"dec{last}b": 0}
    sizes = [int(np.prod(s)) for _, s in blocks]
    g = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + 11) % (2**63 - 1))
    draws = torch.randn(sum(sizes), generator=g, device=device).cpu().numpy()
    gain, thr = float(wcfg["gain"]), float(wcfg["threshold"])
    params, at = {}, 0
    for (name, shape), n in zip(blocks, sizes):
        k = draws[at : at + n].reshape(shape).astype(np.float32)
        at += n
        bias = np.zeros(shape[-1:], np.float32)
        if name == "head":
            k *= wcfg["head_scale"] / np.sqrt(max(shape[3] - 1, 1))
            k[..., 0, :] = gain
            bias[:] = -gain * thr
        else:
            fan_in = shape[3] * (1 if name.endswith("up") else shape[0] * shape[1] * shape[2])
            k *= wcfg["dense_gain"] * np.sqrt(2.0 / fan_in)
            if name in path_in:
                k[..., 0] = 0.0
                k[1, 1, 1, path_in[name], 0] = 1.0
        params[name] = {"kernel": k, "bias": bias}
    return params


def _write_segmenter_files(cfg: dict, params: dict, folder: str):
    """The weights as a native npz and the training config the segmenter
    reads, in `folder`."""
    seg = cfg["segmenter"]
    flat = {f"params/{b}/{k}": v for b, leaves in params.items() for k, v in leaves.items()}
    ckpt = os.path.join(folder, "segmentation_model.npz")
    np.savez(ckpt, __meta__=json.dumps({"epoch": 0}), **flat)
    tcfg = os.path.join(folder, "segmentation_train_config.json")
    with open(tcfg, "w") as f:
        json.dump({"patch_size": seg["training_patch_xyz"], "model": seg["unet"]["name"],
                   "model_setting": {"in_channels": seg["unet"]["in_channels"],
                                     "n_classes": seg["unet"]["n_classes"], "bias": True, "BN": False}}, f)
    return ckpt, tcfg


def build_segmenter(cfg: dict, device, seg_params: dict):
    """The segmenter as the CLI builds it, with the benchmark's weights."""
    from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise

    seg_cfg = cfg["segmenter"]
    folder = tempfile.mkdtemp(prefix="portbench_")
    try:
        ckpt, tcfg = _write_segmenter_files(cfg, seg_params, folder)
        segmenter = Segmenter3DInPatchClassWise(mode="pred", config={
            "ckpoint_path": ckpt, "training_config_file": tcfg, "batch_size": seg_cfg["batch_size"],
            "overlap_size": tuple(seg_cfg["overlap_xyz"]), "output_prob": True, "output_itk": True,
            "compute_dtype": seg_cfg["compute_dtype"], "device": device})
        segmenter.pred_setup()
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return segmenter


def make_pipeline(cfg: dict, device, segmenter, atlas_image):
    """`KneePipeline` as the CLI's `pipeline` and `cohort` build it."""
    from oai_analysis_2_tpu_torch.engine.pipeline import KneePipeline

    reg = cfg["registration"]
    ft = reg["finetune"]
    return KneePipeline(segmenter, atlas_image, registration_config=None, registration_mode=reg["mode"],
                        finetune_steps=ft["steps"], finetune_scales=tuple(ft["scales"]), finetune_lr=ft["lr"],
                        warp_dtype=cfg["warp_dtype"], device=device)


def _program_values(pipe) -> Dict[str, object]:
    """The program's own value of each configuration key that the pipeline
    takes from the program's defaults rather than from its caller."""
    import inspect

    from oai_analysis_2_tpu_torch.engine import registration
    from oai_analysis_2_tpu_torch.mesh import ops as mesh_ops
    from oai_analysis_2_tpu_torch.mesh import processing, split
    from oai_analysis_2_tpu_torch.models import gradicon
    from oai_analysis_2_tpu_torch.ops import clustering

    def default(fn, name):
        return inspect.signature(fn).parameters[name].default

    rc = pipe.reg_config
    return {
        "preprocess.percentiles": [0.1, 99.9] if pipe.normalize else None,  # KneePipeline.run's window
        "registration.grid_shape": list(rc.grid_shape), "registration.scales": list(rc.scales),
        "registration.stage_width": rc.stage_width, "registration.lncc_window": rc.lncc_window,
        "registration.displacement_scale": rc.displacement_scale,
        "registration.finetune.similarity": default(gradicon.register_pair_instance, "similarity"),
        "registration.finetune.mse_weight": default(gradicon.make_similarity, "mse_weight"),
        "registration.finetune.lambda_reg": default(registration.register_pair, "lambda_reg"),
        "registration.finetune.diffusion_weight": default(registration.register_pair, "diffusion_weight"),
        "registration.finetune.image_dtype": "bfloat16",  # InstanceScale warps its images in bf16 only
        "thickness.level": default(processing.get_thickness_meshes, "level"),
        "thickness.filter_threshold": default(processing.get_thickness_meshes, "filter_threshold"),
        "thickness.iterations": default(processing.get_thickness_meshes, "num_iterations"),
        "thickness.relaxation": default(mesh_ops.smooth_meshes, "relaxation"),
        "thickness.femoral_divisions": default(split._femoral_problems, "num_divisions"),
        "thickness.kmeans_iterations": default(clustering.kmeans_many, "n_iter"),
    }


def _at(cfg: dict, key: str):
    for part in key.split("."):
        cfg = cfg[part]
    return cfg


def honour_settings(cfg: dict, pipe):
    """Hands the pipeline the settings it takes from outside its
    constructor (the fine-tuning's GradICON gradient, the k-means backend)
    and refuses the run where the configuration states a value that the
    program runs otherwise: the reference follows the configuration."""
    from portbench.harness import NoResult

    pipe.registerer.gicon_grad = cfg["registration"]["finetune"]["gicon_grad"]
    os.environ["OAI_TPU_KMEANS_BACKEND"] = cfg["thickness"]["kmeans_backend"]
    for key, value in _program_values(pipe).items():
        want = _at(cfg, key)
        if value != want:
            raise NoResult(f"the configuration states {key} = {want!r}, the program runs {value!r}")


def image(cfg: dict, data):
    from oai_analysis_2_tpu_torch.core.image import image_from_array

    return image_from_array(data, spacing=tuple(cfg["spacing_xyz"]), device=data.device)


class Catch:
    """Keeps the last outputs of the pipeline's segmenter, the registration
    network (its two maps before the fine-tuning) and the registerer, the
    layer boundaries the comparison reads, and marks each layer's call with
    a profiler span `layer:<name>` (segment, register, warp, thickness) that
    labels the trace's idle gaps."""

    def __init__(self, pipe):
        from oai_analysis_2_tpu_torch.engine import pipeline as pipeline_mod

        self.last: Dict[str, object] = {}
        seg_fn, reg_fn = pipe.segmenter.segment, pipe.registerer.register
        pipe.segmenter.segment = self._span("segment", seg_fn, keep=True)
        pipe.registerer.register = self._span("register", reg_fn, keep=True)
        net_fn = pipe.registerer.model.both_maps
        pipe.registerer.model.both_maps = lambda *a, **k: self._keep("network", net_fn(*a, **k))
        for layer, attr in (("warp", "resample_images"), ("thickness", "get_thickness_meshes")):
            fn = getattr(pipeline_mod, attr)
            setattr(pipeline_mod, attr, self._span(layer, getattr(fn, "__wrapped_layer__", fn)))

    def _span(self, layer: str, fn, keep: bool = False):
        from torch.profiler import record_function

        def call(*a, **k):
            with record_function(f"layer:{layer}"):
                out = fn(*a, **k)
            return self._keep(layer, out) if keep else out

        call.__wrapped_layer__ = fn
        return call

    def _keep(self, layer: str, out):
        self.last[layer] = out
        return out

    def take(self) -> Dict[str, object]:
        out, self.last = self.last, {}
        return out


def outputs_of(caught: dict, result) -> dict:
    """What the comparison judges, from the program's run of one knee."""
    fc, tc = caught["segment"]
    return {
        "maps": [fc.data, tc.data],
        "net": caught["network"],
        "disp": caught["register"].field,
        "warped": [result.fc_probmap.data, result.tc_probmap.data],
        "inner": {"FC": (np.asarray(result.fc_inner.vertices), np.asarray(result.fc_inner.point_data)),
                  "TC": (np.asarray(result.tc_inner.vertices), np.asarray(result.tc_inner.point_data))},
    }


def _segment_altered(pipe):
    model = pipe.segmenter.model
    orig = model.forward
    model.forward = lambda x, *a, **k: orig(x, *a, **k) + 0.5


def _tap_swapped(pipe):
    """The first decoder's a conv reads its z-neighbour taps the wrong way
    round (an off-centre tap mis-indexed)."""
    import torch

    k = pipe.segmenter.model.dec0a.kernel
    with torch.no_grad():
        k.copy_(k.flip(0))


def _map_altered(pipe):
    model = pipe.registerer.model
    orig = model.forward_map
    model.forward_map = lambda a, b: orig(a, b) + 0.002


# Faults planted under the timed path (tests and calibration only): an
# answer altered where it is produced, in the segmentation's logits or the
# network's map; a deep conv with a tap wrong. The thickness's
# is planted by the tests themselves.
FAULTS = {"segment_altered": _segment_altered, "tap_swapped": _tap_swapped, "map_altered": _map_altered}


# ---------------------------------------------------------------------------
# Work counted from shapes
# ---------------------------------------------------------------------------


def segment_work(cfg: dict) -> dict:
    """Per knee: the UNet's 3x3x3 convs on the stated tiles ({"all", "sm90"}:
    each a (flops, bytes, dtype) list), and its upconvs and head as f32
    products of the compute-type operands."""
    seg = cfg["segmenter"]
    u = seg["unet"]
    tile = seg["tile_zyx"]
    ox, oy, oz = seg["overlap_xyz"]
    eff = [t - 2 * o for t, o in zip(tile, (oz, oy, ox))]
    n_tiles = int(np.prod([-(-s // e) for s, e in zip(cfg["knee_shape_zyx"], eff)]))
    dt = seg["compute_dtype"]
    all_, sm90, pw = [], [], []
    for _name, level, cin, cout in roofline.unet_convs(u["enc"], u["dec"], u["in_channels"]):
        f, b = roofline.conv3x3_work(roofline.level_voxels(tile, level), cin, cout, dt)
        item = (f * n_tiles, b * n_tiles, dt)
        all_.append(item)
        if roofline.sm90_takes(cin, cout):
            sm90.append(item)
    for _name, level, cin, cout in roofline.unet_pointwise(u["enc"], u["dec"], u["n_classes"]):
        pw.append((roofline.pointwise_work(roofline.level_voxels(tile, level), cin, cout) * n_tiles, 0.0,
                   seg["pointwise_dtype"]))
    return {"all": all_, "sm90": sm90, "pointwise": pw, "sm90_launches": len(sm90) * n_tiles}


def gradicon_forward_work(reg: dict) -> List[tuple]:
    """(flops, bytes, dtype) of the network's convs and products for both
    directions of one pair."""
    from portbench.reference.knee import stage_spec

    enc, dec = stage_spec(reg["stage_width"])
    items = []
    for scale in reg["scales"]:
        shape = [s // scale for s in reg["grid_shape"]]
        for _n, level, cin, cout in roofline.unet_convs(enc, dec, 2):
            f, b = roofline.conv3x3_work(roofline.level_voxels(shape, level), cin, cout, reg["compute_dtype"])
            items.append((2 * f, 2 * b, reg["compute_dtype"]))
        for _n, level, cin, cout in roofline.unet_pointwise(enc, dec, 3):
            items.append((2 * roofline.pointwise_work(roofline.level_voxels(shape, level), cin, cout), 0.0,
                          "float32"))
    return items


def distance_work(result) -> List[tuple]:
    """The four distance calls of a knee: each tissue's inner points to its
    outer surface and back."""
    items = []
    for inner, outer in ((result.fc_inner, result.fc_outer), (result.tc_inner, result.tc_outer)):
        for pts, tgt in ((inner, outer), (outer, inner)):
            if pts.n_points and tgt.n_cells:
                f, b = roofline.distance_work(pts.n_points, tgt.n_cells)
                items.append((f, b, "float32"))
    return items


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def run(cell: Cell, fault=None) -> Run:
    """`fault` (tests only): a function applied to the pipeline after
    set-up, which breaks the timed path underneath."""
    import torch

    from oai_analysis_2_tpu_torch.ops import cuda_conv, cuda_kernels
    from portbench.harness import Trace
    from portbench.reference import gradicon_stages, judge_knee

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    seg_params = segmenter_weights(cfg["segmenter"]["unet"], cfg["segmenter"]["weights"], cell.seed, dev)
    segmenter = build_segmenter(cfg, dev, seg_params)
    knees = gen.knee_pool(cfg, tr, cell.seed, dev)
    atlas_data = gen.atlas(cfg, cell.seed, dev)
    pipe = make_pipeline(cfg, dev, segmenter, image(cfg, atlas_data))
    honour_settings(cfg, pipe)
    catch = Catch(pipe)
    for i in range(tr["warmup_knees"]):
        pipe.run(image(cfg, knees[i % len(knees)]))
    catch.take()
    if fault is not None:
        fault(pipe)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - cell.t_start

    corr = cfg["correctness"]
    rng = np.random.default_rng(cell.seed)
    sample = set(int(v) for v in rng.choice(corr["check_from_first"], size=corr["check_knees"], replace=False))
    kept, knee_s, stages = [], [], {s: [] for s in STAGES}
    completed = 0
    failed = 0
    traced = {"n": 0, "dist": []}

    def one_knee(i: int, tracing: bool):
        """Knee i of the pool's order through the pipeline; its seconds and
        stage times are kept where no profiler ran in the process (the
        profiler slows the host while it runs and after)."""
        nonlocal failed, completed
        k = i % len(knees)
        ts = time.perf_counter()
        try:
            result = pipe.run(image(cfg, knees[k]))
        except Exception as e:  # noqa: BLE001 — a knee that fails counts as failed
            failed += 1
            print(f"knee {i} failed: {e!r}", flush=True)
            result = None
        t_end = time.perf_counter()
        caught = catch.take()
        if result is not None:
            completed += 1
            if tracing:
                traced["n"] += 1
                traced["dist"] += distance_work(result)
            else:
                knee_s.append(t_end - ts)
                for st in STAGES:
                    stages[st].append(result.timings[st]["seconds"])
            if i in sample:
                kept.append((k, outputs_of(caught, result)))
        return t_end

    t_wall = time.time()
    t0 = time.perf_counter()
    t_last = t0
    i = 0
    while i == 0 or t_last - t0 < cell.seconds:
        t_last = one_knee(i, False)
        i += 1
    window_s, timed = t_last - t0, completed
    if cell.trace:  # after the timed knees, which no profiler slowed
        tracer = Trace()
        cuda_conv.reset_launches()
        n_dist0 = cuda_kernels.point_triangle_min_d2.launches
        tracer.__enter__()
        for _ in range(tr["trace_knees"]):
            one_knee(i, True)
            i += 1
        tracer.__exit__(None, None, None)
        traced["launches_sm90"] = cuda_conv.conv3d.launches_sm90
        traced["launches_dist"] = cuda_kernels.point_triangle_min_d2.launches - n_dist0
    print("window: " + json.dumps({"knees": timed, "seconds": round(window_s, 4), "at": round(t_wall, 3),
                                   "knee_s": roofline.spread_summary(knee_s),
                                   "stage_means": {s: round(float(np.mean(v)), 4) for s, v in stages.items() if v}}),
          file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    metrics = {"unit_of_work": "knees", "setup_s": setup_s, "window": {"completed": timed, "seconds": window_s},
               "knee_seconds": knee_s, "stages": stages}
    if cell.trace:
        red = tracer.reduce()
        seg_w = segment_work(cfg)
        red.update(traced_items=traced["n"], launches_sm90=traced["launches_sm90"],
                   expected_sm90=seg_w["sm90_launches"] * traced["n"],
                   sm90_work=roofline.sum_work(seg_w["sm90"] * traced["n"]),
                   dist_work=roofline.sum_work(traced["dist"]), launches_dist=traced["launches_dist"],
                   expected_dist=len(traced["dist"]),
                   model_work=roofline.sum_work((seg_w["all"] + seg_w["pointwise"]
                                                 + gradicon_forward_work(cfg["registration"])) * traced["n"]))
        metrics["trace"] = red

    # the program's state is freed before the reference runs
    del pipe, segmenter, catch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    worst: Dict[str, float] = {}
    stages_ref = gradicon_stages(cfg, dev)
    for k, out in kept:
        for name, value in judge_knee(cfg, knees[k], atlas_data, out, seg_params, stages_ref).items():
            worst[name] = max(worst.get(name, 0.0), value)
    # no sampled knee judged leaves no check, and the run is not correct
    checks = [(name, worst[name], float(corr["limits"][name])) for name in corr["limits"]] if kept else []
    return Run(metrics=metrics, checks=checks, attempted=i, failed=failed, memory_peak_bytes=peak,
               details={"checked_knees": [k for k, _ in kept], "readings": worst})


def control(cell: Cell) -> dict:
    """The numbers compared when the reference, one precision below the
    configuration's in each stage (the configuration's `control`), stands
    in the program's place, for the first knee the seed samples."""
    from portbench.reference import gradicon_stages, judge_knee, knee_outputs

    cfg, dev = cell.config, cell.device
    corr = cfg["correctness"]
    seg_params = segmenter_weights(cfg["segmenter"]["unet"], cfg["segmenter"]["weights"], cell.seed, dev)
    knees = gen.knee_pool(cfg, cell.traffic, cell.seed, dev)
    atlas_data = gen.atlas(cfg, cell.seed, dev)
    rng = np.random.default_rng(cell.seed)
    first = int(min(rng.choice(corr["check_from_first"], size=corr["check_knees"], replace=False)))
    k = first % len(knees)
    stages = gradicon_stages(cfg, dev)
    out = knee_outputs(cfg, knees[k], atlas_data, seg_params, corr["control"], stages)
    return judge_knee(cfg, knees[k], atlas_data, out, seg_params, stages)
