"""Knee-batched inference (port of `oai_analysis_2_tpu/parallel/batch.py:64-508`).

B knees that share volume shape and physical metadata go through the
device stages together: percentile windowing per knee, segmentation with
the knees in the UNet's conv batch (`volume_fn_batched(n_knees, ...)`),
then registration against the shared atlas and the probability-map warp,
one knee after another (the JAX package's `lax.map`). The thickness meshes
of the whole batch come from one `get_thickness_meshes` call, one knee's
FC + TC per smoothing group.

With `mesh=None` the batch runs on `device` (None: the card). With a
`parallel.sharding` mesh every rank makes the same call with the same
knees: the batch is padded to a multiple of the mesh's data axis (as the
JAX package pads it), each rank runs the device stages and the thickness
meshes of its own block of knees on its own card, and the warped maps,
displacement fields and meshes are gathered, so that every rank returns
the whole batch. The rank split is the JAX package's placement of knee i's
smoothing, distance and marching cubes on chip i; each rank also runs its
own knees' host work (the thickness stage's k-means), which the JAX
package runs in series in one process.

All device work of a rank is queued on its card's current stream, where
JAX's software pipeline of `run_batches` (batch k+1's device stages
dispatched before batch k's thickness) has nothing to overlap: it runs the
batches one after another.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.core.image import Image, physical_grid
from oai_analysis_2_tpu_torch.engine.pipeline import KneeResult
from oai_analysis_2_tpu_torch.engine.registration import ICON_Registration, _net_grid_reference, register_pair
from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise
from oai_analysis_2_tpu_torch.mesh.processing import get_thickness_meshes
from oai_analysis_2_tpu_torch.models.gradicon import GradICONConfig
from oai_analysis_2_tpu_torch.ops.intensity import _percentiles
from oai_analysis_2_tpu_torch.ops.resample import (
    DisplacementField,
    _separable_resize_weights,
    _trilinear_gather,
    _upsample_field_separable,
    sample_displacement,
)
from oai_analysis_2_tpu_torch.parallel.sharding import gather_slots, mesh_device
from oai_analysis_2_tpu_torch.utils.profiling import StageTimer


def _window_knee(knee: torch.Tensor) -> torch.Tensor:
    """The batch's percentile window (JAX `parallel/batch.py:248-252`):
    `clip((knee - lo) / max(hi - lo, 1e-20), 0, 1)` with the 0.1 / 99.9
    percentiles as JAX's batch program folds them (`_percentiles(...,
    folded=True)`), which can differ from `percentile_window`'s at a
    knee's size, as JAX's two windows differ."""
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=knee.device)
              for v in _percentiles(knee, (0.1, 99.9), folded=True))
    return torch.clamp((knee - lo) / torch.clamp(hi - lo, min=1e-20), 0.0, 1.0)


class BatchKneePipeline:
    """segment + register + warp for B knees, plus the batch's thickness
    meshes, on one device or split over the data axis of a mesh
    (`parallel.sharding.make_device_mesh`; the rank's card is its device,
    and `device` is not read)."""

    def __init__(
        self,
        segmenter: Segmenter3DInPatchClassWise,
        atlas_image: Image,
        mesh=None,
        registration_config: GradICONConfig = None,
        registration_mode: str = "auto",
        instance_scales: Tuple[int, ...] = (4, 2, 1),
        instance_steps=(80, 60, 40),
        finetune_steps: int = 0,
        finetune_scales: Tuple[int, ...] = (2,),
        finetune_lr: float = 0.15,
        lambda_reg: float = 0.5,
        diffusion_weight: float = 0.3,
        normalize: bool = True,
        warp_dtype: str = "float32",
        max_batch_per_device: int = 2,
        device=None,
    ):
        """max_batch_per_device: the most knees one pass of the device stages
        holds on one device (the segmenter's padded volumes, tile batch and
        canvases grow with it); a larger batch runs in chunks of that many
        times `n_devices`, with the same results."""
        if warp_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"warp_dtype must be 'float32' or 'bfloat16', got {warp_dtype!r}")
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh_device(mesh)
        self.segmenter = segmenter
        self.atlas = atlas_image.to(self.device)
        self.instance_scales = tuple(instance_scales)
        self.instance_steps = instance_steps
        self.finetune_steps = finetune_steps
        self.finetune_scales = tuple(finetune_scales)
        self.finetune_lr = finetune_lr
        self.lambda_reg = lambda_reg
        self.diffusion_weight = diffusion_weight
        self.normalize = normalize
        self.warp_dtype = warp_dtype
        self.max_batch_per_device = max(int(max_batch_per_device), 1)
        self.registerer = ICON_Registration(
            mode=registration_mode, config=registration_config,
            instance_steps=instance_steps, instance_scales=instance_scales,
            finetune_steps=finetune_steps, finetune_scales=finetune_scales, finetune_lr=finetune_lr,
            device=self.device,
        )
        self.reg_config = self.registerer.config
        self._geometries: dict = {}  # _meta_key -> what batches of that geometry share
        self._seg_fns: dict = {}  # (volume shape, n_knees) -> the batched segmenter

    @property
    def n_devices(self) -> int:
        """The ranks a batch is split over: the mesh's data axis."""
        return 1 if self.mesh is None else self.mesh.size(0)

    def _own_knees(self, n: int) -> List[int]:
        """The indices of the knees of an n-knee batch that this rank runs:
        in each chunk of m knees, padded to k * n_devices, the data-axis
        rank d takes the real knees of the d-th block of k."""
        if self.mesh is None:
            return list(range(n))
        d = self.mesh.get_coordinate()[0]
        chunk = self.max_batch_per_device * self.n_devices
        own = []
        for start in range(0, n, chunk):
            m = min(chunk, n - start)
            k = -(-m // self.n_devices)
            own += range(start + d * k, start + min((d + 1) * k, m))
        return own

    @staticmethod
    def _meta_key(image: Image) -> tuple:
        return (tuple(image.shape),) + tuple(
            t.detach().cpu().numpy().tobytes() for t in (image.origin, image.spacing, image.direction)
        )

    def _geometry(self, template: Image) -> dict:
        """The template geometry's registration-grid indices, the atlas on
        its registration grid, the atlas's physical points and the
        separable upsample's weights, computed once per geometry."""
        key = self._meta_key(template)
        if key not in self._geometries:
            cfg = self.reg_config

            def grid_to_idx(img: Image) -> torch.Tensor:
                grid = _net_grid_reference(img, cfg.grid_shape)
                pts = physical_grid(grid.shape, grid.origin, grid.spacing, grid.direction)
                return img.physical_to_indices(pts).flip(-1)

            # register_pair's displacement lives on the atlas's registration
            # grid; its upsample is separable where that grid and the atlas
            # are axis-aligned (every real OAI case)
            grid_b = _net_grid_reference(self.atlas, cfg.grid_shape)
            field_grid = DisplacementField(grid_b.data, grid_b.origin, grid_b.spacing, grid_b.direction)
            self._geometries[key] = dict(
                idx_a=grid_to_idx(template),  # registration-grid voxel -> knee zyx index
                b=_trilinear_gather(self.atlas.data.to(torch.float32), grid_to_idx(self.atlas), 0.0),
                pts_atlas=physical_grid(self.atlas.shape, self.atlas.origin, self.atlas.spacing,
                                        self.atlas.direction),
                sep_weights=_separable_resize_weights(field_grid, self.atlas),
            )
        return self._geometries[key]

    def _seg_fn(self, shape: tuple, n_knees: int):
        """The segmenter with `n_knees` knees in its conv batch, as the JAX
        package runs it (not vmap)."""
        key = (tuple(shape), n_knees)
        if key not in self._seg_fns:
            seg = self.segmenter
            if not seg.ready:
                seg.pred_setup()
            self._seg_fns[key] = seg.volume_fn_batched(n_knees, tuple(shape),
                                                       int(seg.config.get("batch_size", 4)), threshold=False)
        return self._seg_fns[key]

    def _register_warp(self, template: Image, pre: torch.Tensor, maps: torch.Tensor):
        """Register each knee to the atlas and warp its maps, one knee after
        another (JAX: lax.map): (warped (B, Da, Ha, Wa, C), disp (B, gz, gy,
        gx, 3))."""
        geo = self._geometry(template)
        reg = self.registerer
        wdt = torch.bfloat16 if self.warp_dtype == "bfloat16" else torch.float32
        warped, disps = [], []
        for pre_k, maps_k in zip(pre, maps):
            # JAX's batch settings: the network (+ fine-tuning) or instance
            # optimization at its default lr, no early stop
            phi, _ = register_pair(
                template, self.atlas, model=reg.model if reg.mode == "network" else None, config=self.reg_config,
                instance_steps=self.instance_steps, instance_scales=self.instance_scales,
                lambda_reg=self.lambda_reg, diffusion_weight=self.diffusion_weight,
                finetune_steps=self.finetune_steps, finetune_scales=self.finetune_scales,
                finetune_lr=self.finetune_lr, a_on_grid=_trilinear_gather(pre_k, geo["idx_a"], 0.0),
                b_on_grid=geo["b"],
            )
            with torch.no_grad():
                if geo["sep_weights"] is not None:
                    up = _upsample_field_separable(phi.field, *geo["sep_weights"])
                else:
                    up = sample_displacement(phi, geo["pts_atlas"])
                idx_knee = template.physical_to_indices(geo["pts_atlas"] + up).flip(-1)
                stacked = maps_k.permute(1, 2, 3, 0).to(wdt)  # (D, H, W, C)
                warped.append(_trilinear_gather(stacked, idx_knee, 0.0).to(torch.float32))
            disps.append(phi.field)
        return torch.stack(warped), torch.stack(disps)

    def run_device_batch(self, images: Sequence[Image]):
        """The device stages alone: B knees -> (warped (B, Da, Ha, Wa, C),
        disp (B, gz, gy, gx, 3)) as numpy arrays."""
        warped, disp = self._dispatch_device_batch(images)
        return warped.cpu().numpy(), disp.cpu().numpy()

    def _zeros(self, n: int):
        """(warped, disp) of n knees, all zero: correctly ranked empties, and
        the rows of padding knees."""
        if not self.segmenter.ready:
            self.segmenter.pred_setup()
        c = self.segmenter.model.spec.n_classes
        return (torch.zeros((n,) + self.atlas.shape + (c,), device=self.device),
                torch.zeros((n,) + tuple(self.reg_config.grid_shape) + (3,), device=self.device))

    def _dispatch_device_batch(self, images: Sequence[Image]):
        """The device stages of a batch: (warped, disp) left on the device;
        on a mesh, the whole batch's on every rank."""
        if not images:
            return self._zeros(0)
        chunk = self.max_batch_per_device * self.n_devices
        if len(images) > chunk:
            outs = [self._dispatch_device_batch(images[i : i + chunk]) for i in range(0, len(images), chunk)]
            return torch.cat([w for w, _ in outs]), torch.cat([d for _, d in outs])
        if len({self._meta_key(im) for im in images}) != 1:
            raise ValueError("all knees in a batch must share volume shape and physical metadata; got "
                             f"{len({self._meta_key(im) for im in images})} distinct geometries")
        own = [images[i] for i in self._own_knees(len(images))]
        if own:
            template = own[0].to(self.device)
            # knees already on the device are stacked there, not through the host
            knees = [template.with_data(im.data.to(device=self.device, dtype=torch.float32)) for im in own]
            pre = torch.stack([_window_knee(k.data) if self.normalize else k.data for k in knees])
            maps = self._seg_fn(template.shape, len(own))(pre)
            warped, disp = self._register_warp(template, pre, maps)
        if self.mesh is None:
            return warped, disp
        # every rank's block padded to k knees, gathered over the data axis
        k = -(-len(images) // self.n_devices)
        pad_w, pad_d = self._zeros(k - len(own))
        if own:
            pad_w, pad_d = torch.cat([warped, pad_w]), torch.cat([disp, pad_d])
        group = self.mesh.get_group("data")
        return tuple(gather_slots(t, group).flatten(0, 1)[: len(images)] for t in (pad_w, pad_d))

    def run_batch(self, images: Sequence[Image], compute_thickness: bool = True) -> List[KneeResult]:
        """Device stages and the batch's thickness meshes."""
        timer = StageTimer(self.device)
        with timer.stage("device_batch"):
            warped, _ = self._dispatch_device_batch(images)
        return self._finish_batch(images, warped, compute_thickness, timer)

    def run_batches(self, batches: Sequence[Sequence[Image]],
                    compute_thickness: bool = True) -> List[List[KneeResult]]:
        """`run_batch` on each batch in order (JAX's pipeline overlaps batch
        k's thickness with batch k+1's device stages; on one stream nothing
        overlaps)."""
        return [self.run_batch(b, compute_thickness) for b in batches]

    def _finish_batch(self, images: Sequence[Image], warped: torch.Tensor, compute_thickness: bool,
                      timer: StageTimer) -> List[KneeResult]:
        """The warped maps as atlas-grid images and the batch's thickness
        meshes from one call (one knee's FC + TC per smoothing group)."""
        probmaps = []
        for i in range(len(images)):
            fc = self.atlas.with_data(warped[i, ..., 0])
            probmaps.append((fc, fc.with_data(warped[i, ..., 1])))
        if compute_thickness:
            sub: dict = {}
            own = self._own_knees(len(images))
            with timer.stage("thickness_batch"):
                pairs = get_thickness_meshes([m for i in own for m in probmaps[i]], ["FC", "TC"] * len(own),
                                             group_size=2, timings_out=sub)
                if self.mesh is not None:  # every rank's knees' meshes, host objects, to every rank
                    got = [None] * self.n_devices
                    dist.all_gather_object(got, dict(zip(own, zip(pairs[0::2], pairs[1::2]))),
                                           group=self.mesh.get_group("data"))
                    by_knee = {i: pair for part in got for i, pair in part.items()}
                    pairs = [m for i in range(len(images)) for m in by_knee[i]]
            for name, secs in sub.items():
                timer.totals[f"thickness_{name}"] += secs
                timer.counts[f"thickness_{name}"] += 1
        else:
            pairs = [(None, None)] * (2 * len(images))
        return [
            KneeResult(fc_probmap=fc, tc_probmap=tc, fc_inner=pairs[2 * i][0], fc_outer=pairs[2 * i][1],
                       tc_inner=pairs[2 * i + 1][0], tc_outer=pairs[2 * i + 1][1], timings=timer.report())
            for i, (fc, tc) in enumerate(probmaps)
        ]
