"""Multi-card parallelism (port of `oai_analysis_2_tpu/parallel/sharding.py`):
a (data, space) device mesh, sharded training and tile-parallel inference.

The JAX package runs one program over a `jax.sharding.Mesh` and lets XLA
place the collectives. Here every card has its own process (one rank of a
`torch.distributed` process group, started by `torchrun --nproc-per-node N`
or the caller), and every rank makes the same calls with the same global
arguments: the host work of a step (the GradICON loop's launches, the
thickness stage's k-means) then runs once per card, in parallel, where one
process driving N cards would run it N times in series.

  * `data` axis: each rank takes its block of the batch's dimension 0;
    the parameter gradients are summed over the mesh and divided by the
    data axis's size, so every rank makes the same optimizer step.
  * `space` axis: each rank takes its block of the volume's z axis; the
    UNet's 3x3x3 convs read one z-plane from each neighbouring rank (`ZHalo`,
    what GSPMD inserts for the JAX package).

On device tensors the port uses `all_reduce` and `broadcast` alone, the
two collectives that NCCL and gloo both offer on CUDA tensors: a gather is
an `all_reduce` of a zero buffer with one slot per rank. The conv runs the
port's own kernels (`ops.cuda_conv`), for which DTensor has no sharding
rule, so no DTensor is used. The backend is the caller's choice
(`init_process_group`); the port never switches it.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from oai_analysis_2_tpu_torch.engine.training import dice_bce_loss
from oai_analysis_2_tpu_torch.models.gradicon import make_gradicon_train_step
from oai_analysis_2_tpu_torch.utils import optim


def make_device_mesh(n_data: Optional[int] = None, n_space: int = 1, devices=None, device_type: str = "cuda"):
    """A `DeviceMesh` of shape (n_data, n_space), dimensions ("data",
    "space"), over the ranks of the initialized process group (n_data=None:
    world size // n_space). Every rank calls it. With `device_type="cuda"`
    it makes this rank's card current: `devices[local_rank % len(devices)]`,
    `devices` being the node's card indices (default: every visible card)
    and the local rank torchrun's `LOCAL_RANK` (else the global rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_device_mesh needs an initialized process group (torch.distributed."
                           "init_process_group); every rank calls it")
    world = dist.get_world_size()
    n_data = world // n_space if n_data is None else n_data
    if n_data * n_space != world:
        # every rank takes part in each sharded step: none can sit out
        raise ValueError(f"a {n_data} x {n_space} mesh needs {n_data * n_space} ranks; the process group has {world}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device_type='cpu' to build a mesh of CPU ranks")
        cards = list(range(torch.cuda.device_count())) if devices is None else [torch.device(d).index or 0
                                                                                for d in devices]
        local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(cards[local_rank % len(cards)])
    elif device_type != "cpu":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    return init_device_mesh(device_type, (n_data, n_space), mesh_dim_names=("data", "space"))


def mesh_device(mesh) -> torch.device:
    """This rank's device on `mesh`: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _flat_index(mesh) -> int:
    """This rank's place on the mesh flattened row-major (JAX's
    `mesh.devices.reshape(-1)`)."""
    d, s = mesh.get_coordinate()
    return d * mesh.size(1) + s


def _block(t: torch.Tensor, axis: int, parts: int, index: int, what: str) -> torch.Tensor:
    if t.shape[axis] % parts:
        raise ValueError(f"{what}: axis {axis} of size {t.shape[axis]} does not split into {parts} equal blocks")
    size = t.shape[axis] // parts
    return t.narrow(axis, index * size, size)


def shard_batch(mesh, batch, spatial_axis: Optional[int] = None) -> torch.Tensor:
    """This rank's block of the global `batch` (an array or tensor that every
    rank passes): dimension 0 split over `data`, and `spatial_axis` over
    `space`, by the rank's mesh coordinate, on the rank's device. An axis
    that does not split evenly raises (as JAX's `device_put` does)."""
    d, s = mesh.get_coordinate()
    t = _block(torch.as_tensor(batch), 0, mesh.size(0), d, "shard_batch")
    if spatial_axis is not None:
        t = _block(t, spatial_axis, mesh.size(1), s, "shard_batch")
    return t.to(mesh_device(mesh)).contiguous()


def replicate(mesh, tree):
    """Rank 0's values on every rank: an `nn.Module`'s parameters and buffers
    in place (the module is returned), or a tree (dicts, lists, tuples) of
    arrays or tensors, returned as tensors on the rank's device."""
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                dist.broadcast(t.data, src=0)
        return tree
    dev = mesh_device(mesh)

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(dev).clone().contiguous()
        dist.broadcast(t, src=0)
        return t

    return one(tree)


def gather_slots(x: torch.Tensor, group) -> torch.Tensor:
    """(group size, *x.shape): rank i's `x` in slot i, on every rank of
    `group`, through an `all_reduce` of a zero buffer whose only non-zero
    slot is the rank's own. Differentiable: the backward sums the slots'
    gradients over the group, so each rank's `x` receives the gradient
    that every rank sends to its slot."""
    import torch.distributed.nn.functional as dist_fn

    n, i = dist.get_world_size(group), dist.get_rank(group)
    zero = torch.zeros_like(x)
    slots = torch.stack([x if j == i else zero for j in range(n)])
    with warnings.catch_warnings():
        # deprecated in favour of `_functional_collectives`, whose all_reduce has no backward
        warnings.simplefilter("ignore", FutureWarning)
        return dist_fn.all_reduce(slots, group=group)


class ZHalo:
    """The z halo of a volume split over the `space` axis: `halo(x)` with x
    (N, D, H, W, C), this rank's z-block, returns (x with the last z-plane of
    the rank below and the first of the rank above around it, planes added
    below, planes added above). End ranks add no plane on their open side:
    there SAME zero padding is the global volume's own."""

    def __init__(self, mesh):
        self.group = mesh.get_group("space")
        self.index = mesh.get_coordinate()[1]
        self.size = mesh.size(1)

    def __call__(self, x: torch.Tensor):
        if self.size == 1:
            return x, 0, 0
        got = gather_slots(torch.stack([x[:, 0], x[:, -1]]), self.group)  # (size, 2, N, H, W, C)
        lo, hi = int(self.index > 0), int(self.index < self.size - 1)
        parts = ([got[self.index - 1, 1].unsqueeze(1)] if lo else []) + [x] + \
                ([got[self.index + 1, 0].unsqueeze(1)] if hi else [])
        return torch.cat(parts, dim=1), lo, hi


class _MeshMeanGrads:
    """A `utils.optim` optimizer whose `step` first sums every leaf's
    gradient over the mesh (one `all_reduce` of the leaves in one buffer)
    and divides the sum by `divisor`, so that every rank updates its copy
    of the parameters with the same gradient."""

    def __init__(self, optimizer: optim.Optimizer, divisor: int):
        self.optimizer = optimizer
        self.params = optimizer.params
        self.divisor = divisor

    def require_grad(self) -> None:
        self.optimizer.require_grad()

    def zero_grad(self) -> None:
        self.optimizer.zero_grad()

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:  # a leaf the loss did not reach: a zero gradient, as jax.grad gives it
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1).to(torch.float32) for p in self.params])
        dist.all_reduce(flat)
        flat /= self.divisor
        for p, g in zip(self.params, flat.split([p.numel() for p in self.params])):
            p.grad.copy_(g.view_as(p.grad))
        self.optimizer.step()


def _mesh_mean(value: torch.Tensor, count: int) -> torch.Tensor:
    """The sum of a 0-d value over every rank, over `count`."""
    total = value.detach().reshape(1).to(torch.float32).clone()
    dist.all_reduce(total)
    return (total / count)[0]


def make_sharded_train_step(model: nn.Module, optimizer: optim.Optimizer, mesh, loss_fn: Optional[Callable] = None,
                            spatial_shard: bool = False) -> Callable:
    """Data-parallel (+ optional spatial) training step (JAX
    `sharding.py:55-99`): `run(images, labels)` -> the global mean loss
    before the update (0-d), called by every rank with the same global
    NDHWC batch. Rank 0's parameters are copied to every rank first.

    Each rank takes the gradient of its data block's loss; with
    `spatial_shard` the images' z axis is split over `space` as well, the
    UNet runs with the z halo, and the logits are gathered over `space`, so
    every space rank computes the data block's loss on the whole volume.
    The gather's backward sums the space ranks' gradients of that loss, so
    each rank back-propagates loss / n_space; its parameter gradient is then
    its z-block's share. Summed over the mesh and divided by n_data, the
    gradient is the global batch's, and every rank makes the same step.
    `optimizer` is a `utils.optim` optimizer over the model's leaves."""
    loss_fn = loss_fn or dice_bce_loss
    n_data, n_space = mesh.size(0), mesh.size(1)
    space = mesh.get_group("space")
    halo = ZHalo(mesh) if spatial_shard else None
    replicate(mesh, model)
    synced = _MeshMeanGrads(optimizer, n_data)

    def run(images, labels) -> torch.Tensor:
        x = shard_batch(mesh, images, 1 if spatial_shard else None).to(torch.float32)
        y = shard_batch(mesh, labels)
        synced.zero_grad()
        with torch.enable_grad():
            if spatial_shard:
                logits = torch.cat(list(gather_slots(model(x, halo=halo), space)), dim=1)
            else:
                logits = model(x)
            loss = loss_fn(logits, y)
            (loss / n_space).backward()
        synced.step()
        return _mesh_mean(loss, n_data * n_space)

    synced.require_grad()
    return run


def make_sharded_gradicon_train_step(model: nn.Module, optimizer: optim.Optimizer, mesh) -> Callable:
    """Data-parallel GradICON training step (JAX `sharding.py:102-138`):
    `run(a, b)` -> the global mean loss before the update, a and b the
    global (N, D, H, W) pairs that every rank passes. The pairs split over
    the flattened mesh (N % world size == 0); each rank runs
    `make_gradicon_train_step`'s per-pair loop on its own, then the
    gradients are averaged over the mesh before the one update."""
    world = mesh.size()
    index = _flat_index(mesh)
    dev = mesh_device(mesh)
    replicate(mesh, model)
    step = make_gradicon_train_step(model, _MeshMeanGrads(optimizer, world))

    def run(a, b) -> torch.Tensor:
        mine = [_block(torch.as_tensor(v), 0, world, index, "sharded GradICON step").to(dev, torch.float32)
                for v in (a, b)]
        return _mesh_mean(step(*mine), world)

    return run


def make_sharded_inference(model: nn.Module, mesh) -> Callable:
    """Tile-parallel inference (JAX `sharding.py:141-161`): `run(tiles)` ->
    per-tile sigmoid probabilities of all tiles on every rank. The tile
    batch is padded to a multiple of the mesh's size, each rank runs the
    forward on its share, and the shares are gathered and cropped."""
    world = mesh.size()
    index = _flat_index(mesh)
    dev = mesh_device(mesh)
    replicate(mesh, model)

    def run(tiles) -> torch.Tensor:
        tiles = torch.as_tensor(tiles)
        n = tiles.shape[0]
        k = -(-n // world)
        mine = tiles[index * k : (index + 1) * k].to(dev, torch.float32)
        if mine.shape[0] < k:
            mine = torch.cat([mine, mine.new_zeros((k - mine.shape[0],) + mine.shape[1:])])
        with torch.no_grad():
            probs = torch.sigmoid(model(mine))
            return gather_slots(probs, None).flatten(0, 1)[:n]

    return run
