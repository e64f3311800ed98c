"""The npz checkpoint format, the reference's torch checkpoints, and the
weight carrier.

Format (the JAX package's, `oai_analysis_2_tpu/utils/checkpoint.py:34-97`):
one `.npz` holding the parameter tree flattened to `a/b/c` keys plus a JSON
string under `__meta__` with the scalar metadata (epoch, best score, the
GradICON architecture). Trees here stay numpy; `carry_params` moves one
onto a module's parameters and buffers, `export_params` takes it back.

The reference ships its segmentation weights as a torch `.pth.tar`
(`model_state_dict` with `ec*` / `dc*` keys, NCDHW modules).
`convert_torch_unet_state_dict` maps one onto the UNet tree with numpy
transforms (port of `utils/checkpoint.py:127-257`):
  * Conv3d weight (O, I, D, H, W) -> DHWIO, a (2, 3, 4, 1, 0) transpose;
  * ConvTranspose3d k2/s2 weight (I, O, 2, 2, 2) -> (2, 2, 2, I, O), a
    (2, 3, 4, 0, 1) transpose;
  * ConvTranspose3d k3/s1/p1 weight -> the equivalent forward conv,
    K[d, h, w, i, o] = W[i, o, 2-d, 2-h, 2-w] (a stride-1 transposed conv
    is a plain conv with a spatially flipped, channel-swapped kernel).
"""

from __future__ import annotations

import json
import math
import os
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return tree


def load_checkpoint(file) -> dict:
    """{params: numpy tree, ..., epoch, best_score, ...} from a native npz."""
    with np.load(file, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    state = dict(meta)
    state.update(unflatten_tree(flat))
    return state


def _write_npz(file: Path, meta: dict, arrays: dict) -> None:
    """np.savez to `file` atomically (temp name + os.replace); like np.savez,
    a name without the .npz suffix gets it."""
    if file.suffix != ".npz":
        file = file.with_name(file.name + ".npz")
    tmp = file.with_name(f"{file.stem}.tmp{os.getpid()}.npz")
    np.savez(tmp, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, file)


def save_checkpoint(state: dict, is_best: bool, path, prefix: Optional[str] = None,
                    name: str = "checkpoint.npz") -> Path:
    """Write `state` (dict-valued entries are trees, the rest scalar
    metadata) to `path / name` (`prefix_name` with a prefix), and with
    `is_best` also `model_best.npz` (`prefix_model_best.npz`) without the
    `opt_state*` leaves: the JAX package's signature and files
    (`utils/checkpoint.py:56-87`), each written atomically. Returns the
    checkpoint's path."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    file = path / (f"{prefix}_{name}" if prefix else name)
    arrays, meta = {}, {}
    for k, v in state.items():
        if isinstance(v, dict):
            arrays.update(flatten_tree({k: v}))
        elif v is not None:
            meta[k] = float(v) if isinstance(v, (int, float, np.floating)) else v
    _write_npz(file, meta, arrays)
    if is_best:
        best = {k: v for k, v in arrays.items() if not k.startswith("opt_state")}
        _write_npz(path / (f"{prefix}_model_best.npz" if prefix else "model_best.npz"), meta, best)
    return file


def _leaves(module: nn.Module) -> Dict[str, torch.Tensor]:
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    return own


def carry_params(module: nn.Module, tree: dict) -> None:
    """Copy a JAX-layout parameter tree (nested dicts of numpy arrays, as the
    JAX package's `init`/checkpoints produce) onto `module`'s parameters and
    buffers.

    The port's modules name their parameters after the tree's paths
    (`enc0a.kernel`, `stages.1.dec0up.bias`, ...) and keep the JAX layouts
    (DHWIO kernels); a batch-norm subtree (`enc0a/bn/{scale, bias, mean,
    var}`) lands on the block's `bn` module. So the carry is a checked
    one-to-one copy: a missing or extra leaf, or a shape mismatch, raises."""
    flat = {k.replace("/", "."): v for k, v in flatten_tree(tree).items()}
    own = _leaves(module)
    if set(flat) != set(own):
        raise KeyError(
            f"parameter trees differ: missing {sorted(set(own) - set(flat))}, "
            f"unexpected {sorted(set(flat) - set(own))}"
        )
    with torch.no_grad():
        for name, p in own.items():
            v = torch.as_tensor(np.asarray(flat[name]))
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(v.shape)} != {tuple(p.shape)}")
            p.copy_(v.to(p.dtype))


def export_params(module: nn.Module) -> dict:
    """The exact inverse of `carry_params`: `module`'s parameters and buffers
    as a tree of numpy arrays under the JAX tree's names, so what the port
    trains saves in the JAX package's checkpoint format."""
    flat = {name.replace(".", "/"): t.detach().cpu().numpy().copy() for name, t in _leaves(module).items()}
    return unflatten_tree(flat)


def initialize_model(model, generator: Optional[torch.Generator] = None,
                     ckpoint_path=None) -> Tuple[dict, int, float]:
    """(params as a numpy tree, finished epoch, best score) of a UNet (port
    of `initialize_model`, `oai_analysis_2_tpu/utils/checkpoint.py:100-121`,
    reference utils.py:10-45): from a native `.npz` checkpoint, from a torch
    `.pth.tar` checkpoint converted on the fly, or, with no path, a fresh
    init of `model` drawn from `generator` (`UNet3D.init`, which also sets
    the module's parameters)."""
    if ckpoint_path:
        p = Path(ckpoint_path)
        if not p.is_file():
            raise ValueError(f"no checkpoint found at '{p}'")
        if p.suffix == ".npz":
            state = load_checkpoint(p)
            return state["params"], int(state.get("epoch", 0)), float(state.get("best_score", 0.0))
        sd, epoch, best = load_torch_checkpoint(p)
        return convert_torch_unet_state_dict(sd, model.spec), epoch, best
    return export_params(model.init(generator)), 0, 0.0


def weight_from_truth(truths, n_classes: int) -> torch.Tensor:
    """Inverse class-frequency loss weights, normalised to sum 1, 0 for an
    absent class (port of `weight_from_truth`,
    `oai_analysis_2_tpu/utils/checkpoint.py:258-263`, reference
    utils.py:60-70): an f32 tensor on the labels' device."""
    truths = torch.as_tensor(truths)
    counts = torch.stack([(truths == c).sum() for c in range(n_classes)]).to(torch.float32)
    ratio_inv = torch.where(counts > 0, truths.numel() / counts.clamp(min=1), torch.zeros_like(counts))
    return ratio_inv / ratio_inv.sum()


# -- the reference's torch checkpoints ------------------------------------------


def load_torch_checkpoint(path) -> Tuple[Dict[str, np.ndarray], int, float]:
    """(state_dict as numpy, epoch, best score) of a reference-format torch
    checkpoint: keys `model_state_dict` (or a bare state_dict), `epoch`,
    `best_score` | `reg_best_score` | `seg_best_score`."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    sd = ck.get("model_state_dict", ck)
    best = 0.0
    for k in ("best_score", "reg_best_score", "seg_best_score"):
        if k in ck:
            best = float(ck[k])
            break
    epoch = int(ck.get("epoch", 0))
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}, epoch, best


def _is_unet_key(key: str) -> bool:
    """True for keys of the reference UNet's naming scheme (ec* / dc*)."""
    return key.startswith(("ec", "dc"))


def _conv_fwd(w: np.ndarray) -> np.ndarray:
    # torch Conv3d (O, I, D, H, W) -> DHWIO
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))


def _convT_up(w: np.ndarray) -> np.ndarray:
    # torch ConvTranspose3d k2s2 (I, O, 2, 2, 2) -> (2, 2, 2, I, O)
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 0, 1)))


def _convT_as_fwd(w: np.ndarray) -> np.ndarray:
    # torch ConvTranspose3d k3s1p1 (I, O, 3, 3, 3) -> flipped forward DHWIO
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 0, 1))[::-1, ::-1, ::-1])


def _torch_decoder_names(num_dec_levels: int):
    """The reference numbers decoder layers top-down: for L levels the
    deepest uses dc{3L} (up), dc{3L-1}, dc{3L-2}, ... and dc0 is the head."""
    return [(f"dc{3 * (num_dec_levels - li)}", f"dc{3 * (num_dec_levels - li) - 1}",
             f"dc{3 * (num_dec_levels - li) - 2}") for li in range(num_dec_levels)]


def convert_torch_unet_state_dict(sd: Dict[str, np.ndarray], spec, prefix: str = "",
                                  generator: Optional[torch.Generator] = None) -> dict:
    """Map a reference UNet torch state_dict onto the UNet's numpy tree.

    `module.`-prefixed keys (DataParallel training) are accepted. A
    `UNetClassWise` checkpoint whose per-class heads are missing (the
    reference keeps them in a plain Python list, invisible to
    `state_dict()`) gets new heads and a warning, the JAX package's text.
    The new heads are Xavier-normal draws from `generator` (None: a CPU
    generator seeded with 0), with zero bias: the same shapes and
    distribution as the JAX package's, not the same values (that one draws
    from `jax.random`)."""
    if not any(k.startswith(prefix) and _is_unet_key(k[len(prefix):]) for k in sd):
        dp = f"{prefix}module."
        if any(k.startswith(dp) and _is_unet_key(k[len(dp):]) for k in sd):
            prefix = dp

    def grab_block(torch_name, transform):
        p = {"kernel": transform(sd[f"{prefix}{torch_name}.0.weight"])}
        if f"{prefix}{torch_name}.0.bias" in sd:
            p["bias"] = np.asarray(sd[f"{prefix}{torch_name}.0.bias"])
        if f"{prefix}{torch_name}.1.running_mean" in sd:  # batch norm present
            bn = f"{prefix}{torch_name}.1."
            p["bn"] = {"scale": np.asarray(sd[bn + "weight"]), "bias": np.asarray(sd[bn + "bias"]),
                       "mean": np.asarray(sd[bn + "running_mean"]), "var": np.asarray(sd[bn + "running_var"])}
        return p

    params: dict = {}
    for li in range(len(spec.enc)):
        params[f"enc{li}a"] = grab_block(f"ec{2 * li}", _conv_fwd)
        params[f"enc{li}b"] = grab_block(f"ec{2 * li + 1}", _conv_fwd)
    for li, (up_name, a_name, b_name) in enumerate(_torch_decoder_names(len(spec.dec))):
        params[f"dec{li}up"] = grab_block(up_name, _convT_up)
        params[f"dec{li}a"] = grab_block(a_name, _convT_as_fwd)
        params[f"dec{li}b"] = grab_block(b_name, _convT_as_fwd)

    if not spec.classwise_heads:
        head = {"kernel": _conv_fwd(sd[f"{prefix}dc0.weight"])}
        if f"{prefix}dc0.bias" in sd:
            head["bias"] = np.asarray(sd[f"{prefix}dc0.bias"])
        params["head"] = head
        return params
    missing = []
    for c in range(spec.n_classes):
        k = f"{prefix}dc0s.{c}.weight"
        if k not in sd:
            missing.append(c)
            continue
        head = {"kernel": _conv_fwd(sd[k])}
        if f"{prefix}dc0s.{c}.bias" in sd:
            head["bias"] = np.asarray(sd[f"{prefix}dc0s.{c}.bias"])
        params[f"head{c}"] = head
    if missing:
        warnings.warn(
            f"UNetClassWise checkpoint is missing per-class heads {missing} "
            "(reference networks.py:182 keeps them outside state_dict); "
            "initializing them randomly — class outputs need fine-tuning",
            stacklevel=2,
        )
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        std = math.sqrt(2.0 / (spec.head_in + 1))  # Xavier normal, fan_in head_in, fan_out 1
        for c in missing:
            head = {"kernel": (torch.randn((1, 1, 1, spec.head_in, 1), generator=gen) * std).numpy()}
            if spec.bias:
                head["bias"] = np.zeros((1,), np.float32)
            params[f"head{c}"] = head
    return params
