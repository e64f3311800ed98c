"""The npz checkpoint format and the weight carrier.

Format (the JAX package's, `oai_analysis_2_tpu/utils/checkpoint.py:34-97`):
one `.npz` holding the parameter tree flattened to `a/b/c` keys plus a JSON
string under `__meta__` with the scalar metadata (epoch, best score, the
GradICON architecture). Trees here stay numpy; `carry_params` moves one
onto a module's parameters.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict

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


def save_checkpoint(state: dict, file) -> Path:
    """Write `state` (dict-valued entries are trees, the rest scalar
    metadata) in the same format, atomically (temp name + os.replace)."""
    file = Path(file)
    file.parent.mkdir(parents=True, exist_ok=True)
    arrays, meta = {}, {}
    for k, v in state.items():
        if isinstance(v, dict):
            arrays.update(flatten_tree({k: v}))
        elif v is not None:
            meta[k] = float(v) if isinstance(v, (int, float, np.floating)) else v
    tmp = file.with_name(f"{file.stem}.tmp{os.getpid()}.npz")
    np.savez(tmp, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, file)
    return file


def carry_params(module: nn.Module, tree: dict) -> None:
    """Copy a JAX-layout parameter tree (nested dicts of numpy arrays, as the
    JAX package's `init`/checkpoints produce) onto `module`'s parameters.

    The port's modules name their parameters after the tree's paths
    (`enc0a.kernel`, `stages.1.dec0up.bias`, ...) and keep the JAX layouts
    (DHWIO kernels), so the carry is a checked one-to-one copy: a missing
    or extra leaf, or a shape mismatch, raises."""
    flat = {k.replace("/", "."): v for k, v in flatten_tree(tree).items()}
    own = dict(module.named_parameters())
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
