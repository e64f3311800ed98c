"""The one traffic generator: everything a cell feeds the program is made
here, on the device, from `--seed` and the parameters of the cell's
traffic file and configuration file.

Knees (`knee_pool`, `atlas`): the OAI DESS-like fixture of the port's
single-knee bench, copied so that later changes to the program cannot move
it: a knee carrying a femoral-like and a tibial-like cartilage shell
(probability ~1 between two radii, limited to a polar cap) at intensity
900 over uniform background noise, and an atlas with the same anatomy
slightly shifted and a matched texture. The pool's knees are the product
of the traffic file's variations of radii, centres and noise; every seed
gets the same set, in its own order and with its own noise, so the work
of a window does not depend on the seed.

Phantom pairs (`phantom_pool`, `pair_bank`): the registration recipe's
augmented pairs, as its trainer draws them: a pool of knee-like phantoms
(1-3 shells, 0-2 bone-like ellipsoids, a low-frequency bias, texture
noise), and per step, pairs of pool indices, whether a pair is one phantom,
and a random smooth low-resolution displacement field per volume.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import torch


def _generator(seed: int, device, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % (2**63 - 1))


def _grid(shape, device):
    return torch.meshgrid(*(torch.arange(s, dtype=torch.float32, device=device) for s in shape), indexing="ij")


def shell(zyx, r_inner: float, r_outer: float, center, z_aspect: float = 2.4) -> torch.Tensor:
    """A curved cartilage-like shell on the grid (upper cap only)."""
    z, y, x = zyx
    rr = torch.sqrt(((z - center[0]) * z_aspect) ** 2 + (y - center[1]) ** 2 + (x - center[2]) ** 2)
    s = torch.clamp(1.0 - torch.abs(rr - (r_inner + r_outer) / 2) / ((r_outer - r_inner) / 2), 0.0, 1.0)
    return s * (y < center[1]).to(torch.float32)


def knee_variants(traffic: dict) -> List[Dict[str, float]]:
    """The pool's knees as parameter sets: every combination of the traffic
    file's variations, in a fixed order."""
    v = traffic["variations"]
    keys = sorted(v)
    return [dict(zip(keys, combo)) for combo in itertools.product(*(v[k] for k in keys))]


def knee(cfg: dict, variant: Dict[str, float], gen: torch.Generator, device) -> torch.Tensor:
    """One knee (D, H, W) f32 on `device`."""
    fx = cfg["fixture"]
    shape = tuple(cfg["knee_shape_zyx"])
    zyx = _grid(shape, device)
    dy = variant.get("center_shift_y", 0.0)
    fc_c = [c + (dy if i == 1 else 0.0) for i, c in enumerate(fx["fc_center"])]
    tc_c = [c + (dy if i == 1 else 0.0) for i, c in enumerate(fx["tc_center"])]
    dr_fc, dr_tc = variant.get("fc_radius_shift", 0.0), variant.get("tc_radius_shift", 0.0)
    anatomy = torch.maximum(shell(zyx, fx["fc_radii"][0] + dr_fc, fx["fc_radii"][1] + dr_fc, fc_c),
                            shell(zyx, fx["tc_radii"][0] + dr_tc, fx["tc_radii"][1] + dr_tc, tc_c))
    noise = torch.rand(shape, generator=gen, device=device) * variant.get("noise_max", fx["noise_max"])
    return anatomy * fx["tissue_intensity"] + noise


def knee_pool(cfg: dict, traffic: dict, seed: int, device) -> List[torch.Tensor]:
    """The pool's knees in the seed's order."""
    gen = _generator(seed, device, 1)
    variants = knee_variants(traffic)
    order = torch.randperm(len(variants), generator=torch.Generator().manual_seed(int(seed) % (2**63 - 1)))
    return [knee(cfg, variants[int(i)], gen, device) for i in order]


def atlas(cfg: dict, seed: int, device) -> torch.Tensor:
    """The atlas (D, H, W) f32: the fixture's atlas shells, scaled to [0, 1]
    like a windowed image, with a matched texture."""
    fx = cfg["fixture"]
    shape = tuple(cfg["knee_shape_zyx"])
    zyx = _grid(shape, device)
    anatomy = torch.maximum(shell(zyx, *fx["atlas_fc_radii"], fx["atlas_fc_center"]),
                            shell(zyx, *fx["atlas_tc_radii"], fx["atlas_tc_center"]))
    gen = _generator(seed, device, 2)
    return anatomy * fx["atlas_tissue"] + torch.rand(shape, generator=gen, device=device) * fx["atlas_noise_max"]


# ---------------------------------------------------------------------------
# The registration recipe's phantom pairs
# ---------------------------------------------------------------------------


def _u(gen, lo, hi, device):
    return lo + (hi - lo) * float(torch.rand((), generator=gen, device=device))


def phantom(shape, gen: torch.Generator, device) -> torch.Tensor:
    """A windowed-intensity knee-like volume in [0, 1] (D, H, W)."""
    d, h, w = shape
    z, y, x = _grid(shape, device)
    anatomy = torch.zeros(shape, device=device)
    for _ in range(1 + int(torch.randint(0, 3, (), generator=gen, device=device))):
        c = (d * _u(gen, 0.3, 0.7, device), h * _u(gen, 0.35, 0.7, device), w * _u(gen, 0.35, 0.65, device))
        aspect, r0, th = _u(gen, 1.6, 3.0, device), _u(gen, 0.10, 0.24, device) * h, _u(gen, 1.0, 3.5, device)
        rr = torch.sqrt(((z - c[0]) * aspect) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
        s = torch.clamp(1.0 - torch.abs(rr - r0) / th, 0.0, 1.0)
        kind = int(torch.randint(0, 3, (), generator=gen, device=device))
        cap = (y < c[1]).float() if kind == 0 else (y > c[1]).float() if kind == 1 else 1.0
        anatomy = torch.maximum(anatomy, s * cap * _u(gen, 0.55, 0.95, device))
    for _ in range(int(torch.randint(0, 3, (), generator=gen, device=device))):
        c = (d * _u(gen, 0.25, 0.75, device), h * _u(gen, 0.25, 0.75, device), w * _u(gen, 0.3, 0.7, device))
        r = (d * _u(gen, 0.08, 0.2, device), h * _u(gen, 0.08, 0.2, device), w * _u(gen, 0.08, 0.2, device))
        q = ((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 + ((x - c[2]) / r[2]) ** 2
        anatomy = torch.maximum(anatomy, torch.clamp(2.0 * (1.0 - q), 0.0, 1.0) * _u(gen, 0.3, 0.7, device))
    bias = (_u(gen, -0.06, 0.06, device) * torch.sin(z / d * _u(gen, 2, 5, device) + _u(gen, 0, 6, device))
            + _u(gen, -0.06, 0.06, device) * torch.sin(y / h * _u(gen, 2, 5, device) + _u(gen, 0, 6, device)))
    noise = torch.rand(shape, generator=gen, device=device) * _u(gen, 0.12, 0.28, device)
    return torch.clamp(anatomy + noise + bias, 0.0, 1.0)


def phantom_pool(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """(pool, D, H, W) phantoms on `device`."""
    gen = _generator(seed, device, 3)
    shape = tuple(cfg["model"]["grid_shape"])
    return torch.stack([phantom(shape, gen, device) for _ in range(traffic["pool"])])


def pair_bank(cfg: dict, traffic: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Per step of a bank of `bank_steps` steps: pool indices ia, ib (steps,
    batch), `same` (steps, batch) f32, 1 where a pair is one phantom, and
    low-resolution fields ua, ub (steps, batch, *lowres, 3): a random
    amplitude below `amplitude` times unit normals plus one random
    translation below `translation` a volume."""
    gen = _generator(seed, device, 4)
    n, b = traffic["bank_steps"], cfg["batch_pairs"]
    pool = traffic["pool"]
    lowres = tuple(traffic["lowres_shape"])
    ia = torch.randint(0, pool, (n, b), generator=gen, device=device)
    same = torch.rand((n, b), generator=gen, device=device) < traffic["same_fraction"]
    ib = torch.where(same, ia, torch.randint(0, pool, (n, b), generator=gen, device=device))

    def fields():
        amp = torch.rand((n, b, 1, 1, 1, 1), generator=gen, device=device) * traffic["amplitude"]
        f = torch.randn((n, b) + lowres + (3,), generator=gen, device=device) * amp
        t = (torch.rand((n, b, 1, 1, 1, 3), generator=gen, device=device) * 2 - 1) * traffic["translation"]
        return f + t

    ua, ub = fields(), fields()
    return {"ia": ia, "ib": ib, "same": (same | (ia == ib)).float(), "ua": ua, "ub": ub}
