"""`core.device.ieee_f32_matmul`: inside the block f32 matmuls are held in
IEEE f32 whatever TF32 switches the caller set, and after it the caller's
switches are as they were, also when the block raises; the port's f32
products on the card go through it. On the CPU these are the switches
themselves; `chip_smoke.py` phase 14 (d) holds the card's products bit for
bit with TF32 on against TF32 off."""

import contextlib

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu_torch.core import device as D
from oai_analysis_2_tpu_torch.models import unet3d
from oai_analysis_2_tpu_torch.ops import clustering, resample

MATMUL = torch.backends.cuda.matmul
NEW_API = hasattr(torch.backends, "fp32_precision")

# how a caller may have set the switches before calling the port
SETUPS = {
    "default": lambda: None,
    "allow_tf32": lambda: setattr(MATMUL, "allow_tf32", True),
    "precision_high": lambda: torch.set_float32_matmul_precision("high"),
    "precision_medium": lambda: torch.set_float32_matmul_precision("medium"),
    "both_legacy": lambda: (setattr(MATMUL, "allow_tf32", True), torch.set_float32_matmul_precision("high")),
}
if NEW_API:
    SETUPS["new_api_matmul"] = lambda: setattr(MATMUL, "fp32_precision", "tf32")
    SETUPS["new_api_global"] = lambda: setattr(torch.backends, "fp32_precision", "tf32")


def switches() -> dict:
    """Every switch as torch reports it ("raises" where a getter refuses
    because the caller used the other API)."""
    out = {}
    getters = {"allow_tf32": lambda: MATMUL.allow_tf32, "precision": torch.get_float32_matmul_precision}
    if NEW_API:
        getters.update(matmul_fp32=lambda: MATMUL.fp32_precision, global_fp32=lambda: torch.backends.fp32_precision)
    for name, get in getters.items():
        try:
            out[name] = get()
        except RuntimeError:
            out[name] = "raises"
    return out


@pytest.fixture(autouse=True)
def pristine():
    """Each test starts from torch's defaults and leaves them so."""
    start = switches()
    yield
    torch.set_float32_matmul_precision(start["precision"])
    MATMUL.allow_tf32 = start["allow_tf32"]
    if NEW_API:
        torch.backends.fp32_precision = start["global_fp32"]
        MATMUL.fp32_precision = start["matmul_fp32"]
    assert switches() == start


def ieee_inside(state: dict) -> bool:
    if NEW_API and state["matmul_fp32"] != "ieee":
        return False
    return state["allow_tf32"] in (False, "raises") and state["precision"] in ("highest", "raises")


@pytest.mark.parametrize("raises", [False, True], ids=["returns", "raises"])
@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_ieee_f32_matmul_restores_the_callers_switches(setup, raises):
    SETUPS[setup]()
    before = switches()
    inside = []
    with pytest.raises(ValueError) if raises else contextlib.nullcontext():
        with D.ieee_f32_matmul():
            inside.append(switches())
            if raises:
                raise ValueError("the body failed")
    assert ieee_inside(inside[0]), inside[0]
    assert switches() == before


def test_ieee_f32_matmul_nests():
    torch.set_float32_matmul_precision("high")
    before = switches()
    with D.ieee_f32_matmul():
        with D.ieee_f32_matmul():
            assert ieee_inside(switches())
        assert ieee_inside(switches())
    assert switches() == before


def counting(monkeypatch, module) -> list:
    """Patch `module`'s `ieee_f32_matmul` to record the switches inside each
    use."""
    seen = []

    @contextlib.contextmanager
    def spy():
        with D.ieee_f32_matmul():
            seen.append(switches())
            yield

    monkeypatch.setattr(module, "ieee_f32_matmul", spy)
    return seen


def test_f32_products_go_through_it(monkeypatch):
    """The warp's upsampling, the UNet's pointwise and upconv products (f32
    products in either compute dtype) and the device k-means's one-hot sums
    each enter the context, with TF32 on outside."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    rng = np.random.default_rng(0)

    seen = counting(monkeypatch, resample)
    field = torch.tensor(rng.normal(size=(3, 4, 5, 3)), dtype=torch.float32)
    w = [torch.tensor(rng.random((n, m)), dtype=torch.float32) for n, m in ((6, 3), (8, 4), (10, 5))]
    resample._upsample_field_separable(field, *w)
    assert len(seen) == 1 and ieee_inside(seen[0])

    seen = counting(monkeypatch, unet3d)
    blk = unet3d._Block.__new__(unet3d._Block)
    blk.kernel, blk.bias = torch.tensor(rng.normal(size=(1, 1, 1, 4, 2)), dtype=torch.float32), None
    up = unet3d._Block.__new__(unet3d._Block)
    up.kernel, up.bias = torch.tensor(rng.normal(size=(2, 2, 2, 4, 3)), dtype=torch.float32), None
    x = torch.tensor(rng.normal(size=(1, 2, 2, 2, 4)), dtype=torch.float32)
    unet3d._pointwise(x, blk)
    unet3d.upconv2x(x, up)
    assert len(seen) == 2 and all(ieee_inside(s) for s in seen)
    unet3d._pointwise(x.to(torch.bfloat16), blk)
    unet3d.upconv2x(x.to(torch.bfloat16), up)
    assert len(seen) == 4 and all(ieee_inside(s) for s in seen)

    seen = counting(monkeypatch, clustering)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    clustering.kmeans(pts, k=2, n_iter=3, backend="device", device="cpu")
    assert len(seen) == 3 and all(ieee_inside(s) for s in seen)
    assert switches()["allow_tf32"] is True and switches()["precision"] == "high"
