"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda". A CUDA device without a card raises: the port
    never drops to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _legacy_matmul_flags():
    """(allow_tf32, float32 matmul precision) through torch's legacy API, or
    None where a caller set the precision through the new one
    (`torch.backends.cuda.matmul.fp32_precision`), after which the legacy
    getters raise."""
    try:
        return torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    except RuntimeError:
        return None


@contextlib.contextmanager
def ieee_f32_matmul():
    """Hold f32 matmuls on the card (cuBLAS) in IEEE f32 inside the block,
    whatever the caller set with `torch.backends.cuda.matmul.allow_tf32`,
    `torch.set_float32_matmul_precision` or the newer `fp32_precision`;
    restore the caller's settings afterwards, also on an exception. The JAX
    package's f32 products are f32 on the CPU, so the port's answers must
    not follow a process-wide TF32 switch."""
    matmul = torch.backends.cuda.matmul
    new = getattr(matmul, "fp32_precision", None)  # None: a torch without the new API
    legacy = _legacy_matmul_flags()
    if legacy is None:
        matmul.fp32_precision = "ieee"
    else:
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if legacy is None:
            matmul.fp32_precision = new
        else:
            torch.set_float32_matmul_precision(legacy[1])
            # each setter marks the API it belongs to: touch only what differs
            if matmul.allow_tf32 != legacy[0]:
                matmul.allow_tf32 = legacy[0]
            if new is not None and matmul.fp32_precision != new:
                matmul.fp32_precision = new
