"""Build and load the hand-written Hopper kernels in `csrc/`.

Each `csrc/<name>.cu` exports a plain C interface and is compiled by nvcc
into its own shared library, `build/kernels/<name>-<hash>.so` at the root of
the checkout, then loaded with ctypes. The hash covers the source and the
flags, so an edited kernel is never served from a stale library. Building
happens at first use (or up front, in parallel, through `build_all`),
never at import: the CPU tests import every module of the port and have
no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"

_COMMON_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
# per-source extra flags: the distance kernel's "was" build keeps the
# flags it was measured with (no FMA contraction, each multiply and add
# rounded op by op like the plain version)
EXTRA_FLAGS: Dict[str, List[str]] = {
    "conv3d": [],
    "conv3d_cin1": [],
    "conv3d_f32": [],
    "conv3d_sm90": [],
    "conv3d_sm90n": [],
    "point_triangle": [],
    "point_triangle_was": ["--fmad=false"],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return str(path)


def _command(name: str) -> List[str]:
    return [*_COMMON_FLAGS, *EXTRA_FLAGS[name]]


def library_path(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_command(name)).encode()).hexdigest()[:16]
    return _BUILD / f"{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    cmd = [_nvcc(), *_command(name), "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Build every kernel library at once (one nvcc per source, all started
    together) and load them."""
    with _lock:
        started = {name: _start_build(name) for name in EXTRA_FLAGS}
        for name, s in started.items():
            _finish_build(name, s)
    for name in EXTRA_FLAGS:
        load_library(name)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish_build(name, _start_build(name))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
