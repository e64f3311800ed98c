"""ctypes bindings of the host-geometry helpers in `native.cpp` (a copy of
`oai_analysis_2_tpu/native/native.cpp`), with the names and signatures of
the JAX package's bindings (`oai_analysis_2_tpu/native/__init__.py:86-162`):
`connected_components`, `smooth_adjacency`, `fill_table`, `mesh_edges`.

The library is built from this directory's `native.cpp` with g++ into
`build/native/libnative-<hash>.so` at the root of the checkout, at first use
(or up front through `build`). The hash covers the source, the flags and the
target that `-march=native` resolves to, so an edited source or another
host's CPU never loads a stale library. Concurrent processes (pytest-xdist
workers) each compile to a file of their own and move it into place with
`os.replace`. Nothing is written into the package directory.

There is no fallback: when g++ is missing or the build fails, every call
raises. The numpy and scipy versions in `mesh/ops.py` (`_adjacency`,
`_neighbor_table`) and `mesh/components.py` (`scipy_component_labels`)
are the plain versions that the tests hold these against.

Each binding counts its calls (`<function>.calls`; `reset_calls`,
`read_calls`), so a run can show that the thickness stage went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "native.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the port's host-geometry library (native/native.cpp) is "
                           "built with g++ at first use, and it has no fallback")
    return found


def _target(gxx: str) -> str:
    """The CPU that `-march=native` means on this host, as g++ resolves it."""
    res = subprocess.run([gxx, "-march=native", "-Q", "--help=target"], capture_output=True, text=True, timeout=60)
    for line in res.stdout.splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0] == "-march=":
            return parts[1]
    return res.stdout


def library_path(gxx: Optional[str] = None) -> Path:
    gxx = gxx or _gxx()
    key = _SRC.read_bytes() + " ".join(FLAGS).encode() + _target(gxx).encode()
    return _BUILD / f"libnative-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build() -> Path:
    gxx = _gxx()
    out = library_path(gxx)
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    res = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(_SRC)], capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build native/native.cpp:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        lib.uf_connected_components.restype = ctypes.c_int32
        lib.uf_connected_components.argtypes = [ctypes.c_int64, ctypes.c_int64, i32p, i32p]
        lib.mesh_edges.restype = ctypes.c_int64
        lib.mesh_edges.argtypes = [ctypes.c_int64, i32p, i32p, ctypes.POINTER(ctypes.c_uint8)]
        lib.smooth_adjacency_csr.restype = ctypes.c_int64
        lib.smooth_adjacency_csr.argtypes = [ctypes.c_int64, ctypes.c_int64, i32p, i32p, i32p]
        lib.smooth_fill_table.restype = None
        lib.smooth_fill_table.argtypes = [ctypes.c_int64, i32p, i32p, i64p, ctypes.c_int32, ctypes.c_int64, i32p]
        _lib = lib
        return lib


def build() -> Path:
    """Build (if needed) and load the library; its path."""
    _load()
    return library_path()


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def _faces(faces, n_points: Optional[int] = None) -> np.ndarray:
    """(F, 3) contiguous int32 faces; with `n_points`, every index must lie
    in [0, n_points): the C code indexes per-point arrays with them."""
    faces = np.ascontiguousarray(np.asarray(faces).reshape(-1, 3), np.int32)
    if n_points is not None and len(faces) and (int(faces.min()) < 0 or int(faces.max()) >= n_points):
        raise ValueError(f"faces index points outside [0, {n_points})")
    return faces


def connected_components(n_points: int, faces: np.ndarray) -> np.ndarray:
    """Per-point component labels (0..k-1, numbered by each component's
    lowest point) by union-find over the faces' edges."""
    lib = _load()
    connected_components.calls += 1
    faces = _faces(faces, n_points)
    labels = np.empty(n_points, np.int32)
    lib.uf_connected_components(n_points, len(faces), _ptr(faces, ctypes.c_int32), _ptr(labels, ctypes.c_int32))
    return labels


def smooth_adjacency(n_points: int, faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Smoothing adjacency as CSR (degree (N,) int32, neighbours (total,)
    int32) with the boundary rule applied (a boundary vertex averages only
    over its boundary-edge neighbours); each vertex's neighbours ascending."""
    lib = _load()
    smooth_adjacency.calls += 1
    faces = _faces(faces, n_points)
    deg = np.empty(n_points, np.int32)
    nbr = np.empty(max(6 * len(faces), 1), np.int32)
    total = lib.smooth_adjacency_csr(n_points, len(faces), _ptr(faces, ctypes.c_int32), _ptr(deg, ctypes.c_int32),
                                     _ptr(nbr, ctypes.c_int32))
    return deg, nbr[:total]


def fill_table(deg: np.ndarray, nbr: np.ndarray, tbl: np.ndarray, slots=None) -> bool:
    """Fill a dummy-initialized (nv, k) int32 neighbour table from CSR,
    row by row (optionally through a slot permutation of rows and
    entries). Returns True, as the JAX binding does when its library
    loaded."""
    lib = _load()
    fill_table.calls += 1
    deg = np.ascontiguousarray(deg, np.int32)
    nbr = np.ascontiguousarray(nbr, np.int32)
    if tbl.dtype != np.int32 or not tbl.flags.c_contiguous or tbl.ndim != 2:
        raise ValueError("fill_table: tbl must be a C-contiguous (nv, k) int32 array")
    if int(deg.max(initial=0)) > tbl.shape[1] or len(deg) > tbl.shape[0] or int(deg.sum()) != len(nbr):
        raise ValueError("fill_table: the CSR does not fit the table")
    if slots is not None:
        slots = np.ascontiguousarray(slots, np.int64)
        if len(slots) != len(deg) or (len(slots) and (int(slots.min()) < 0 or int(slots.max()) >= tbl.shape[0])) \
                or (len(nbr) and (int(nbr.min()) < 0 or int(nbr.max()) >= len(slots))):
            raise ValueError("fill_table: slots must map each CSR row and neighbour to a table row")
        sptr, has = _ptr(slots, ctypes.c_int64), 1
    else:
        sptr, has = ctypes.POINTER(ctypes.c_int64)(), 0
    lib.smooth_fill_table(len(deg), _ptr(deg, ctypes.c_int32), _ptr(nbr, ctypes.c_int32), sptr, has, tbl.shape[1],
                          _ptr(tbl, ctypes.c_int32))
    return True


def mesh_edges(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(unique undirected edges (E, 2) int32 as (lo, hi), ascending; boundary
    flags (E,), True for an edge of exactly one face)."""
    lib = _load()
    mesh_edges.calls += 1
    faces = _faces(faces)
    max_edges = 3 * len(faces)
    edges = np.empty((max_edges, 2), np.int32)
    boundary = np.empty(max_edges, np.uint8)
    n = lib.mesh_edges(len(faces), _ptr(faces, ctypes.c_int32), _ptr(edges, ctypes.c_int32),
                       _ptr(boundary, ctypes.c_uint8))
    return edges[:n], boundary[:n].astype(bool)


_BINDINGS = (connected_components, smooth_adjacency, fill_table, mesh_edges)


def reset_calls() -> None:
    for fn in _BINDINGS:
        fn.calls = 0


def read_calls() -> Dict[str, int]:
    return {fn.__name__: fn.calls for fn in _BINDINGS}


reset_calls()
