"""Minimal zarr v2 volume reader and writer — local, HTTP(S) and S3 stores
(port of `oai_analysis_2_tpu/utils/zarr_io.py:28-140`).

A dependency-free reader for zarr v2 stores with raw / zlib / gzip / blosc
compressors (blosc through the pure-Python codec in `utils/blosc.py`), in
place of the reference's xarray/zarr ingestion (dask_processing.py:29-43).
The array lives under `array_name/` or at the store root; an absent chunk
reads as `fill_value`; origin, spacing and direction come from `.zattrs`
when present (identity otherwise). Chunks are decoded on the host and the
volume is put on the requested device (None: the card) in one copy.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path

import numpy as np

from oai_analysis_2_tpu_torch.core.image import Image, image_from_array
from oai_analysis_2_tpu_torch.utils.stores import open_store


def _decompress(buf: bytes, compressor) -> bytes:
    if compressor is None:
        return buf
    cid = compressor.get("id")
    if cid in ("zlib", "gzip"):
        return zlib.decompress(buf, zlib.MAX_WBITS | 32 if cid == "gzip" else zlib.MAX_WBITS)
    if cid == "blosc":
        from oai_analysis_2_tpu_torch.utils.blosc import blosc_decompress

        return blosc_decompress(buf)
    raise NotImplementedError(f"unsupported zarr compressor: {cid}")


def read_zarr_volume(path, array_name: str = "image", device=None) -> Image:
    """Read a 3D zarr v2 array into an Image ([z, y, x], float32) on `device`.

    `path` may be a posix directory, an `http(s)://` URL or an
    `s3://bucket/prefix` URL (`utils/stores.py` dispatches)."""
    store = open_store(path)
    prefix = f"{array_name}/"
    meta_buf = store.get(prefix + ".zarray")
    if meta_buf is None:
        prefix = ""
        meta_buf = store.get(".zarray")
    if meta_buf is None:
        raise FileNotFoundError(f"no .zarray under {path!r} (or {array_name}/)")
    meta = json.loads(meta_buf)
    if len(meta["shape"]) != 3:
        raise ValueError(f"expected 3D array, got shape {meta['shape']}")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    fill = meta.get("fill_value", 0) or 0
    sep = meta.get("dimension_separator", ".")

    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    coords = [(iz, iy, ix) for iz in range(grid[0]) for iy in range(grid[1]) for ix in range(grid[2])]
    # one batched fetch: remote stores pull chunks in parallel
    keys = [prefix + sep.join(map(str, c)) for c in coords]
    bufs = store.getmany(keys)

    out = np.full(shape, fill, dtype)
    for (iz, iy, ix), key in zip(coords, keys):
        buf = bufs[key]
        if buf is None:  # absent chunk = fill_value
            continue
        chunk = np.frombuffer(_decompress(buf, meta.get("compressor")), dtype).reshape(chunks)
        z0, y0, x0 = iz * chunks[0], iy * chunks[1], ix * chunks[2]
        z1, y1, x1 = (min(z0 + chunks[0], shape[0]), min(y0 + chunks[1], shape[1]),
                      min(x0 + chunks[2], shape[2]))
        out[z0:z1, y0:y1, x0:x1] = chunk[: z1 - z0, : y1 - y0, : x1 - x0]

    attr_buf = store.get(prefix + ".zattrs")
    attrs = json.loads(attr_buf) if attr_buf is not None else {}
    direction = attrs.get("direction")
    return image_from_array(
        out.astype(np.float32, copy=False),
        origin=attrs.get("origin", (0.0, 0.0, 0.0)),
        spacing=attrs.get("spacing", (1.0, 1.0, 1.0)),
        direction=None if direction is None else np.asarray(direction, np.float32).reshape(3, 3),
        device=device,
    )


def write_zarr_volume(image: Image, path, array_name: str = "image", chunk=(32, 128, 128)) -> None:
    """Write an Image (on any device) as a zlib-compressed (level 4) zarr v2
    directory store of float32 chunks, metadata in `.zattrs`."""
    root = Path(path) / array_name
    root.mkdir(parents=True, exist_ok=True)
    data = image.data.detach().float().cpu().numpy()
    shape = data.shape
    chunks = tuple(min(c, s) for c, s in zip(chunk, shape))
    meta = {
        "zarr_format": 2,
        "shape": list(shape),
        "chunks": list(chunks),
        "dtype": "<f4",
        "compressor": {"id": "zlib", "level": 4},
        "fill_value": 0.0,
        "order": "C",
        "filters": None,
    }
    (root / ".zarray").write_text(json.dumps(meta))

    def host(t):
        return t.detach().cpu().numpy()

    (root / ".zattrs").write_text(json.dumps({
        "origin": host(image.origin).tolist(),
        "spacing": host(image.spacing).tolist(),
        "direction": host(image.direction).reshape(-1).tolist(),
    }))
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for iz in range(grid[0]):
        for iy in range(grid[1]):
            for ix in range(grid[2]):
                z0, y0, x0 = iz * chunks[0], iy * chunks[1], ix * chunks[2]
                block = np.zeros(chunks, np.float32)
                part = data[z0: z0 + chunks[0], y0: y0 + chunks[1], x0: x0 + chunks[2]]
                block[: part.shape[0], : part.shape[1], : part.shape[2]] = part
                (root / ".".join(map(str, (iz, iy, ix)))).write_bytes(zlib.compress(block.tobytes(), 4))
