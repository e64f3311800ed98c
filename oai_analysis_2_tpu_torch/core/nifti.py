"""NIfTI-1 (.nii / .nii.gz) reader and writer (host copy of
`oai_analysis_2_tpu/core/nifti.py:1-189`).

Physical-space metadata follows ITK's convention: NIfTI affines are RAS+,
ITK images live in LPS, so the first two affine rows change sign on read
and back on write. Voxels come back in [z, y, x] index order, as
`itk.GetArrayFromImage` gives them. Header parsing, gzip and the datatype
table are host numpy; `read_nifti` puts the volume on the requested device
(None: the card) and `write_nifti` brings a card image back to the host.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.image import Image, image_from_array

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

# RAS (NIfTI) <-> LPS (ITK) flip.
_RAS2LPS = np.diag([-1.0, -1.0, 1.0])


def _read_bytes(path: Path) -> bytes:
    raw = Path(path).read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw


def _quaternion_to_matrix(b: float, c: float, d: float, qfac: float) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    r = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    r[:, 2] *= qfac
    return r


def _parse_header(raw: bytes) -> dict:
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    endian = "<"
    if sizeof_hdr != 348:
        (sizeof_hdr,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr != 348:
            raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")
        endian = ">"
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"bad NIfTI magic: {magic!r}")
    datatype, bitpix = struct.unpack_from(endian + "2h", raw, 70)
    scl_slope, scl_inter = struct.unpack_from(endian + "2f", raw, 112)
    qform_code, sform_code = struct.unpack_from(endian + "2h", raw, 252)
    return dict(
        endian=endian,
        dim=struct.unpack_from(endian + "8h", raw, 40),
        datatype=datatype,
        bitpix=bitpix,
        pixdim=struct.unpack_from(endian + "8f", raw, 76),
        vox_offset=int(struct.unpack_from(endian + "f", raw, 108)[0]),
        scl_slope=scl_slope,
        scl_inter=scl_inter,
        qform_code=qform_code,
        sform_code=sform_code,
        quatern=struct.unpack_from(endian + "3f", raw, 256),
        qoffset=struct.unpack_from(endian + "3f", raw, 268),
        srow=np.array(struct.unpack_from(endian + "12f", raw, 280)).reshape(3, 4),
    )


def _affine_ras(hdr: dict) -> np.ndarray:
    """4x4 voxel-index -> RAS physical affine, per the NIfTI-1 spec: the
    sform if coded, else the qform, else the pixdim diagonal."""
    pixdim = hdr["pixdim"]
    if hdr["sform_code"] > 0:
        aff = np.eye(4)
        aff[:3, :] = hdr["srow"]
        return aff
    if hdr["qform_code"] > 0:
        qfac = -1.0 if pixdim[0] < 0 else 1.0
        r = _quaternion_to_matrix(*hdr["quatern"], qfac)
        aff = np.eye(4)
        aff[:3, :3] = r * np.array(pixdim[1:4])[None, :]
        aff[:3, 3] = hdr["qoffset"]
        return aff
    return np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])


def read_nifti(path, dtype=torch.float32, device=None) -> Image:
    """Read a .nii / .nii.gz volume into an Image on `device` (None: the
    card): LPS metadata, [z, y, x] data of `dtype` (None keeps the file's
    type, or float32 where `scl_slope` / `scl_inter` scale it)."""
    raw = _read_bytes(Path(path))
    hdr = _parse_header(raw)
    ndim = hdr["dim"][0]
    if ndim < 3:
        raise ValueError(f"expected a 3D volume, got dim0={ndim}")
    nx, ny, nz = hdr["dim"][1], hdr["dim"][2], hdr["dim"][3]
    n_extra = int(np.prod([max(d, 1) for d in hdr["dim"][4 : 1 + ndim]])) if ndim > 3 else 1
    if n_extra != 1:
        raise ValueError("only single-volume NIfTI files are supported")

    np_dtype = np.dtype(_DTYPES[hdr["datatype"]]).newbyteorder(hdr["endian"])
    data = np.frombuffer(raw, dtype=np_dtype, count=nx * ny * nz, offset=hdr["vox_offset"])
    vol = data.reshape(nz, ny, nx)  # x varies fastest -> [z, y, x]

    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if slope not in (0.0, 1.0) or inter != 0.0:
        vol = vol.astype(np.float32) * (slope if slope != 0.0 else 1.0) + inter
    # a writable array of native byte order: torch takes no other
    vol = np.array(vol, dtype=vol.dtype.newbyteorder("="))

    aff_lps = _affine_ras(hdr).copy()
    aff_lps[:3, :] = _RAS2LPS @ aff_lps[:3, :]
    m = aff_lps[:3, :3]
    spacing = np.linalg.norm(m, axis=0)
    spacing[spacing == 0] = 1.0
    direction = m / spacing[None, :]
    origin = aff_lps[:3, 3]
    return image_from_array(vol, origin=origin, spacing=spacing, direction=direction,
                            dtype=dtype, device=device)


def write_nifti(image: Image, path) -> None:
    """Write an Image (on any device) to .nii or .nii.gz: sform-only affine,
    RAS on disk, gzip at level 4. Types outside the NIfTI table (bf16,
    bool) are written as float32."""
    path = Path(path)
    tensor = image.data.detach().cpu()
    if tensor.dtype in (torch.bfloat16, torch.float16, torch.bool):
        tensor = tensor.to(torch.float32)
    data = tensor.numpy()
    if data.ndim != 3:
        raise ValueError("write_nifti expects a 3D volume")
    dz, dy, dx = data.shape
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    datatype = _DTYPE_CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8

    direction = image.direction.detach().cpu().numpy().astype(np.float64)
    spacing = image.spacing.detach().cpu().numpy().astype(np.float64)
    origin = image.origin.detach().cpu().numpy().astype(np.float64)
    m_lps = direction * spacing[None, :]
    srow = np.zeros((3, 4))
    srow[:, :3] = _RAS2LPS @ m_lps
    srow[:, 3] = _RAS2LPS @ origin

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, dx, dy, dz, 1, 1, 1, 1)
    struct.pack_into("<2h", hdr, 70, datatype, bitpix)
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing.astype(np.float32), 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope / scl_inter
    struct.pack_into("<2h", hdr, 252, 0, 2)  # qform_code 0, sform_code ALIGNED
    struct.pack_into("<12f", hdr, 280, *srow.reshape(-1).astype(np.float32))
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.ascontiguousarray(data).tobytes()
    if path.suffix == ".gz" or str(path).endswith(".nii.gz"):
        path.write_bytes(gzip.compress(payload, compresslevel=4))
    else:
        path.write_bytes(payload)
