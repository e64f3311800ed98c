"""The PyTorch port's NIfTI reader and writer against the JAX package's.

Files written by one package are read by the other, as `.nii` and
`.nii.gz`, and hand-built headers (int16 with `scl_slope` / `scl_inter`, no
qform or sform code, a qform quaternion, big-endian) are read by both.
Voxels must be bit-equal; origin, spacing and direction must agree to
1e-6.
"""

import gzip
import struct

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu.core.image import image_from_array as jimage
from oai_analysis_2_tpu.core.nifti import read_nifti as jread
from oai_analysis_2_tpu.core.nifti import write_nifti as jwrite
from oai_analysis_2_tpu_torch.core.image import image_from_array as timage
from oai_analysis_2_tpu_torch.core.nifti import read_nifti as tread
from oai_analysis_2_tpu_torch.core.nifti import write_nifti as twrite

SHAPE = (5, 7, 6)  # z, y, x


def _rotation(angle=0.3):
    c, s = np.cos(angle), np.sin(angle)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(0.2), -np.sin(0.2)], [0, np.sin(0.2), np.cos(0.2)]])
    return (rz @ rx).astype(np.float32)


META = dict(origin=(1.5, -2.25, 30.0), spacing=(0.36, 0.42, 0.7), direction=_rotation())


def _assert_same(t_img, j_img, data=None):
    """Port Image against JAX Image (and, if given, the expected voxels)."""
    got = t_img.data.numpy()
    want = np.asarray(j_img.data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if data is not None:
        np.testing.assert_array_equal(got, data)
    for k in ("origin", "spacing", "direction"):
        np.testing.assert_allclose(getattr(t_img, k).numpy(), np.asarray(getattr(j_img, k)), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_round_trip(tmp_path, suffix, writer):
    data = np.random.default_rng(0).normal(0, 100, SHAPE).astype(np.float32)
    path = tmp_path / f"vol{suffix}"
    if writer == "port":
        twrite(timage(data, device="cpu", **META), path)
    else:
        jwrite(jimage(data, **META), path)
    t_img, j_img = tread(path, device="cpu"), jread(path)
    _assert_same(t_img, j_img, data)
    for k, v in META.items():
        np.testing.assert_allclose(getattr(t_img, k).numpy(), np.asarray(v, np.float32), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_writers_agree(tmp_path, suffix):
    """Both writers put out the same bytes (a gzip header carries a time, so
    compressed files are compared decompressed)."""
    data = np.random.default_rng(4).normal(0, 100, SHAPE).astype(np.float32)
    twrite(timage(data, device="cpu", **META), tmp_path / f"t{suffix}")
    jwrite(jimage(data, **META), tmp_path / f"j{suffix}")
    raw = [(tmp_path / f"{w}{suffix}").read_bytes() for w in "tj"]
    if suffix == ".nii.gz":
        raw = [gzip.decompress(r) for r in raw]
    assert raw[0] == raw[1]


def test_write_from_other_types(tmp_path):
    """bf16 and bool volumes are written as float32; int16 keeps its type;
    `dtype=None` reads the file's own type."""
    data = np.random.default_rng(1).integers(-300, 300, SHAPE).astype(np.int16)
    twrite(timage(data, device="cpu"), tmp_path / "i16.nii")
    assert tread(tmp_path / "i16.nii", dtype=None, device="cpu").data.dtype == torch.int16
    jwrite(jimage(data), tmp_path / "j16.nii")
    assert (tmp_path / "i16.nii").read_bytes() == (tmp_path / "j16.nii").read_bytes()
    bf = torch.tensor(data.astype(np.float32) / 7).to(torch.bfloat16)
    twrite(timage(bf, device="cpu"), tmp_path / "bf.nii.gz")
    got = tread(tmp_path / "bf.nii.gz", device="cpu").data
    assert torch.equal(got, bf.to(torch.float32))
    twrite(timage(data > 0, device="cpu"), tmp_path / "mask.nii")
    np.testing.assert_array_equal(tread(tmp_path / "mask.nii", device="cpu").data.numpy(),
                                  (data > 0).astype(np.float32))


def _nifti_bytes(data, *, endian="<", pixdim=(1.0, 1.0, 1.0, 1.0), qform_code=0, sform_code=0,
                 quatern=(0.0, 0.0, 0.0), qoffset=(0.0, 0.0, 0.0), srow=None, slope=1.0, inter=0.0,
                 datatype=None):
    """A hand-built NIfTI-1 single file: header fields as given, voxels in
    `data`'s [z, y, x] order."""
    codes = {np.dtype(np.int16): 4, np.dtype(np.float32): 16, np.dtype(np.uint8): 2}
    arr = np.asarray(data)
    hdr = bytearray(348)
    dz, dy, dx = arr.shape
    struct.pack_into(endian + "i", hdr, 0, 348)
    struct.pack_into(endian + "8h", hdr, 40, 3, dx, dy, dz, 1, 1, 1, 1)
    struct.pack_into(endian + "2h", hdr, 70, datatype or codes[arr.dtype], arr.dtype.itemsize * 8)
    struct.pack_into(endian + "8f", hdr, 76, *pixdim, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into(endian + "f", hdr, 108, 352.0)
    struct.pack_into(endian + "2f", hdr, 112, slope, inter)
    struct.pack_into(endian + "2h", hdr, 252, qform_code, sform_code)
    struct.pack_into(endian + "3f", hdr, 256, *quatern)
    struct.pack_into(endian + "3f", hdr, 268, *qoffset)
    if srow is not None:
        struct.pack_into(endian + "12f", hdr, 280, *np.asarray(srow, np.float32).reshape(-1))
    hdr[344:348] = b"n+1\x00"
    return bytes(hdr) + b"\x00" * 4 + arr.astype(arr.dtype.newbyteorder(endian)).tobytes()


def test_int16_with_scaling(tmp_path):
    data = np.random.default_rng(2).integers(-1000, 1000, SHAPE).astype(np.int16)
    path = tmp_path / "scaled.nii.gz"
    path.write_bytes(gzip.compress(_nifti_bytes(data, slope=0.5, inter=10.0, pixdim=(1.0, 0.3, 0.4, 0.8),
                                                sform_code=1, srow=np.diag([-0.3, -0.4, 0.8, 0])[:3])))
    t_img, j_img = tread(path, device="cpu"), jread(path)
    _assert_same(t_img, j_img, data.astype(np.float32) * np.float32(0.5) + np.float32(10.0))
    np.testing.assert_allclose(t_img.spacing.numpy(), [0.3, 0.4, 0.8], atol=1e-6)
    np.testing.assert_allclose(t_img.direction.numpy(), np.eye(3), atol=1e-6)
    # dtype=None on scaled data: float32, as the scaling makes it
    assert tread(path, dtype=None, device="cpu").data.dtype == torch.float32


def test_no_qform_or_sform(tmp_path):
    """Neither code set: pixdim alone gives the spacing; RAS identity axes
    become LPS (-1, -1, 1)."""
    data = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    path = tmp_path / "bare.nii"
    path.write_bytes(_nifti_bytes(data, pixdim=(1.0, 0.5, 0.6, 1.5)))
    t_img, j_img = tread(path, device="cpu"), jread(path)
    _assert_same(t_img, j_img, data)
    np.testing.assert_allclose(t_img.spacing.numpy(), [0.5, 0.6, 1.5], atol=1e-6)
    np.testing.assert_allclose(t_img.direction.numpy(), np.diag([-1.0, -1.0, 1.0]), atol=1e-6)


@pytest.mark.parametrize("endian", ["<", ">"])
def test_rotated_qform(tmp_path, endian):
    """A rotated direction from a qform quaternion (qfac -1), read by both
    packages, in either byte order."""
    data = np.random.default_rng(3).integers(0, 255, SHAPE).astype(np.uint8)
    b, c, d = 0.1, -0.2, 0.3
    path = tmp_path / "rot.nii"
    path.write_bytes(_nifti_bytes(data, endian=endian, pixdim=(-1.0, 0.7, 0.8, 0.9), qform_code=1,
                                  quatern=(b, c, d), qoffset=(10.0, -20.0, 5.0)))
    t_img, j_img = tread(path, device="cpu"), jread(path)
    _assert_same(t_img, j_img, data.astype(np.float32))
    direction = t_img.direction.numpy()
    np.testing.assert_allclose(direction.T @ direction, np.eye(3), atol=1e-6)
    assert abs(direction[0, 1]) > 0.1  # really rotated
    np.testing.assert_allclose(t_img.origin.numpy(), [-10.0, 20.0, 5.0], atol=1e-6)


def test_bad_files_raise(tmp_path):
    (tmp_path / "junk.nii").write_bytes(b"\x00" * 400)
    with pytest.raises(ValueError, match="sizeof_hdr"):
        tread(tmp_path / "junk.nii", device="cpu")
    raw = bytearray(_nifti_bytes(np.zeros(SHAPE, np.float32)))
    raw[344:348] = b"abcd"
    (tmp_path / "magic.nii").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="magic"):
        tread(tmp_path / "magic.nii", device="cpu")
