"""The port's blosc codec, byte stores and zarr reader and writer
(`oai_analysis_2_tpu_torch/utils/{blosc,stores,zarr_io}.py`) against the
JAX package's, on the same seeded inputs.

Tolerances: compressed bytes and decoded volumes are held exactly equal;
spacing, origin and direction equal as float32. The "remote" stores are a
loopback `http.server` thread; the S3 path goes through
`OAI_TPU_S3_ENDPOINT` pointed at it. Nothing leaves the host.
"""

import datetime
import http.server
import json
import struct
import threading

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu.core.image import image_from_array as jimage
from oai_analysis_2_tpu.engine import stages as JStages
from oai_analysis_2_tpu.utils import blosc as JB
from oai_analysis_2_tpu.utils import stores as JS
from oai_analysis_2_tpu.utils import zarr_io as JZ
from oai_analysis_2_tpu_torch.core.image import image_from_array as timage
from oai_analysis_2_tpu_torch.core.nifti import write_nifti as twrite
from oai_analysis_2_tpu_torch.engine import stages as TStages
from oai_analysis_2_tpu_torch.utils import blosc as TB
from oai_analysis_2_tpu_torch.utils import stores as TS
from oai_analysis_2_tpu_torch.utils import zarr_io as TZ

SHAPE = (20, 33, 17)  # ragged against the (8, 16, 16) chunks
CHUNK = (8, 16, 16)
META = dict(origin=(1.0, 2.0, 3.0), spacing=(0.5, 0.6, 0.7))


def _direction():
    """A proper rotation about z by 30 degrees (not representable exactly in
    float32, so the metadata round trip is tested)."""
    c, s = np.cos(np.pi / 6), np.sin(np.pi / 6)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def _volume(seed=3, shape=SHAPE):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _assert_same_image(t, j):
    """A port Image against a JAX Image: data exactly, metadata in float32."""
    np.testing.assert_array_equal(t.data.cpu().numpy(), np.asarray(j.data))
    for k in ("origin", "spacing", "direction"):
        got, want = getattr(t, k).cpu().numpy(), np.asarray(getattr(j, k), np.float32)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=k)


class _Server:
    """A loopback HTTP file server over a directory in a daemon thread:
    optionally answers every path with a 500 once, or 403 always, and
    records the request headers."""

    def __init__(self, root, fail_first=False, status=None, capture=None):
        failed = set()

        class Handler(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **kw):
                super().__init__(*a, directory=str(root), **kw)

            def do_GET(self):  # noqa: N802 — http.server API
                if capture is not None:
                    capture.append({k.lower(): v for k, v in self.headers.items()})
                if status is not None:
                    self.send_error(status, "refused")
                    return
                if fail_first and self.path not in failed:
                    failed.add(self.path)
                    self.send_error(500, "transient")
                    return
                super().do_GET()

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


@pytest.fixture
def no_backoff(monkeypatch):
    monkeypatch.setattr(TS.time, "sleep", lambda s: None)
    monkeypatch.setattr(JS.time, "sleep", lambda s: None)


# ---------------------------------------------------------------------------
# blosc and LZ4
# ---------------------------------------------------------------------------


def _lz4_vectors():
    """Hand-built LZ4 blocks: (stream, decoded size)."""
    return {
        "literals": (TB.lz4_compress_block(bytes(range(256)) * 5), 1280),
        "match": (bytes([0x48]) + b"abcd" + struct.pack("<H", 4) + bytes([0x20]) + b"XY", 18),
        "overlap": (bytes([0x1F]) + b"z" + struct.pack("<H", 1) + bytes([0]), 20),
        # literal length 15 + 255 + 30 and a match of 15 + 4 + 255 + 7
        "extended": (bytes([0xFF]) + bytes([255, 30]) + bytes(range(256)) * 1 + bytes(range(44))
                     + struct.pack("<H", 3) + bytes([255, 7]) + bytes([0x10]) + b"!", 300 + 281 + 1),
    }


@pytest.mark.parametrize("name", ["literals", "match", "overlap", "extended"])
def test_lz4_block_decode_matches(name):
    stream, size = _lz4_vectors()[name]
    got = TB.lz4_decompress_block(stream, size)
    assert got == JB.lz4_decompress_block(stream, size)
    assert len(got) == size
    if name == "overlap":
        assert got == b"z" * 20
    if name == "match":
        assert got == b"abcd" * 4 + b"XY"


@pytest.mark.parametrize("n", [0, 14, 15, 300, 4096])
def test_lz4_compress_block_matches(n):
    data = bytes(np.random.default_rng(n).integers(0, 256, n, np.uint8))
    assert TB.lz4_compress_block(data) == JB.lz4_compress_block(data)
    assert TB.lz4_decompress_block(TB.lz4_compress_block(data), n) == data


@pytest.mark.parametrize("stream,size", [
    (bytes([0x10]) + b"a" + struct.pack("<H", 9) + bytes([0]), 100),  # offset before start
    (bytes([0x10]) + b"a" + struct.pack("<H", 0) + bytes([0]), 100),  # zero offset
    (bytes([0x20]) + b"ab", 3),  # wrong size
])
def test_lz4_corrupt_raises(stream, size):
    for mod in (TB, JB):
        with pytest.raises(ValueError):
            mod.lz4_decompress_block(stream, size)


@pytest.mark.parametrize("typesize,n", [(4, 64), (8, 120), (4, 66), (2, 7)])
def test_shuffle_matches(typesize, n):
    buf = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    shuffled = TB._shuffle(buf, typesize)
    assert shuffled == JB._shuffle(buf, typesize)
    assert TB._unshuffle(shuffled, typesize) == JB._unshuffle(shuffled, typesize) == buf


def _payloads():
    rng = np.random.default_rng(1)
    return {
        "f64": (rng.normal(size=5000).tobytes(), dict(typesize=8)),
        "f32_multiblock": (np.arange(10000, dtype=np.float32).tobytes(), dict(typesize=4, blocksize=16384)),
        "f32_noshuffle": (rng.normal(size=3000).astype(np.float32).tobytes(), dict(typesize=4, shuffle=False)),
        "bytes": (np.repeat(np.arange(50, dtype=np.uint8), 40).tobytes(), dict(typesize=1)),
        "memcpy": (rng.integers(0, 256, 1000, np.uint8).tobytes(), dict(typesize=1, shuffle=False)),
        "ragged": (rng.normal(size=1001).astype(np.float32).tobytes()[:-2], dict(typesize=4, blocksize=1000)),
    }


@pytest.mark.parametrize("name", list(_payloads()))
def test_blosc_bytes_equal_and_cross_decode(name):
    data, kw = _payloads()[name]
    chunk = TB.blosc_compress(data, **kw)
    assert chunk == JB.blosc_compress(data, **kw)
    assert TB.blosc_decompress(chunk) == JB.blosc_decompress(chunk) == data
    if name == "memcpy":
        assert chunk[2] & 0x2


def _split_chunk(data: bytes, typesize: int = 4) -> bytes:
    """A split-stream chunk as c-blosc's lz4 path writes it: one block of
    `typesize` byte-plane streams, each LZ4-coded or stored verbatim."""
    nbytes = len(data)
    shuffled = TB._shuffle(data, typesize)
    neblock = nbytes // typesize
    streams = b""
    for s in range(typesize):
        plane = shuffled[s * neblock: (s + 1) * neblock]
        comp = TB.lz4_compress_block(plane)
        streams += struct.pack("<i", neblock) + plane if len(comp) >= neblock else struct.pack("<i", len(comp)) + comp
    flags = (1 << 5) | 0x1  # lz4, byte shuffle
    header = struct.pack("<BBBBIII", 1, 1, flags, typesize, nbytes, nbytes, 16 + 4 + len(streams))
    return header + struct.pack("<I", 20) + streams


def _lz4_chunk(data: bytes) -> bytes:
    """An unsplit, unshuffled LZ4 chunk whose one stream has real matches
    (an RLE of the first byte, then literals)."""
    n = len(data)
    head = data[:1]
    # literals: the first byte; match: offset 1 over the run of equal bytes
    run = len(data) - len(data.lstrip(head))
    rest = data[run:]
    mlen = run - 1 - 4
    token = (1 << 4) | min(mlen, 15)
    stream = bytes([token]) + head + struct.pack("<H", 1)
    if mlen >= 15:
        left = mlen - 15
        stream += bytes([255] * (left // 255) + [left % 255])
    stream += TB.lz4_compress_block(rest)
    header = struct.pack("<BBBBIII", 1, 1, 1 << 5, 1, n, n, 16 + 4 + 4 + len(stream))
    return header + struct.pack("<I", 20) + struct.pack("<i", len(stream)) + stream


def test_blosc_split_stream_and_lz4_chunks_decode_in_both():
    data = np.arange(64, dtype=np.float32).tobytes()
    split = _split_chunk(data)
    assert TB.blosc_decompress(split) == JB.blosc_decompress(split) == data
    lz = bytes([7]) * 300 + bytes(range(100))
    chunk = _lz4_chunk(lz)
    assert TB.blosc_decompress(chunk) == JB.blosc_decompress(chunk) == lz


def test_blosc_rejects_what_jax_rejects():
    for mod in (TB, JB):
        with pytest.raises(ValueError):
            mod.blosc_decompress(b"\x00" * 8)
        bitshuffle = struct.pack("<BBBBIII", 1, 1, (3 << 5) | 0x4, 4, 16, 16, 36) + bytes(20)
        with pytest.raises(NotImplementedError):
            mod.blosc_decompress(bitshuffle)


# ---------------------------------------------------------------------------
# zarr
# ---------------------------------------------------------------------------


def test_zarr_written_by_jax_read_by_port_and_back(tmp_path):
    vol = _volume()
    j_img = jimage(vol, direction=_direction(), **META)
    JZ.write_zarr_volume(j_img, tmp_path / "jax.zarr", chunk=CHUNK)
    t_img = TZ.read_zarr_volume(tmp_path / "jax.zarr", device="cpu")
    _assert_same_image(t_img, JZ.read_zarr_volume(tmp_path / "jax.zarr"))
    np.testing.assert_array_equal(t_img.data.numpy(), vol)

    TZ.write_zarr_volume(timage(vol, direction=_direction(), device="cpu", **META), tmp_path / "port.zarr",
                         chunk=CHUNK)
    _assert_same_image(t_img, JZ.read_zarr_volume(tmp_path / "port.zarr"))
    # the two writers wrote the same files, byte for byte
    names = sorted(p.name for p in (tmp_path / "jax.zarr" / "image").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port.zarr" / "image").iterdir())
    assert len(names) == 2 + 3 * 3 * 2
    for name in names:
        a, b = ((tmp_path / w / "image" / name).read_bytes() for w in ("jax.zarr", "port.zarr"))
        assert a == b, name


def test_zarr_writer_takes_bf16_and_reader_puts_on_device(tmp_path):
    vol = _volume()
    img = timage(torch.tensor(vol).to(torch.bfloat16), device="cpu")
    TZ.write_zarr_volume(img, tmp_path / "bf.zarr", chunk=CHUNK)
    back = TZ.read_zarr_volume(tmp_path / "bf.zarr", device="cpu")
    assert back.data.dtype == torch.float32 and back.device.type == "cpu"
    np.testing.assert_array_equal(back.data.numpy(), img.data.float().numpy())


def _blosc_store(root, vol, chunks, encode, at_root=False, attrs=None):
    """A hand-written zarr v2 store with blosc chunks from `encode`."""
    arr = root if at_root else root / "image"
    arr.mkdir(parents=True)
    (arr / ".zarray").write_text(json.dumps({
        "zarr_format": 2, "shape": list(vol.shape), "chunks": list(chunks), "dtype": "<f4",
        "compressor": {"id": "blosc", "cname": "zlib", "clevel": 5, "shuffle": 1},
        "fill_value": 0.0, "order": "C", "filters": None,
    }))
    if attrs is not None:
        (arr / ".zattrs").write_text(json.dumps(attrs))
    for iz in range(-(-vol.shape[0] // chunks[0])):
        block = np.zeros(chunks, np.float32)
        part = vol[iz * chunks[0]: (iz + 1) * chunks[0]]
        block[: len(part)] = part
        (arr / f"{iz}.0.0").write_bytes(encode(block.tobytes()))


@pytest.mark.parametrize("codec", ["zlib", "lz4", "lz4_split"])
@pytest.mark.parametrize("at_root", [False, True])
def test_blosc_zarr_reads_in_both(tmp_path, codec, at_root):
    """A blosc zarr store (the reference cohort's format), with zlib chunks,
    LZ4 chunks with real matches, or c-blosc's split-stream layout, at the
    root or under `image/`."""
    vol = _volume(shape=(8, 16, 16))
    vol[:, :8] = 0.0  # each chunk starts with a run: LZ4 codes it as a match
    encode = {"zlib": lambda b: TB.blosc_compress(b, typesize=4), "lz4": _lz4_chunk, "lz4_split": _split_chunk}[codec]
    _blosc_store(tmp_path / "case.zarr", vol, (4, 16, 16), encode, at_root, {"spacing": [0.7, 0.36, 0.36]})
    t_img = TZ.read_zarr_volume(tmp_path / "case.zarr", device="cpu")
    _assert_same_image(t_img, JZ.read_zarr_volume(tmp_path / "case.zarr"))
    np.testing.assert_array_equal(t_img.data.numpy(), vol)


def test_zarr_absent_chunk_reads_as_fill(tmp_path):
    vol = _volume()
    TZ.write_zarr_volume(timage(vol, device="cpu"), tmp_path / "v.zarr", chunk=CHUNK)
    arr = tmp_path / "v.zarr" / "image"
    meta = json.loads((arr / ".zarray").read_text())
    meta["fill_value"] = 7.0
    (arr / ".zarray").write_text(json.dumps(meta))
    (arr / "0.0.0").unlink()
    (arr / "2.2.1").unlink()
    t_img = TZ.read_zarr_volume(tmp_path / "v.zarr", device="cpu")
    _assert_same_image(t_img, JZ.read_zarr_volume(tmp_path / "v.zarr"))
    got = t_img.data.numpy()
    assert (got[:8, :16, :16] == 7.0).all() and (got[16:, 32:, 16:] == 7.0).all()
    np.testing.assert_array_equal(got[8:16], vol[8:16])


def test_zarr_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):
        TZ.read_zarr_volume(tmp_path / "nothing.zarr", device="cpu")
    arr = tmp_path / "flat.zarr"
    arr.mkdir()
    (arr / ".zarray").write_text(json.dumps({"shape": [4, 4], "chunks": [4, 4], "dtype": "<f4"}))
    with pytest.raises(ValueError, match="3D"):
        TZ.read_zarr_volume(arr, device="cpu")
    with pytest.raises(NotImplementedError, match="bz2"):
        TZ._decompress(b"", {"id": "bz2"})


def test_readimage_dispatch_and_device(tmp_path, monkeypatch):
    """readimage: a zarr directory (by suffix or by its .zarray), an http URL
    and a NIfTI file, each equal to the JAX stage's read; None means the
    card and raises without one."""
    vol = _volume()
    img = timage(vol, direction=_direction(), device="cpu", **META)
    TZ.write_zarr_volume(img, tmp_path / "knee.zarr", chunk=CHUNK)
    TZ.write_zarr_volume(img, tmp_path / "plain", array_name="", chunk=CHUNK)  # .zarray at the root
    twrite(img, tmp_path / "knee.nii.gz")
    srv = _Server(tmp_path)
    try:
        for src in (tmp_path / "knee.zarr", tmp_path / "plain", tmp_path / "knee.nii.gz", f"{srv.url}/knee.zarr"):
            t, j = TStages.readimage(src, device="cpu"), JStages.readimage(src)
            _assert_same_image(t, j)
            np.testing.assert_array_equal(t.data.numpy(), vol)
    finally:
        srv.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for src in (tmp_path / "knee.zarr", tmp_path / "knee.nii.gz"):
        with pytest.raises(RuntimeError, match="CUDA"):
            TStages.readimage(src)
    with pytest.raises(RuntimeError, match="CUDA"):
        TZ.read_zarr_volume(tmp_path / "knee.zarr")


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------


@pytest.fixture
def served(tmp_path):
    vol = _volume()
    TZ.write_zarr_volume(timage(vol, device="cpu", **META), tmp_path / "vol.zarr", chunk=CHUNK)
    srv = _Server(tmp_path)
    yield srv, vol, tmp_path
    srv.close()


def test_http_store_reads_and_404_is_none(served):
    srv, vol, _ = served
    store = TS.open_store(f"{srv.url}/vol.zarr")
    assert isinstance(store, TS.HTTPStore) and store.signer is None
    assert store.get("image/.zarray") == JS.open_store(f"{srv.url}/vol.zarr").get("image/.zarray")
    assert store.get("image/9.9.9") is None
    keys = ["image/0.0.0", "image/1.1.1", "image/missing"]
    many = store.getmany(keys)
    assert list(many) == keys and many["image/missing"] is None
    assert many["image/1.1.1"] == (served[2] / "vol.zarr" / "image" / "1.1.1").read_bytes()
    back = TZ.read_zarr_volume(f"{srv.url}/vol.zarr", device="cpu")
    np.testing.assert_array_equal(back.data.numpy(), vol)


def test_http_store_missing_store_raises(served):
    srv, _, _ = served
    with pytest.raises(FileNotFoundError):
        TZ.read_zarr_volume(f"{srv.url}/nope.zarr", device="cpu")


def test_http_store_retries_transient_500(tmp_path, no_backoff):
    vol = _volume()
    TZ.write_zarr_volume(timage(vol, device="cpu"), tmp_path / "vol.zarr", chunk=CHUNK)
    srv = _Server(tmp_path, fail_first=True)  # every path answers 500 once
    try:
        back = TZ.read_zarr_volume(f"{srv.url}/vol.zarr", device="cpu")
    finally:
        srv.close()
    np.testing.assert_array_equal(back.data.numpy(), vol)


def test_http_store_exhausted_retries_raise(tmp_path, no_backoff):
    srv = _Server(tmp_path, status=503)
    try:
        with pytest.raises(IOError, match="after 2 attempts"):
            TS.HTTPStore(srv.url, retries=2).get(".zarray")
    finally:
        srv.close()
    with pytest.raises(IOError):
        TS.HTTPStore("http://127.0.0.1:1", retries=1).get(".zarray")  # nothing listens


def test_http_store_403(tmp_path):
    """403 reads as absent anonymously, and raises with a signer attached
    (an authentication failure must not zero-fill a volume)."""
    srv = _Server(tmp_path, status=403)
    try:
        assert TS.HTTPStore(srv.url).get(".zarray") is None
        signed = TS.HTTPStore(srv.url, signer=TS.SigV4Signer("AK", "SK", "us-east-1"))
        with pytest.raises(IOError, match="403"):
            signed.get(".zarray")
    finally:
        srv.close()


@pytest.mark.parametrize("token", [None, "tok"])
def test_sigv4_headers_equal_jax(token):
    now = datetime.datetime(2026, 8, 19, 12, 0, 0, tzinfo=datetime.timezone.utc)
    for url in ("https://b.s3.eu-west-1.amazonaws.com/k/.zarray", "http://127.0.0.1:9000/bucket/a%20b/0.0.0"):
        got = TS.SigV4Signer("AKID", "SECRET", "eu-west-1", session_token=token)(url, now=now)
        want = JS.SigV4Signer("AKID", "SECRET", "eu-west-1", session_token=token)(url, now=now)
        assert got == want
        assert got["Authorization"].startswith("AWS4-HMAC-SHA256 Credential=AKID/20260819/eu-west-1/s3/aws4_request")
        assert ("x-amz-security-token" in got) == (token is not None)


def test_s3_url_mapping_equals_jax(monkeypatch):
    for var in ("OAI_TPU_S3_ENDPOINT", "AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_REGION",
                "AWS_DEFAULT_REGION", "AWS_SESSION_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    for env in ({}, {"AWS_REGION": "us-west-2"}, {"AWS_DEFAULT_REGION": "eu-central-1"},
                {"OAI_TPU_S3_ENDPOINT": "http://127.0.0.1:9000/"},
                {"AWS_ACCESS_KEY_ID": "AK", "AWS_SECRET_ACCESS_KEY": "SK", "AWS_SESSION_TOKEN": "t"}):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            for url in ("s3://oai-bucket/knees/case1.zarr", "s3://oai-bucket"):
                t, j = TS._s3_store(url), JS._s3_store(url)
                assert t.base_url == j.base_url
                assert (t.signer is None) == (j.signer is None)
                if t.signer is not None:
                    assert vars(t.signer) == vars(j.signer)
    assert TS._s3_store("s3://b/p").base_url == "https://b.s3.us-east-1.amazonaws.com/p"
    assert [TS.is_remote(p) for p in ("s3://b", "http://h", "https://h", "/tmp/x", 3)] == [True] * 3 + [False] * 2
    assert isinstance(TS.open_store("/some/dir"), TS.DirectoryStore)


def test_s3_store_through_endpoint_signed(tmp_path, monkeypatch):
    """s3:// through OAI_TPU_S3_ENDPOINT (path-style {endpoint}/{bucket}/
    {prefix}/{key}), SigV4-signed from the env credentials; the headers the
    server saw are the ones the JAX signer makes for the same request."""
    vol = _volume()
    TZ.write_zarr_volume(timage(vol, device="cpu", **META), tmp_path / "priv" / "vol.zarr", chunk=CHUNK)
    captured = []
    srv = _Server(tmp_path, capture=captured)
    monkeypatch.setenv("OAI_TPU_S3_ENDPOINT", srv.url)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIDEXAMPLE")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "secret")
    monkeypatch.setenv("AWS_SESSION_TOKEN", "tok")
    monkeypatch.setenv("AWS_REGION", "us-east-1")
    try:
        back = TStages.readimage("s3://priv/vol.zarr", device="cpu")
    finally:
        srv.close()
    np.testing.assert_array_equal(back.data.numpy(), vol)
    h = captured[0]
    auth = h["authorization"]
    assert auth.startswith("AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/") and "/us-east-1/s3/aws4_request" in auth
    assert "SignedHeaders=host;x-amz-content-sha256;x-amz-date;x-amz-security-token" in auth
    now = datetime.datetime.strptime(h["x-amz-date"], "%Y%m%dT%H%M%SZ").replace(tzinfo=datetime.timezone.utc)
    want = JS.SigV4Signer("AKIDEXAMPLE", "secret", "us-east-1", session_token="tok")(
        f"{srv.url}/priv/vol.zarr/image/.zarray", now=now)
    assert auth == want["Authorization"] and h["x-amz-security-token"] == "tok"


def test_directory_store(tmp_path):
    (tmp_path / "a").write_bytes(b"x")
    (tmp_path / "sub").mkdir()
    store = TS.DirectoryStore(tmp_path)
    assert store.get("a") == b"x" and store.get("sub") is None and store.get("b") is None
    assert store.getmany(["a", "b"]) == {"a": b"x", "b": None}
