"""Pure-Python blosc1 chunk codec (decoder + minimal encoder); a host copy
of `oai_analysis_2_tpu/utils/blosc.py:1-248`.

zarr v2's default compressor — and the one the reference's S3 OAI store uses
(dask_processing.py:29-43 via xarray/zarr) — is numcodecs.Blosc. No blosc
binary exists in this environment, so this module implements the c-blosc1
chunk format directly (README_CHUNK_FORMAT of c-blosc):

    header (16 B): version, versionlz, flags, typesize,
                   nbytes / blocksize / cbytes (uint32 LE)
    flags: bit0 byte-shuffle, bit1 pure-memcpy, bit2 bit-shuffle,
           bits 5-7 codec (0 blosclz, 1 lz4/lz4hc, 2 snappy, 3 zlib, 4 zstd)
    then ceil(nbytes/blocksize) x uint32 block offsets, then blocks.
    Each block holds `nstreams` streams of [int32 csize][payload]; a stream
    with csize == stream_size is stored verbatim. c-blosc splits a block
    into `typesize` streams for blosclz/lz4 when typesize is small; the
    decoder here detects the split adaptively (csize bookkeeping must be
    self-consistent) instead of replicating c-blosc's split heuristics.

Codecs: lz4 (pure-Python block decode), zlib, zstd (via the zstandard
wheel), memcpy. blosclz/snappy raise with a clear message. Byte-shuffle is
per block, numpy-vectorized; bit-shuffle is not supported.

The encoder emits unsplit zlib frames (exactly what c-blosc produces for
zlib, which it never splits) — valid input for any real blosc decoder; used
by tests and the `reencode` helper.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_BYTE_SHUFFLE = 0x1
_MEMCPY = 0x2
_BIT_SHUFFLE = 0x4
_CODEC_NAMES = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}


def lz4_decompress_block(src: bytes, dst_size: int) -> bytes:
    """Decode one raw LZ4 block (no frame header) of known output size."""
    dst = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        # literals
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        dst += src[i : i + lit]
        i += lit
        if i >= n:
            break  # last sequence: literals only
        # match
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("corrupt LZ4 stream: zero offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(dst) - offset
        if start < 0:
            raise ValueError("corrupt LZ4 stream: offset before start")
        for _ in range(mlen):  # may overlap — byte-by-byte semantics
            dst.append(dst[start])
            start += 1
    if len(dst) != dst_size:
        raise ValueError(f"LZ4 block decoded {len(dst)} bytes, expected {dst_size}")
    return bytes(dst)


def lz4_compress_block(src: bytes) -> bytes:
    """Minimal VALID LZ4 block: one all-literal sequence (no matches). Only
    used to build test vectors; real compression goes through zlib/zstd."""
    out = bytearray()
    lit = len(src)
    token_lit = min(lit, 15)
    out.append(token_lit << 4)
    if token_lit == 15:
        rest = lit - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    out += src
    return bytes(out)


def _unshuffle(buf: bytes, typesize: int) -> bytes:
    """Inverse byte-shuffle of one block. c-blosc shuffles only the largest
    prefix that is a multiple of typesize; the tail is copied verbatim."""
    n = len(buf)
    items = n // typesize
    main = items * typesize
    arr = np.frombuffer(buf[:main], np.uint8).reshape(typesize, items)
    out = np.empty((items, typesize), np.uint8)
    out[:] = arr.T
    return out.tobytes() + buf[main:]


def _shuffle(buf: bytes, typesize: int) -> bytes:
    n = len(buf)
    items = n // typesize
    main = items * typesize
    arr = np.frombuffer(buf[:main], np.uint8).reshape(items, typesize)
    return arr.T.copy().tobytes() + buf[main:]


def _codec_decompress(codec: int, payload: bytes, out_size: int) -> bytes:
    name = _CODEC_NAMES.get(codec, f"#{codec}")
    if name == "lz4":
        return lz4_decompress_block(payload, out_size)
    if name == "zlib":
        out = zlib.decompress(payload)
    elif name == "zstd":
        import zstandard

        out = zstandard.ZstdDecompressor().decompress(payload, max_output_size=out_size)
    else:
        raise NotImplementedError(f"blosc codec {name!r} is not supported here")
    if len(out) != out_size:
        raise ValueError(f"blosc stream decoded {len(out)} bytes, expected {out_size}")
    return out


def _decode_block(chunk: bytes, off: int, bsize: int, codec: int, nstreams: int) -> bytes:
    """Decode one block as `nstreams` [int32 csize][payload] streams; raises
    if the stream bookkeeping is inconsistent (used for adaptive split
    detection)."""
    neblock = bsize // nstreams
    if neblock * nstreams != bsize:
        raise ValueError("block not divisible into streams")
    parts = []
    p = off
    for _ in range(nstreams):
        if p + 4 > len(chunk):
            raise ValueError("stream header out of bounds")
        (csize,) = struct.unpack_from("<i", chunk, p)
        p += 4
        if csize < 0 or p + csize > len(chunk):
            raise ValueError("stream payload out of bounds")
        payload = chunk[p : p + csize]
        p += csize
        if csize == neblock:  # stored verbatim
            parts.append(payload)
        else:
            parts.append(_codec_decompress(codec, payload, neblock))
    return b"".join(parts)


def blosc_decompress(chunk: bytes) -> bytes:
    """Decode one blosc1 chunk to its original bytes."""
    if len(chunk) < 16:
        raise ValueError("not a blosc chunk (short header)")
    version, _versionlz, flags, typesize = chunk[0], chunk[1], chunk[2], chunk[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", chunk, 4)
    if version < 1 or version > 2 or cbytes > len(chunk) or nbytes == 0:
        raise ValueError("not a blosc chunk (bad header fields)")
    if flags & _MEMCPY:
        return bytes(chunk[16 : 16 + nbytes])
    if flags & _BIT_SHUFFLE:
        raise NotImplementedError("blosc bit-shuffle is not supported")
    codec = flags >> 5

    nblocks = -(-nbytes // blocksize)
    bstarts = struct.unpack_from(f"<{nblocks}I", chunk, 16)
    out = bytearray()
    for j in range(nblocks):
        bsize = min(blocksize, nbytes - j * blocksize)
        leftover = bsize != blocksize
        # c-blosc may split full blocks into `typesize` streams (codec- and
        # size-dependent); detect adaptively rather than guess its heuristics
        candidates = [1] if (leftover or typesize <= 1) else [typesize, 1]
        block = None
        err = None
        for nstreams in candidates:
            try:
                block = _decode_block(chunk, bstarts[j], bsize, codec, nstreams)
                break
            except (ValueError, NotImplementedError) as e:
                err = e
                if isinstance(e, NotImplementedError):
                    raise
        if block is None:
            raise ValueError(f"blosc block {j} undecodable: {err}")
        if flags & _BYTE_SHUFFLE and typesize > 1:
            block = _unshuffle(block, typesize)
        out += block
    return bytes(out)


def blosc_compress(
    data: bytes,
    typesize: int = 4,
    level: int = 5,
    shuffle: bool = True,
    blocksize: int = 1 << 18,
) -> bytes:
    """Encode bytes as a blosc1 chunk (zlib codec, unsplit streams — the
    exact stream layout c-blosc itself uses for zlib)."""
    nbytes = len(data)
    if nbytes == 0:
        raise ValueError("cannot encode an empty buffer")
    blocksize = min(blocksize, nbytes)
    # keep blocks typesize-aligned so shuffle covers whole items
    if blocksize % typesize:
        blocksize += typesize - blocksize % typesize
    nblocks = -(-nbytes // blocksize)
    flags = (3 << 5) | (_BYTE_SHUFFLE if (shuffle and typesize > 1) else 0)

    blocks = []
    for j in range(nblocks):
        raw = data[j * blocksize : (j + 1) * blocksize]
        if shuffle and typesize > 1:
            raw = _shuffle(raw, typesize)
        comp = zlib.compress(raw, level)
        if len(comp) >= len(raw):
            blocks.append(struct.pack("<i", len(raw)) + raw)  # stored
        else:
            blocks.append(struct.pack("<i", len(comp)) + comp)

    header_size = 16 + 4 * nblocks
    total = header_size + sum(len(b) for b in blocks)
    if total >= nbytes + 16:  # compression useless -> memcpy chunk
        header = struct.pack(
            "<BBBBIII", 1, 1, _MEMCPY, typesize, nbytes, blocksize, nbytes + 16
        )
        return header + data
    header = struct.pack("<BBBBIII", 1, 1, flags, typesize, nbytes, blocksize, total)
    offsets = []
    off = header_size
    for b in blocks:
        offsets.append(off)
        off += len(b)
    return header + struct.pack(f"<{nblocks}I", *offsets) + b"".join(blocks)
