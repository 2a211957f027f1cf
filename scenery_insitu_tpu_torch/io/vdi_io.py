"""VDI serialization, artifact dumps and wire compression.

One ``.npz`` holds both buffers and the full metadata, so a single file
is a complete render-product checkpoint. The format is the reference's
(``io/vdi_io.py``): the same members, ``_META_FIELDS`` and codec tags, so
an artifact written by either package loads in the other. The large
members are compressed one by one with the codec (numpy's own deflate is
off), so a round trip is bit-exact.

A VDI is split for the wire into N column segments, each compressed on
its own, with the byte counts ("limits") carried alongside
(`pack_vdi_segments`).

Codecs: ``none``, ``zlib``, ``lzma`` and ``zstd``; ``zstd`` degrades to
``zlib`` (ledgered ``io.vdi_codec``) where the ``zstandard`` package is
missing. ``precision="qpack8"`` quantizes the buffers with the sort-last
wire's quantizer (``ops/wire.qpack8_quantize_np``) before the codec and
``load_vdi`` dequantizes them back to f32. The temporal-delta records
of ``ops/delta.py`` serialize through `pack_delta_blobs` and
`unpack_delta_payload`. The LZ4 block codec is ROADMAP A11 and raises
here.
"""

from __future__ import annotations

import io
import os
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from scenery_insitu_tpu_torch.convert import to_numpy
from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata

_META_FIELDS = VDIMetadata._fields


def _np(x) -> np.ndarray:
    """A host numpy array of a tensor (on any device) or an array."""
    return np.asarray(to_numpy(x))


# ------------------------------------------------------------------ codecs

def _zstd():
    import zstandard
    return zstandard


def _lz4(*_):
    raise NotImplementedError(
        "the lz4 codec (the reference's vendored native LZ4 block codec) "
        "is not ported yet (ROADMAP A11)")


def _lzma_codec():
    import lzma
    return (lambda b, level: lzma.compress(b, preset=level if level >= 0 else 1),
            lzma.decompress)


CODECS = {
    "none": (lambda b, level: b, lambda b: b),
    "zlib": (lambda b, level: zlib.compress(b, level if level >= 0 else 6),
             zlib.decompress),
    "zstd": (lambda b, level: _zstd().ZstdCompressor(
                 level=level if level >= 0 else 3).compress(b),
             lambda b: _zstd().ZstdDecompressor().decompress(b)),
    "lzma": _lzma_codec(),
    "lz4": (_lz4, _lz4),
}

_ZSTD_OK = None


def have_zstd() -> bool:
    """Is the optional zstandard package importable? Cached."""
    global _ZSTD_OK
    if _ZSTD_OK is None:
        try:
            import zstandard  # noqa: F401
            _ZSTD_OK = True
        except ImportError:
            _ZSTD_OK = False
    return _ZSTD_OK


def resolve_codec(codec: str) -> str:
    """Degrade "zstd" to stdlib "zlib" (one warning, one ledger row) when
    the zstandard package is missing. Applied at the writer entry points
    (`save_vdi`, `pack_vdi_segments`); `compress`/`decompress` stay
    strict — data written as zstd needs the module."""
    if codec == "zstd" and not have_zstd():
        from scenery_insitu_tpu_torch import obs

        obs.degrade("io.vdi_codec", "zstd", "zlib",
                    "zstandard is not installed (install zstandard for "
                    "the default codec)", stacklevel=3)
        return "zlib"
    return codec


def compress(data: bytes, codec: str = "zstd", level: int = -1) -> bytes:
    """level = -1 picks each codec's default."""
    try:
        enc, _ = CODECS[codec]
    except KeyError:
        raise ValueError(f"unknown codec {codec!r}; have {sorted(CODECS)}") from None
    return enc(data, level)


def decompress(data: bytes, codec: str = "zstd") -> bytes:
    try:
        _, dec = CODECS[codec]
    except KeyError:
        raise ValueError(f"unknown codec {codec!r}; have {sorted(CODECS)}") from None
    return dec(data)


# ----------------------------------------------------------- file artifacts

def save_vdi(path: str, vdi: VDI, meta: Optional[VDIMetadata] = None,
             codec: str = "zstd", precision: str = "f32",
             tile: Optional[Tuple[int, int, int]] = None,
             workers: int = 1) -> int:
    """Write a VDI (+ metadata) as one .npz artifact; returns bytes written.

    ``vdi`` and ``meta`` hold tensors (on any device) or numpy arrays.
    ``workers > 1`` compresses the large members (color, depth) on a
    thread pool; each member's blob is byte-identical to the serial path.
    ``tile=(index, total, col0)`` marks a partial-frame column-block
    artifact: this VDI holds columns [col0, col0 + width) of tile
    ``index`` of ``total`` (read back with `load_vdi_tile`).

    ``precision="qpack8"`` stores the wire's qpack8 codes (u32 colour,
    u16 depth pair) with their ``[near, far]`` scale, a quarter of the
    bytes before the codec, and tags the artifact and the metadata's
    ``precision``; lossy by the wire's contract.
    """
    if precision not in ("f32", "qpack8"):
        raise ValueError(f"precision must be 'f32' or 'qpack8', "
                         f"got {precision!r}")
    codec = resolve_codec(codec)
    if precision == "qpack8":
        from scenery_insitu_tpu_torch.ops.wire import (WIRE_CODES,
                                                       qpack8_quantize_np)

        qc, qd, near, far = qpack8_quantize_np(_np(vdi.color),
                                               _np(vdi.depth))
        members = {"color": qc, "depth": qd,
                   "__precision__": np.frombuffer(precision.encode(),
                                                  np.uint8),
                   "__qscale__": np.asarray([near, far], np.float32),
                   "__codec__": np.frombuffer(codec.encode(), np.uint8)}
        stamp = WIRE_CODES[precision]
    else:
        members = {"color": _np(vdi.color), "depth": _np(vdi.depth),
                   "__codec__": np.frombuffer(codec.encode(), np.uint8)}
        stamp = 0
    if tile is not None:
        members["__tile__"] = np.asarray(tile, np.int64)    # (idx, total, col0)
    if meta is not None:
        # stamp what this artifact holds: f32 or qpack8 buffers
        meta = meta._replace(precision=np.int32(stamp))
        for f in _META_FIELDS:
            members[f"meta_{f}"] = _np(getattr(meta, f))
    buf = io.BytesIO()
    packed = {}
    big = [k for k, v in members.items()
           if not k.startswith("__") and v.nbytes >= 1024]
    if workers > 1 and len(big) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(workers,
                                                len(big))) as pool:
            blobs = dict(zip(big, pool.map(
                lambda k: compress(members[k].tobytes(), codec), big)))
    else:
        blobs = {k: compress(members[k].tobytes(), codec) for k in big}
    for k, v in members.items():
        if k not in blobs:
            packed[k] = v
        else:
            packed[k] = np.frombuffer(blobs[k], np.uint8)
            packed[f"__shape__{k}"] = np.asarray(v.shape, np.int64)
            packed[f"__dtype__{k}"] = np.frombuffer(
                str(v.dtype).encode(), np.uint8)
    np.savez(buf, **packed)
    data = buf.getvalue()
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load_vdi(path: str) -> Tuple[VDI, Optional[VDIMetadata]]:
    """Inverse of `save_vdi`: host numpy arrays (VDI and metadata), as the
    reference returns them; a ``qpack8`` artifact is dequantized to f32.
    Artifacts from before the precision tag load with the f32 default."""
    with np.load(path) as z:
        codec = bytes(z["__codec__"]).decode() if "__codec__" in z else "none"
        precision = (bytes(z["__precision__"]).decode()
                     if "__precision__" in z else "f32")

        def member(k):
            if f"__shape__{k}" in z:
                raw = decompress(bytes(z[k]), codec)
                dtype = np.dtype(bytes(z[f"__dtype__{k}"]).decode())
                return np.frombuffer(raw, dtype).reshape(z[f"__shape__{k}"])
            return z[k]

        color, depth = member("color"), member("depth")
        if precision == "qpack8":
            from scenery_insitu_tpu_torch.ops.wire import (
                qpack8_dequantize_np)

            near, far = (float(x) for x in z["__qscale__"])
            color, depth = qpack8_dequantize_np(color, depth, near, far)
        vdi = VDI(color, depth)
        if "meta_projection" in z:
            meta = VDIMetadata(*[member(f"meta_{f}") if f"meta_{f}" in z
                                 else np.int32(0)
                                 for f in _META_FIELDS])
        else:
            meta = None
    return vdi, meta


def load_vdi_tile(path: str) -> Tuple[VDI, Optional[VDIMetadata],
                                      Optional[Tuple[int, int, int]]]:
    """`load_vdi` plus the artifact's tile placement: (vdi, meta,
    (tile_index, tiles_total, col0) or None for whole-frame artifacts).
    The tiles of one frame, side by side in tile order, are the frame."""
    vdi, meta = load_vdi(path)
    with np.load(path) as z:
        tile = (tuple(int(x) for x in z["__tile__"])
                if "__tile__" in z else None)
    return vdi, meta, tile


# ------------------------------------------------- temporal-delta records

def pack_delta_blobs(rec, codec: str = "zstd", level: int = -1
                     ) -> Tuple[dict, bytes, bytes]:
    """Serialize one ``ops/delta.DeltaRecord`` into the stream's three
    parts: ``(header_fields, color_blob, depth_blob)``. The header holds
    the mode, the generation and its base, and for P the run and value
    counts that re-split the blobs; the blobs are the codec-compressed
    payloads: the full code arrays for I, ``starts | lengths | values``
    for P, empty for SKIP."""
    codec = resolve_codec(codec)
    h = {"mode": rec.mode, "gen": int(rec.gen), "base": int(rec.base_gen)}
    if rec.mode == "I":
        cblob = compress(rec.c_payload[0].tobytes(), codec, level)
        dblob = compress(rec.d_payload[0].tobytes(), codec, level)
    elif rec.mode == "P":
        cs, cl, cv = rec.c_payload
        ds, dl, dv = rec.d_payload
        h.update(c_runs=int(cs.size), c_n=int(cv.size),
                 d_runs=int(ds.size), d_n=int(dv.size))
        cblob = compress(cs.tobytes() + cl.tobytes() + cv.tobytes(),
                         codec, level)
        dblob = compress(ds.tobytes() + dl.tobytes() + dv.tobytes(),
                         codec, level)
    elif rec.mode == "SKIP":
        cblob = dblob = b""
    else:
        raise ValueError(f"unknown delta mode {rec.mode!r}")
    return h, cblob, dblob


def delta_expected_bytes(dh: dict, cshape: Tuple[int, ...],
                         dshape: Tuple[int, ...]) -> Tuple[int, int]:
    """The decompressed byte counts a delta record's blobs must have;
    ``cshape``/``dshape`` are the FULL tile's code shapes."""
    mode = dh.get("mode")
    if mode == "I":
        return (int(np.prod(cshape)) * 4, int(np.prod(dshape)) * 2)
    if mode == "P":
        return (int(dh["c_runs"]) * 8 + int(dh["c_n"]) * 4,
                int(dh["d_runs"]) * 8 + int(dh["d_n"]) * 2)
    if mode == "SKIP":
        return 0, 0
    raise ValueError(f"unknown delta mode {mode!r}")


def unpack_delta_payload(dh: dict, craw: bytes, draw: bytes,
                         cshape: Tuple[int, ...], dshape: Tuple[int, ...]
                         ) -> Tuple[tuple, tuple]:
    """Inverse of `pack_delta_blobs` on the decompressed blobs: the
    ``(c_payload, d_payload)`` that ``ops/delta.DeltaDecoder.apply``
    takes."""
    mode = dh["mode"]
    if mode == "SKIP":
        return (), ()
    if mode == "I":
        return ((np.frombuffer(craw, np.uint32).reshape(cshape),),
                (np.frombuffer(draw, np.uint16).reshape(dshape),))
    if mode != "P":
        raise ValueError(f"unknown delta mode {mode!r}")

    def split(raw, runs, n, vdtype):
        b = np.frombuffer(raw, np.uint8)
        starts = b[:runs * 4].view(np.uint32)
        lengths = b[runs * 4:runs * 8].view(np.uint32)
        values = b[runs * 8:].view(vdtype)
        if values.size != n:
            raise ValueError(f"residual carries {values.size} values, "
                             f"header declares {n}")
        return starts, lengths, values

    return (split(craw, int(dh["c_runs"]), int(dh["c_n"]), np.uint32),
            split(draw, int(dh["d_runs"]), int(dh["d_n"]), np.uint16))


# ------------------------------------------------- variable-length segments

def pack_vdi_segments(vdi: VDI, n: int, codec: str = "zstd",
                      level: int = -1) -> Tuple[List[bytes], np.ndarray,
                                                np.ndarray]:
    """Split a VDI into ``n`` column segments and compress each on its own
    -> (blobs [2n: color0..colorN-1, depth0..], color_limits i64[n],
    depth_limits i64[n]), the variable-length collective's wire format."""
    codec = resolve_codec(codec)
    k, _, h, w = vdi.color.shape
    if w % n:
        raise ValueError(f"width {w} not divisible into {n} segments")
    color = _np(vdi.color)
    depth = _np(vdi.depth)
    cs = np.split(color, n, axis=-1)
    ds = np.split(depth, n, axis=-1)
    cblobs = [compress(np.ascontiguousarray(c).tobytes(), codec, level)
              for c in cs]
    dblobs = [compress(np.ascontiguousarray(d).tobytes(), codec, level)
              for d in ds]
    return (cblobs + dblobs,
            np.asarray([len(b) for b in cblobs], np.int64),
            np.asarray([len(b) for b in dblobs], np.int64))


def unpack_vdi_segments(blobs: Sequence[bytes], k: int, h: int, w: int,
                        codec: str = "zstd") -> VDI:
    """Inverse of `pack_vdi_segments` (host numpy arrays)."""
    if codec == "zstd" and blobs:
        # sniff the first blob's frame magic so the degrade is symmetric
        # with pack's: blobs from a zstandard-less writer (zlib) decode on
        # any reader, and zstd blobs on a zstandard-less reader get the
        # missing-module error instead of a zlib header failure
        if bytes(blobs[0][:4]) == b"\x28\xb5\x2f\xfd":
            if not have_zstd():
                raise ImportError(
                    "these segments were compressed with zstd but the "
                    "zstandard package is not installed")
        else:
            codec = "zlib"
    n = len(blobs) // 2
    seg_w = w // n
    cs = [np.frombuffer(decompress(b, codec), np.float32)
          .reshape(k, 4, h, seg_w) for b in blobs[:n]]
    ds = [np.frombuffer(decompress(b, codec), np.float32)
          .reshape(k, 2, h, seg_w) for b in blobs[n:]]
    return VDI(np.concatenate(cs, axis=-1), np.concatenate(ds, axis=-1))


def dump_path(directory: str, dataset: str, frame: int, kind: str) -> str:
    """Deterministic artifact names: ``<dir>/<dataset>_<kind>_<frame>.npz``."""
    os.makedirs(directory, exist_ok=True)
    return os.path.join(directory, f"{dataset}_{kind}_{frame:05d}.npz")
