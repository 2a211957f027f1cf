"""ctypes binding of the native LZ4 block codec
(``ingest/native/lz4_block.cpp``, the reference's source), the fast codec
of the VDI wire: its decode is a near-memcpy.

Blob layout, the reference's: 8 bytes of little-endian uncompressed size,
then the raw LZ4 block stream. An empty payload is the 8-byte header
alone. The library is built with ``g++`` at first use
(``ingest.shm.ensure_built``).
"""

from __future__ import annotations

import ctypes
import shutil

_lib = None


def _load():
    global _lib
    if _lib is None:
        from scenery_insitu_tpu_torch.ingest.shm import ensure_built

        lib = ctypes.CDLL(ensure_built(["liblz4block.so"])["liblz4block.so"])
        for name in ("lz4b_compress", "lz4b_decompress"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                           ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
        lib.lz4b_bound.restype = ctypes.c_uint64
        lib.lz4b_bound.argtypes = [ctypes.c_uint64]
        _lib = lib
    return _lib


def available() -> bool:
    """Can the codec be built here (is ``g++`` on the path)?"""
    return _lib is not None or shutil.which("g++") is not None


def compress(data: bytes) -> bytes:
    lib = _load()
    n = len(data)
    header = n.to_bytes(8, "little")
    if n == 0:
        return header
    cap = int(lib.lz4b_bound(n))
    out = (ctypes.c_uint8 * cap)()
    written = lib.lz4b_compress(data, n, out, cap)
    if written == 0:
        raise OSError(f"lz4 compression failed for {n}-byte payload")
    return header + ctypes.string_at(out, written)


def decompress(blob: bytes) -> bytes:
    if len(blob) < 8:
        raise ValueError("lz4 blob shorter than its size header")
    n = int.from_bytes(blob[:8], "little")
    if n == 0:
        if len(blob) != 8:
            raise ValueError("empty lz4 payload with trailing bytes")
        return b""
    # the header is untrusted wire data: bound the allocation by the
    # format's largest expansion (~255x a match-run byte) before
    # allocating n bytes; the native decoder's own checks run after
    if n > (len(blob) - 8) * 255 + 16:
        raise ValueError(
            f"corrupt lz4 blob: header claims {n} bytes from "
            f"{len(blob) - 8} compressed — exceeds format max expansion")
    lib = _load()
    out = (ctypes.c_uint8 * n)()
    got = lib.lz4b_decompress(blob[8:], len(blob) - 8, out, n)
    if got != n:
        raise ValueError(f"corrupt lz4 blob: header says {n} bytes, the "
                         f"decoder produced {got}")
    return ctypes.string_at(out, n)
