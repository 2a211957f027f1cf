"""Host-boundary image utilities: display conversion (gamma applied once,
here), PNG files (written, and read back) and a PSNR metric. Numpy
only.

The reference writes its PNGs through PIL; this copy writes them with
``zlib`` and ``struct`` (RGBA, 8 bits a channel, filter 0), so the port
needs no imaging package. The decoded pixels are the same."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_display(image_chw: np.ndarray, gamma: float = 2.2,
               unpremultiply: bool = False) -> np.ndarray:
    """f32[4, H, W] premultiplied linear RGBA -> uint8[H, W, 4] display."""
    img = np.asarray(image_chw, np.float32)
    rgb, a = img[:3], img[3:4]
    if unpremultiply:
        rgb = rgb / np.maximum(a, 1e-6)
    rgb = np.clip(rgb, 0.0, 1.0) ** (1.0 / gamma)
    out = np.concatenate([rgb, np.clip(a, 0.0, 1.0)], axis=0)
    return (np.moveaxis(out, 0, -1) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgba: np.ndarray, level: int = 6) -> bytes:
    """uint8[H, W, 4] -> the bytes of an RGBA PNG."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w, c = rgba.shape
    if c != 4:
        raise ValueError(f"expected uint8[H, W, 4], got {rgba.shape}")
    # every scanline starts with its filter type, 0 (none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgba.reshape(h, w * 4)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters of ``rows uint8[H, 1 + stride]``
    (filter type first) -> ``uint8[H, stride]``."""
    h, n = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, n), np.int64)
    prior = np.zeros(n, np.int64)
    for y in range(h):
        kind, f = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = f
        elif kind == 2:
            cur = (f + prior) & 0xFF
        elif kind == 1:
            # recon[x] = f[x] + recon[x - bpp]: a running sum a channel
            cur = np.cumsum(f.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind in (3, 4):
            cur = np.zeros(n, np.int64)
            for x in range(n):
                a = cur[x - bpp] if x >= bpp else 0
                b = prior[x]
                if kind == 3:
                    pred = (a + b) // 2
                else:
                    c = prior[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else \
                        b if pb <= pc else c
                cur[x] = (f[x] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prior = cur
    return out.astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit RGB or RGBA, non-interlaced PNG's bytes:
    ``uint8[H, W, 3|4]`` (zlib and numpy only; every scanline filter)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"only 8-bit RGB/RGBA non-interlaced PNGs are "
                         f"read (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    c = 4 if ctype == 6 else 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw.reshape(h, 1 + w * c), c).reshape(h, w, c)


def load_png(path: str) -> np.ndarray:
    """`decode_png` of a file."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def save_png(path: str, image_chw: np.ndarray, gamma: float = 2.2) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(to_display(np.asarray(image_chw), gamma)))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)
