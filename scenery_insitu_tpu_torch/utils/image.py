"""Host-boundary image utilities: display conversion (gamma applied once,
here), PNG files and a PSNR metric. Numpy only.

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


def save_png(path: str, image_chw: np.ndarray, gamma: float = 2.2) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(to_display(np.asarray(image_chw), gamma)))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)
