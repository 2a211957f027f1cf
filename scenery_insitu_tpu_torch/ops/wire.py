"""Supersegment wire formats of the sort-last exchange.

Every supersegment slot is 6 f32 lanes (24 B) in memory. The exchange
may ship a narrower element encoding instead: fragments are encoded just
before the exchange and decoded just after it, and the merge and the
resegment always run in f32.

``f32``     the identity: 24 B a slot, bit-exact.
``bf16``    the colour and depth lanes cast to bfloat16: 12 B a slot.
            ``+inf`` empty-slot depths survive the cast exactly; the
            rounding is monotone, so a sorted stream stays sorted.
``qpack8``  premultiplied RGBA as u8 unorm in one u32 lane (4 B) and
            the (start, end) depth pair as one u8 each against the
            fragment's ``[near, far]`` f32 scale, in one u16 lane
            (2 B): 6 B a slot. The depth byte 255 (the u16 ``0xFFFF``)
            is the ``+inf`` sentinel, so empty slots round-trip exactly;
            live depth bytes are clamped to 0..254. The start byte is
            the high half, so u16 order is (start, end) order.

The quantized formats are lossy by contract: one colour quantum (1/255)
and one depth quantum (the fragment's depth span / 254). Both quantizers
are monotone, so a per-pixel depth-sorted stream decodes sorted.

The codes are the reference's (``ops/wire.py`` of the JAX package) bit
for bit, in its dtypes (``torch.uint32`` colour, ``torch.uint16``
depth). torch has no shifts on those dtypes, so packing and unpacking
run in ``int32``/``int64`` and convert at the boundary. ``torch.round``
rounds half to even, as ``jnp.round`` and ``np.round`` do.

The numpy twins (`qpack8_quantize_np`, `qpack8_dequantize_np`) are the
same format for the host: ``io/vdi_io.save_vdi(precision="qpack8")``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

WIRE_FORMATS = ("f32", "bf16", "qpack8")

# precision codes for VDIMetadata.precision / stored-artifact tags
WIRE_CODES = {"f32": 0, "qpack8": 1, "bf16": 2}

# wire bytes of one supersegment slot: (colour, depth)
WIRE_SLOT_BYTES = {"f32": (16, 8), "bf16": (8, 4), "qpack8": (4, 2)}

_QMAX = 254          # live depth codes span 0..254; 255 is the +inf sentinel
_SENTINEL = 255


def wire_slot_bytes(wire: str) -> Tuple[int, int]:
    """(color_bytes, depth_bytes) one supersegment slot costs on the wire."""
    try:
        return WIRE_SLOT_BYTES[wire]
    except KeyError:
        raise ValueError(f"unknown wire format {wire!r}; have {WIRE_FORMATS}") from None


def _unknown(wire: str):
    return ValueError(f"unknown wire format {wire!r}; have {WIRE_FORMATS}")


def _depth_scale(depth: torch.Tensor):
    """The fragment's [near, far] over its finite depths, pinned to
    [0, 1] when it has none and to a unit span when near == far, so the
    quantizer stays finite. Returns (finite, near, far, enc_span)."""
    finite = torch.isfinite(depth)
    near = torch.amin(torch.where(finite, depth, torch.inf))
    far = torch.amax(torch.where(finite, depth, -torch.inf))
    ok = torch.isfinite(near) & torch.isfinite(far)
    near = torch.where(ok, near, 0.0)
    far = torch.where(ok, far, 1.0)
    span = far - near
    enc_span = torch.where(span > 0, span, 1.0)
    return finite, near, far, enc_span


def _bcast_scale(scale: torch.Tensor, ndim: int):
    """(near, far) of a ``[..., 2]`` scale, shaped to broadcast against
    an ``ndim``-D encoded tensor (leading dims align)."""
    near, far = scale[..., 0], scale[..., 1]
    pad = (1,) * (ndim - near.dim())
    return near.reshape(near.shape + pad), far.reshape(far.shape + pad)


def _pack_rgba(color: torch.Tensor) -> torch.Tensor:
    """[..., 4, H, W] f32 in [0, 1] -> u32[..., H, W]
    (R | G<<8 | B<<16 | A<<24)."""
    c8 = torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.int64)
    packed = (c8[..., 0, :, :] | (c8[..., 1, :, :] << 8)
              | (c8[..., 2, :, :] << 16) | (c8[..., 3, :, :] << 24))
    return packed.to(torch.uint32)


def _unpack_rgba(enc: torch.Tensor) -> torch.Tensor:
    """Inverse of `_pack_rgba` -> f32[..., 4, H, W]."""
    e = enc.to(torch.int64)
    return torch.stack([(e >> s) & 0xFF for s in (0, 8, 16, 24)],
                       dim=-3).to(torch.float32) / 255.0


# ------------------------------------------------------------- VDI fragments

def encode_fragment(color: torch.Tensor, depth: torch.Tensor, wire: str
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """Encode one VDI fragment (color [..., 4, H, W] premultiplied f32,
    depth [..., 2, H, W] f32 with +inf empty slots) for the wire.

    Returns ``(color_enc, depth_enc, scale)``. ``scale`` is the fragment's
    ``f32[2]`` ``[near, far]`` (qpack8 only, else None); it travels with
    the fragment. qpack8 packs the channel axes away: color ->
    u32[..., H, W], depth -> u16[..., H, W] (start_q<<8 | end_q)."""
    if wire == "f32":
        return color, depth, None
    if wire == "bf16":
        return color.to(torch.bfloat16), depth.to(torch.bfloat16), None
    if wire != "qpack8":
        raise _unknown(wire)
    finite, near, far, enc_span = _depth_scale(depth)
    q = torch.clamp(torch.round((depth - near) / enc_span * _QMAX), 0.0,
                    float(_QMAX))
    q = torch.where(finite, q, float(_SENTINEL)).to(torch.int32)
    d16 = (q[..., 0, :, :] << 8) | q[..., 1, :, :]
    return _pack_rgba(color), d16.to(torch.uint16), torch.stack([near, far])


def decode_fragment(color_enc: torch.Tensor, depth_enc: torch.Tensor,
                    scale: Optional[torch.Tensor], wire: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `encode_fragment` -> f32 (color [..., 4, H, W], depth
    [..., 2, H, W]). ``scale`` may carry leading dims (``[..., 2]``, for
    example ``[n, 2]``: one scale per source fragment) that broadcast
    against the fragment's leading dims."""
    if wire == "f32":
        return color_enc, depth_enc
    if wire == "bf16":
        return color_enc.to(torch.float32), depth_enc.to(torch.float32)
    if wire != "qpack8":
        raise _unknown(wire)
    near, far = _bcast_scale(scale, depth_enc.dim())
    span = torch.clamp(far - near, min=0.0)
    d = depth_enc.to(torch.int32)
    hi, lo = d >> 8, d & 0xFF
    ds = torch.where(hi == _SENTINEL, torch.inf,
                     near + hi.to(torch.float32) / _QMAX * span)
    de = torch.where(lo == _SENTINEL, torch.inf,
                     near + lo.to(torch.float32) / _QMAX * span)
    return _unpack_rgba(color_enc), torch.stack([ds, de], dim=-3)


# ------------------------------------------------------ plain-image fragments

def encode_plain(image: torch.Tensor, depth: torch.Tensor, wire: str
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """Encode a plain fragment (image [..., 4, H, W] premultiplied, depth
    [..., H, W] with +inf empty pixels). qpack8 here is RGBA -> u32 and
    ONE u16 depth a pixel over 0..65534 (0xFFFF is the +inf sentinel)."""
    if wire == "f32":
        return image, depth, None
    if wire == "bf16":
        return image.to(torch.bfloat16), depth.to(torch.bfloat16), None
    if wire != "qpack8":
        raise _unknown(wire)
    qmax = 65534.0
    finite, near, far, enc_span = _depth_scale(depth)
    q = torch.clamp(torch.round((depth - near) / enc_span * qmax), 0.0, qmax)
    d16 = torch.where(finite, q, 65535.0).to(torch.int32).to(torch.uint16)
    return _pack_rgba(image), d16, torch.stack([near, far])


def decode_plain(image_enc: torch.Tensor, depth_enc: torch.Tensor,
                 scale: Optional[torch.Tensor], wire: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `encode_plain` -> f32 (image [..., 4, H, W], depth
    [..., H, W])."""
    if wire == "f32":
        return image_enc, depth_enc
    if wire == "bf16":
        return image_enc.to(torch.float32), depth_enc.to(torch.float32)
    if wire != "qpack8":
        raise _unknown(wire)
    near, far = _bcast_scale(scale, depth_enc.dim())
    span = torch.clamp(far - near, min=0.0)
    d = depth_enc.to(torch.int32)
    depth = torch.where(d == 0xFFFF, torch.inf,
                        near + d.to(torch.float32) / 65534.0 * span)
    return _unpack_rgba(image_enc), depth


# -------------------------------------------------------- host-side (numpy)

def qpack8_quantize_np(color: np.ndarray, depth: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Numpy twin of the qpack8 VDI encode, for the host. color
    f32[K, 4, H, W], depth f32[K, 2, H, W] -> (color u32[K, H, W], depth
    u16[K, H, W], near, far); the same codes as `encode_fragment`."""
    color = np.asarray(color, np.float32)
    depth = np.asarray(depth, np.float32)
    finite = np.isfinite(depth)
    if finite.any():
        near = float(depth[finite].min())
        far = float(depth[finite].max())
    else:
        near, far = 0.0, 1.0
    span = far - near
    enc_span = span if span > 0 else 1.0
    with np.errstate(invalid="ignore"):
        q = np.clip(np.round((depth - np.float32(near))
                             / np.float32(enc_span) * _QMAX), 0.0,
                    float(_QMAX))
    q = np.where(finite, q, float(_SENTINEL)).astype(np.uint16)
    d16 = ((q[..., 0, :, :] << np.uint16(8)) | q[..., 1, :, :])
    c8 = np.round(np.clip(color, 0.0, 1.0) * 255.0).astype(np.uint32)
    c32 = (c8[..., 0, :, :] | (c8[..., 1, :, :] << np.uint32(8))
           | (c8[..., 2, :, :] << np.uint32(16))
           | (c8[..., 3, :, :] << np.uint32(24)))
    return c32, d16.astype(np.uint16), near, far


def qpack8_dequantize_np(color_enc: np.ndarray, depth_enc: np.ndarray,
                         near: float, far: float
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of `qpack8_quantize_np` -> f32 (color [K, 4, H, W], depth
    [K, 2, H, W])."""
    color_enc = np.asarray(color_enc, np.uint32)
    depth_enc = np.asarray(depth_enc, np.uint16)
    span = max(float(far) - float(near), 0.0)
    qs = (depth_enc >> np.uint16(8)).astype(np.float32)
    qe = (depth_enc & np.uint16(0xFF)).astype(np.float32)
    ds = np.where((depth_enc >> np.uint16(8)) == _SENTINEL, np.inf,
                  np.float32(near) + qs / _QMAX * np.float32(span))
    de = np.where((depth_enc & np.uint16(0xFF)) == _SENTINEL, np.inf,
                  np.float32(near) + qe / _QMAX * np.float32(span))
    depth = np.stack([ds, de], axis=-3).astype(np.float32)
    color = np.stack([(color_enc >> np.uint32(s)) & np.uint32(0xFF)
                      for s in (0, 8, 16, 24)],
                     axis=-3).astype(np.float32) / 255.0
    return color, depth
