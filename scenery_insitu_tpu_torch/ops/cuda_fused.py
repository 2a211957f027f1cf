"""Kernels B5 and B6: shade and fold in one kernel (``csrc/fused_fold.cu``).

The fused fold schedules of the slice march (``fold="pallas_fused"`` and
``"fused_stream"``) feed the resampled VALUE planes, ``val f32[C,H,W]``
with ``-1`` where a sample is dead (outside the volume or the rank's
bounds, or a dropped slice), instead of the shaded rgba stream. The
kernel applies the transfer function in its knot form, the opacity
correction ``1 - (1 - a)^ratio`` for the per-ray slice spacing and the
premultiply, then kernel K1's segmented write fold (``ops/cuda_seg.py``)
with ``t = sk * length``. The fold state is K1's packed triple
(`cuda_seg.init_seg_packed`), updated IN PLACE.

- `fused_fold_chunk` (B5): one chunk of C slices a launch.
- `fused_stream_fold` (B6): the whole march ``val f32[S,H,W]`` in one
  launch, S a multiple of ``chunk``. It keeps the chunk boundaries, so
  it equals `fused_fold_chunk` called chunk after chunk.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs its plain version, `fused_fold_chunk_plain` or
`fused_stream_fold_plain`. The transfer function reaches the kernel as
the f32[100] buffer of `tf_knots`, so one build serves every transfer
function.
"""

from __future__ import annotations

import torch

from scenery_insitu_tpu_torch import kernels
from scenery_insitu_tpu_torch.core.transfer import MAX_KNOTS
from scenery_insitu_tpu_torch.ops import cuda_seg as cs
from scenery_insitu_tpu_torch.ops.sampling import adjust_opacity

# alpha x, alpha slope, alpha base, colour x, colour slope [16, 3],
# colour base [3]: the layout csrc/fused_fold.cu reads
NKNOTS = 6 * MAX_KNOTS + 4


def tf_knots(tf) -> torch.Tensor:
    """The transfer function's knots as one contiguous f32[100] buffer."""
    parts = (tf.alpha_x, tf.alpha_m, tf.alpha_b.reshape(1), tf.color_x,
             tf.color_m.reshape(-1), tf.color_b)
    knots = torch.cat([p.to(torch.float32).reshape(-1) for p in parts])
    if knots.numel() != NKNOTS:
        raise ValueError(f"the fused folds take transfer functions of "
                         f"{MAX_KNOTS} knots ({NKNOTS} floats), got "
                         f"{knots.numel()} floats")
    return knots


def attributes(c: int) -> dict:
    """The build of B5 and B6 that chunks of ``c`` slices take, on the
    current card: registers and local-memory bytes a thread, shared bytes
    a block, resident blocks an SM, threads a block and the slices a
    stage holds (the smaller of ``c`` and 16). Needs a card: it loads
    the kernel library."""
    if c < 1:
        raise ValueError("a chunk holds at least one slice")
    out = kernels.query("fused_fold_attributes", c, nout=6)
    keys = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm",
            "threads", "slices")
    return dict(zip(keys, out))


def shade_plain(val: torch.Tensor, ratio: torch.Tensor,
                tf) -> torch.Tensor:
    """The fused kernels' shading of ``val f32[C,H,W]`` (plain): x =
    clamp(v, 0, 1); alpha and each colour channel as base + sum_i m_i *
    max(x - x_i, 0) in knot order; alpha 0 where v < -0.5; the opacity
    correction for ``ratio``; rgb premultiplied. Returns rgba
    f32[C,4,H,W]. A zero-slope knot adds +0, which is what skipping it
    gives."""
    x = torch.clamp(val, 0.0, 1.0)
    a = tf.alpha_b.expand_as(x)
    for i in range(tf.alpha_x.shape[0]):
        a = a + tf.alpha_m[i] * torch.clamp(x - tf.alpha_x[i], min=0.0)
    rgb = tf.color_b[:, None, None, None].expand((3,) + tuple(x.shape))
    for i in range(tf.color_x.shape[0]):
        r = torch.clamp(x - tf.color_x[i], min=0.0)
        rgb = rgb + tf.color_m[i][:, None, None, None] * r[None]
    a = torch.where(val < -0.5, 0.0, a)
    a = adjust_opacity(a, ratio)
    return torch.cat([(rgb * a[None]).movedim(0, 1), a[:, None]], dim=1)


def _operands(packed, val, length, ratio, threshold, sk0, sk1, s_total):
    """Planes as contiguous f32[H, W] and the operand table."""
    color = packed[0]
    _, _, h, w = color.shape
    dev = color.device
    length, ratio, threshold = (cs.as_plane(x, h, w, dev)
                                for x in (length, ratio, threshold))
    f32 = torch.float32
    want = {**cs.check_packed(packed, s_total),
            "val": (val, (s_total, h, w), f32),
            "length": (length, (h, w), f32), "ratio": (ratio, (h, w), f32),
            "threshold": (threshold, (h, w), f32),
            "sk0": (sk0, (s_total,), f32), "sk1": (sk1, (s_total,), f32)}
    kernels.check_operands(want, "color")
    return length, ratio, threshold


def _launch(entry, packed, val, length, ratio, threshold, sk0, sk1, tf,
            knots, *sizes):
    color, depth, small = packed
    if color.device.type != "cuda":
        raise ValueError(f"unsupported device {color.device}")
    if knots is None:
        knots = tf_knots(tf)
    kernels.check_operands({"color": (color, color.shape, torch.float32),
                            "knots": (knots, (NKNOTS,), torch.float32)},
                           "color")
    _, _, h, w = color.shape
    kernels.launch(entry, val.data_ptr(), length.data_ptr(),
                   ratio.data_ptr(), threshold.data_ptr(), sk0.data_ptr(),
                   sk1.data_ptr(), knots.data_ptr(), color.data_ptr(),
                   depth.data_ptr(), small.data_ptr(), *sizes,
                   color.shape[0], h, w)
    return packed


def _check_k(packed, max_k):
    if max_k != packed[0].shape[0]:
        raise ValueError(f"max_k={max_k} but the state holds "
                         f"{packed[0].shape[0]} slots")


def fused_fold_chunk(packed, val: torch.Tensor, length, ratio,
                     sk0: torch.Tensor, sk1: torch.Tensor, threshold, *,
                     max_k: int, tf, knots=None):
    """Shade and fold one chunk ``val f32[C,H,W]`` into ``packed`` in
    place and return it. ``length``, ``ratio`` and ``threshold`` are
    scalars or [H, W]; ``sk0``/``sk1 f32[C]`` the per-slice depth
    ratios; ``tf`` a `TransferFunction` on the state's device;
    ``knots`` its `tf_knots`, built once by a caller that folds many
    chunks with one transfer function (else built at each launch)."""
    _check_k(packed, max_k)
    c = val.shape[0]
    length, ratio, threshold = _operands(packed, val, length, ratio,
                                         threshold, sk0, sk1, c)
    if packed[0].device.type == "cpu":
        return fused_fold_chunk_plain(packed, val, length, ratio, sk0, sk1,
                                      threshold, max_k=max_k, tf=tf)
    return _launch("fused_fold_chunk", packed, val, length, ratio,
                   threshold, sk0, sk1, tf, knots, c)


def fused_fold_chunk_plain(packed, val: torch.Tensor, length, ratio,
                           sk0: torch.Tensor, sk1: torch.Tensor, threshold,
                           *, max_k: int, tf):
    """Plain version of B5: `shade_plain`, then K1's plain version
    (``seg_fold.seg_fold_chunk`` on ``t = sk * length``), in place. Any
    device."""
    rgba = shade_plain(val, ratio, tf)
    return cs.fold_chunk_packed_plain(packed, rgba, threshold, max_k=max_k,
                                      sk0=sk0, sk1=sk1, length=length)


def fused_stream_fold(packed, val: torch.Tensor, length, ratio,
                      sk0: torch.Tensor, sk1: torch.Tensor, threshold, *,
                      max_k: int, chunk: int, tf, knots=None):
    """Shade and fold a whole march ``val f32[S,H,W]`` (``sk0``/``sk1
    f32[S]``, S a multiple of ``chunk``) into ``packed`` in place, the
    running transmittance restarting at every chunk as in
    `fused_fold_chunk`; returns ``packed``. ``knots`` as there."""
    _check_k(packed, max_k)
    s_total = val.shape[0]
    if chunk < 1 or s_total % chunk:
        raise ValueError(f"stream length {s_total} not a multiple of "
                         f"chunk {chunk}")
    length, ratio, threshold = _operands(packed, val, length, ratio,
                                         threshold, sk0, sk1, s_total)
    if packed[0].device.type == "cpu":
        return fused_stream_fold_plain(packed, val, length, ratio, sk0, sk1,
                                       threshold, max_k=max_k, chunk=chunk,
                                       tf=tf)
    return _launch("fused_stream_fold", packed, val, length, ratio,
                   threshold, sk0, sk1, tf, knots, s_total, chunk)


def fused_stream_fold_plain(packed, val: torch.Tensor, length, ratio,
                            sk0: torch.Tensor, sk1: torch.Tensor, threshold,
                            *, max_k: int, chunk: int, tf):
    """Plain version of B6: `fused_fold_chunk_plain` chunk after chunk.
    Any device."""
    for lo in range(0, val.shape[0], chunk):
        hi = lo + chunk
        fused_fold_chunk_plain(packed, val[lo:hi], length, ratio,
                               sk0[lo:hi], sk1[lo:hi], threshold,
                               max_k=max_k, tf=tf)
    return packed
