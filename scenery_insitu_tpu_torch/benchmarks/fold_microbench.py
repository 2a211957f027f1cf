"""Supersegment-fold schedule microbenchmark: the twin of the reference's
``benchmarks/fold_microbench.py`` on this package.

    python -m scenery_insitu_tpu_torch.benchmarks.fold_microbench \\
        [--grid 256] [--k 16] [--chunk 16] [--iters 5] \\
        [--variants none,count,xla,pallas] [--check] [--device cuda|cpu]

It times the fold alone on the reference's synthetic streams (two
density blobs along depth with a gap between them, colour drifting with
depth), generated chunk by chunk on the device: S = ``--grid`` slices on
an H = W = grid * 5/4 image (rounded up to a multiple of 32), K slots,
C slices a chunk. Variants, each with the counterpart it runs here:

  xla           C sequential ``supersegments.push`` calls a chunk
  seg           ``ops/seg_fold`` (the segmented-scan fold, plain torch)
  pallas_seg    K1's planes form (B1b, ``cuda_seg.fold_chunk_packed``)
  pallas_seg_c  K1's compact form (t = sk * length in the kernel)
  pallas        B7 (``cuda_march.fold_chunk``)
  events        B8: the two-phase machine, a chunk's close events in
                registers, phase 2 over the closed slots only
                (`events_fold_chunk`)
  scratch       B9: the same, the close events in shared memory
                (`scratch_fold_chunk`)
  count         K2 with one candidate threshold (no K-slot writes)
  none          stream generation only (the harness floor)
  fused         B5: shade and fold the raw value chunks in one kernel
  fused_stream  B6: the whole value stream in one launch
  tf_pallas_seg / tf_xla_seg
                the value stream shaded in torch, folded by K1 / seg
                (the baselines of the fused two, and their reference)

The reference's geometry sweeps of its TPU B7 (``pallas_tN``,
``pallas_wN``, ``pallas_gated``) have no counterpart: the CUDA B7 has no
strip height, no VMEM block and no second phase. They raise
`NotImplementedError` (ROADMAP queue B, "B7 geometry sweep").

With ``--check`` every fold variant is held against ``xla`` and the
value-stream family against ``tf_xla_seg`` (rtol 1e-5, atol 1e-5, the
reference's bar) before timing. One JSON line per variant, with the
reference's keys (``variant``, ``ms_per_march``, ``compile_s``,
``grid``, ``hw``, ``k``, ``chunk``, ``platform``: "cuda" or "cpu") plus
``device``, ``marches`` (calls of the march) and ``launches`` (the
kernel launches of those calls). On a card the times are CUDA events
around ``--iters`` marches after one untimed march (``compile_s``, which
includes the kernels' build at first use); on the CPU the host clock. A
variant that fails prints an error row and `main` returns 1. Nothing
runs when the module is imported.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from scenery_insitu_tpu_torch import kernels
from scenery_insitu_tpu_torch.core.transfer import TransferFunction
from scenery_insitu_tpu_torch.device import resolve_device
from scenery_insitu_tpu_torch.ops import cuda_fused as cf
from scenery_insitu_tpu_torch.ops import cuda_march as cm
from scenery_insitu_tpu_torch.ops import cuda_seg as cs
from scenery_insitu_tpu_torch.ops import seg_fold as sf
from scenery_insitu_tpu_torch.ops import supersegments as ss
from scenery_insitu_tpu_torch.ops.sampling import adjust_opacity

VARIANTS = ("xla", "seg", "pallas_seg", "pallas_seg_c", "pallas", "events",
            "scratch", "count", "none", "fused", "fused_stream",
            "tf_pallas_seg", "tf_xla_seg")
# the value-stream family: checked against tf_xla_seg, not xla
VAL_FAMILY = ("fused", "fused_stream", "tf_pallas_seg", "tf_xla_seg")
# the references and the floors, which --check does not hold
UNCHECKED = ("xla", "count", "none", "tf_xla_seg")
CHECK_TOL = dict(rtol=1e-5, atol=1e-5)
THRESHOLD = 0.35

# B8 is built for these (C, K) pairs, B9 for these C (csrc/fold_chunk.cu
# keeps the same lists); C = 1 takes the single-plane chunks a march
# with chunk skipping feeds
EVENT_PAIRS = tuple((c, k) for c in (1, 8, 16, 32) for k in (4, 8, 16))
SCRATCH_CHUNKS = (1, 8, 16, 32)
# the reference's scratch entry a slice (slot, rgba, start, end); the
# kernels hold 6 floats a close, the slot implicit
EVENT_FLOATS = 7
# shared memory a block may opt in to on Hopper (sm_90: 227 KB)
SMEM_OPTIN_BYTES = 232448
MAX_THREADS = 256
# B9's block: more blocks an SM than the largest that fits (a block of 64
# or 256 is slower on an H100)
SCRATCH_BLOCK = 128
# the reference's strip height; the CUDA kernels have none
TILE_H = 8


def image_side(grid: int) -> int:
    """H = W of the reference: grid * 5/4, rounded up to a multiple of 32."""
    return -(-(grid * 5 // 4) // 32) * 32


def stream_chunk(ci: int, c: int, h: int, w: int, device=None):
    """Chunk ``ci`` of the synthetic sample stream: rgba f32[C,4,H,W],
    t0/t1 f32[C,H,W] (the reference's ``stream_chunk``)."""
    f32 = torch.float32
    dev = resolve_device(device)
    s = ci * c + torch.arange(c, dtype=f32, device=dev)             # [C]
    jj = torch.arange(h, dtype=f32, device=dev)[:, None]
    ii = torch.arange(w, dtype=f32, device=dev)[None, :]
    c0 = 60.0 + 0.15 * jj + 0.05 * ii                 # blob centres drift
    c1 = c0 + 90.0
    d0 = torch.abs(s[:, None, None] - c0[None])
    d1 = torch.abs(s[:, None, None] - c1[None])
    alpha = torch.maximum(torch.clamp(0.9 - d0 * 0.03, min=0.0),
                          torch.clamp(0.7 - d1 * 0.025, min=0.0))
    shade = 0.5 + 0.5 * torch.sin(s * 0.21)[:, None, None]
    rgba = torch.stack([alpha * shade, alpha * (1.0 - shade), alpha * 0.3,
                        alpha], dim=1)
    t0 = (s * 0.01)[:, None, None].expand(c, h, w).contiguous()
    return rgba, t0, t0 + 0.01


def stream_val_chunk(ci: int, c: int, h: int, w: int, device=None):
    """Chunk ``ci`` of the raw value stream the fused folds take: val
    f32[C,H,W] (-1 on a two-pixel dead margin) and the per-slice depth
    ratios sk f32[C] (the reference's ``stream_val_chunk``)."""
    f32 = torch.float32
    dev = resolve_device(device)
    s = ci * c + torch.arange(c, dtype=f32, device=dev)
    jj = torch.arange(h, dtype=f32, device=dev)[:, None]
    ii = torch.arange(w, dtype=f32, device=dev)[None, :]
    c0 = 60.0 + 0.15 * jj + 0.05 * ii
    c1 = c0 + 90.0
    d0 = torch.abs(s[:, None, None] - c0[None])
    d1 = torch.abs(s[:, None, None] - c1[None])
    val = torch.maximum(torch.clamp(0.9 - d0 * 0.03, min=0.0),
                        torch.clamp(0.7 - d1 * 0.025, min=0.0))
    val = torch.where(((jj < 2) | (ii < 2))[None], -1.0, val)
    return val, 1.0 + s * 0.01


def fused_tf(device=None) -> TransferFunction:
    """The reference's ``_fused_tf``: a three-point opacity ramp and a
    three-colour map."""
    return TransferFunction.from_polylines(
        [(0.0, 0.0), (0.2, 0.1), (0.8, 0.8)], np.asarray([0.0, 0.5, 1.0]),
        np.asarray([[0.1, 0.2, 0.9], [0.9, 0.4, 0.1], [1.0, 0.9, 0.2]],
                   np.float32), device=device)


def shade(val, sk, tf, length, ratio, ds):
    """The value stream shaded in torch (the reference's ``_shade_xla``):
    rgba f32[C,4,H,W] and the depth planes t0/t1 f32[C,H,W]."""
    x = torch.clamp(val, 0.0, 1.0)
    rgb, a = tf(x)
    a = torch.where(val < -0.5, 0.0, a)
    a = adjust_opacity(a, ratio[None])
    rgba = torch.cat([rgb.movedim(-1, 1) * a[:, None], a[:, None]], dim=1)
    t0 = sk[:, None, None] * length[None]
    t1 = (sk + ds)[:, None, None] * length[None]
    return rgba, t0, t1


# ------------------------------------------- B8 and B9: the deferred folds


def events_init(k: int, height: int, width: int, device=None):
    """``((color, depth), small)``: B7's packed machine state
    (`cuda_march.init_packed`) in the reference's grouping."""
    color, depth, small = cm.init_packed(k, height, width, device)
    return (color, depth), small


def events_finalize(big, small):
    """Close the trailing open segment as ``supersegments.finalize``:
    (color f32[K,4,H,W], depth f32[K,2,H,W])."""
    return ss.finalize(cm.unpack_state((*big, small)))


def scratch_threads(c: int) -> int:
    """B9's threads per block for chunks of ``c`` slices: its scratch is
    28 C bytes a thread of shared memory, so the most (up to 256, a
    multiple of 32) that fit the 227 KB a block may opt in to; raises
    where even one warp does not fit."""
    per_thread = EVENT_FLOATS * 4 * c
    threads = min(MAX_THREADS, SMEM_OPTIN_BYTES // per_thread // 32 * 32)
    if threads < 32:
        raise ValueError(f"chunks of {c} slices need {per_thread} B of "
                         f"scratch a thread; one warp exceeds the "
                         f"{SMEM_OPTIN_BYTES} B of shared memory a block "
                         f"may have")
    return threads


def scratch_block(c: int) -> int:
    """The block B9 runs for chunks of ``c`` slices: at most
    `SCRATCH_BLOCK` threads, and no more than `scratch_threads` allows.
    Its scratch, 24 min(C, K - 1) bytes a thread, is at most the 28 C
    that `scratch_threads` fits in a block."""
    return min(SCRATCH_BLOCK, scratch_threads(c))


def attributes(variant: str, c: int, k: int) -> dict:
    """The launch of B7 (``pallas``), B8 (``events``) or B9 (``scratch``)
    for chunks of ``c`` slices into ``k`` slots, on the current card:
    registers and local-memory bytes a thread, shared bytes a block,
    resident blocks an SM, threads a block and the close events a thread
    holds. Needs a card: it loads the kernel library."""
    which = {"pallas": 0, "events": 1, "scratch": 2}[variant]
    out = kernels.query("fold_chunk_occupancy", which, c, k,
                        scratch_block(c), nout=6)
    keys = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm",
            "threads", "events")
    return dict(zip(keys, out))


def _check_chunk(big, small, rgba, t0, t1, threshold, max_k, tile_h):
    """The operands as the kernels take them; raises on anything else.
    Returns the threshold as a contiguous f32[H, W]."""
    color, _ = big
    k, _, h, w = color.shape
    if max_k != k:
        raise ValueError(f"max_k={max_k} but the state holds {k} slots")
    if tile_h != TILE_H:
        raise ValueError(f"tile_h={tile_h}: the CUDA kernels run one "
                         f"thread a pixel and have no strip height (only "
                         f"the reference's default {TILE_H} is accepted)")
    c = rgba.shape[0]
    threshold = cs.as_plane(threshold, h, w, color.device)
    f32 = torch.float32
    kernels.check_operands({
        **cs.check_packed((*big, small), c, cm.NSMALL),
        "rgba": (rgba, (c, 4, h, w), f32), "t0": (t0, (c, h, w), f32),
        "t1": (t1, (c, h, w), f32),
        "threshold": (threshold, (h, w), f32)}, "color")
    if color.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {color.device}")
    return threshold


def _pointers(big, small, rgba, t0, t1, threshold):
    color, depth = big
    return (rgba.data_ptr(), t0.data_ptr(), t1.data_ptr(),
            threshold.data_ptr(), color.data_ptr(), depth.data_ptr(),
            small.data_ptr())


def events_fold_chunk(big, small, rgba: torch.Tensor, t0: torch.Tensor,
                      t1: torch.Tensor, threshold, *, max_k: int,
                      tile_h: int = TILE_H):
    """B8: fold one chunk ``rgba f32[C,4,H,W]`` (depths ``t0``/``t1
    f32[C,H,W]``, ``threshold`` a scalar or [H, W]) into the machine
    state ``big = (color, depth)``, ``small`` in place; returns ``(big,
    small)``. No count and no gap test. (C, K) must be one of
    `EVENT_PAIRS`; ``tile_h`` has no counterpart and only its default is
    taken."""
    threshold = _check_chunk(big, small, rgba, t0, t1, threshold, max_k,
                             tile_h)
    c = rgba.shape[0]
    if (c, max_k) not in EVENT_PAIRS:
        raise ValueError(f"events_fold_chunk is built for (C, K) in "
                         f"{EVENT_PAIRS}, got {(c, max_k)}")
    if small.device.type == "cpu":
        return events_fold_chunk_plain(big, small, rgba, t0, t1, threshold,
                                       max_k=max_k)
    _, _, h, w = big[0].shape
    kernels.launch("events_fold_chunk",
                   *_pointers(big, small, rgba, t0, t1, threshold), c,
                   max_k, h, w, nbytes=kernels.operand_bytes(
                       (rgba, t0, t1, threshold, *big, small),
                       (*big, small)))
    return big, small


def scratch_fold_chunk(big, small, rgba: torch.Tensor, t0: torch.Tensor,
                       t1: torch.Tensor, threshold, *, max_k: int,
                       tile_h: int = TILE_H):
    """B9: as `events_fold_chunk`, with the close events kept in shared
    memory. C must be one of `SCRATCH_CHUNKS`; any K."""
    threshold = _check_chunk(big, small, rgba, t0, t1, threshold, max_k,
                             tile_h)
    c = rgba.shape[0]
    if c not in SCRATCH_CHUNKS:
        raise ValueError(f"scratch_fold_chunk is built for C in "
                         f"{SCRATCH_CHUNKS}, got {c}")
    threads = scratch_block(c)
    if small.device.type == "cpu":
        return scratch_fold_chunk_plain(big, small, rgba, t0, t1, threshold,
                                        max_k=max_k)
    _, _, h, w = big[0].shape
    kernels.launch("scratch_fold_chunk",
                   *_pointers(big, small, rgba, t0, t1, threshold), c,
                   max_k, h, w, threads, nbytes=kernels.operand_bytes(
                       (rgba, t0, t1, threshold, *big, small),
                       (*big, small)))
    return big, small


def _record_events(small, rgba, t0, t1, threshold, max_k):
    """Phase 1 of the reference's two-phase fold: the machine over the C
    slices, ``small`` updated in place. Returns each slice's close event
    (slot = k at the close else -1, the closing segment's rgba, start
    and end, else 0)."""
    seg_rgba = small[0:4]
    seg_start, seg_end = small[4], small[5]
    prev_rgb = small[6:9]
    open_ = small[9] > 0.5
    prev_empty = small[10] > 0.5
    kcnt = small[11]
    events = []
    for i in range(rgba.shape[0]):
        x = rgba[i]
        is_empty = x[3] < ss.EMPTY_ALPHA
        diff = ss.rgb_distance(x[:3] - prev_rgb, 0)
        want_break = ((~is_empty & ~prev_empty & (diff > threshold))
                      | (is_empty & ~prev_empty))
        do_close = open_ & want_break & (kcnt < max_k - 1)
        events.append((torch.where(do_close, kcnt, -1.0),
                       torch.where(do_close[None], seg_rgba, 0.0),
                       torch.where(do_close, seg_start, 0.0),
                       torch.where(do_close, seg_end, 0.0)))
        kcnt = torch.where(do_close, kcnt + 1.0, kcnt)
        open_ = open_ & ~do_close
        start_new = ~is_empty & ~open_
        accumulate = ~is_empty & open_
        seg_rgba = torch.where(
            start_new[None], x,
            torch.where(accumulate[None],
                        seg_rgba + (1.0 - seg_rgba[3:4]) * x, seg_rgba))
        seg_start = torch.where(start_new, t0[i], seg_start)
        seg_end = torch.where(start_new | accumulate, t1[i], seg_end)
        open_ = open_ | start_new
        prev_rgb = torch.where(is_empty[None], prev_rgb, x[:3])
        prev_empty = is_empty
    f32 = torch.float32
    small.copy_(torch.cat([seg_rgba, seg_start[None], seg_end[None],
                           prev_rgb, open_.to(f32)[None],
                           prev_empty.to(f32)[None], kcnt[None]]))
    return events


def events_fold_chunk_plain(big, small, rgba, t0, t1, threshold, *,
                            max_k: int):
    """Plain version of B8 (the reference's ``_events_kernel``): record
    the events, then fold them slot by slot, event by event. A slot
    closes at most once over a march, so the colour sum is a select and
    the depths take where(hit). In place; any device."""
    color, depth = big
    events = _record_events(small, rgba, t0, t1, threshold, max_k)
    for kk in range(max_k):
        hit = acc_c = acc_s = acc_e = None
        for slot, c_rgba, c_s, c_e in events:
            m = slot == kk
            mf = m.to(torch.float32)
            hit = m if hit is None else hit | m
            acc_c = c_rgba * mf[None] if acc_c is None \
                else acc_c + c_rgba * mf[None]
            acc_s = c_s * mf if acc_s is None else acc_s + c_s * mf
            acc_e = c_e * mf if acc_e is None else acc_e + c_e * mf
        color[kk] = color[kk] + acc_c
        depth[kk, 0] = torch.where(hit, acc_s, depth[kk, 0])
        depth[kk, 1] = torch.where(hit, acc_e, depth[kk, 1])
    return big, small


def scratch_fold_chunk_plain(big, small, rgba, t0, t1, threshold, *,
                             max_k: int):
    """Plain version of B9 (the reference's ``_scratch_kernel``): the
    events written to a scratch f32[C,7,H,W], then a loop over the slots
    that reads them back and reduces over C. In place; any device."""
    color, depth = big
    scratch = torch.stack([
        torch.cat([slot[None], c_rgba, c_s[None], c_e[None]])
        for slot, c_rgba, c_s, c_e in _record_events(small, rgba, t0, t1,
                                                     threshold, max_k)])
    for kk in range(max_k):
        m = scratch[:, 0] == kk
        mf = m.to(torch.float32)
        hit = torch.any(m, dim=0)
        color[kk] = color[kk] + torch.sum(scratch[:, 1:5] * mf[:, None],
                                          dim=0)
        acc_s = torch.sum(scratch[:, 5] * mf, dim=0)
        acc_e = torch.sum(scratch[:, 6] * mf, dim=0)
        depth[kk] = torch.stack([torch.where(hit, acc_s, depth[kk, 0]),
                                 torch.where(hit, acc_e, depth[kk, 1])])
    return big, small


# ------------------------------------------------------------- variants


def _pallas_sweep(variant: str) -> None:
    """Raise for the reference's B7 geometry sweeps: NotImplementedError
    for a well-formed name, ValueError for a malformed one."""
    suffix = variant[len("pallas"):]
    if (suffix[:2] in ("_t", "_w") and suffix[2:].isdigit()) or \
            suffix == "_gated":
        raise NotImplementedError(
            f"{variant}: the reference's geometry sweep of its TPU B7 "
            f"(strip height, VMEM block width, gated phase 2) has no "
            f"counterpart in the CUDA B7, which runs one thread a pixel "
            f"(ROADMAP queue B, 'B7 geometry sweep')")
    raise ValueError(f"unknown pallas variant {variant!r} (expected pallas,"
                     f" pallas_gated, pallas_tN or pallas_wN)")


def build(variant: str, s_total: int, c: int, k: int, h: int, w: int,
          device=None) -> Callable[[], object]:
    """``run()`` of one fold variant over the S-slice stream (see the
    module docstring): returns (color, depth) for a fold, the count for
    ``count``, the summed stream for ``none``."""
    dev = resolve_device(device)
    nchunks = s_total // c
    thr = torch.full((h, w), THRESHOLD, device=dev)
    chunks = lambda: (stream_chunk(ci, c, h, w, dev) for ci in range(nchunks))

    if variant == "xla":
        def run():
            st = ss.init_state(k, h, w, dev)
            for rgba, t0, t1 in chunks():
                for i in range(c):
                    st = ss.push(st, k, thr, rgba[i], t0[i], t1[i])
            return ss.finalize(st)
    elif variant == "seg":
        def run():
            st = sf.init_seg_state(k, h, w, dev)
            for rgba, t0, t1 in chunks():
                st = sf.seg_fold_chunk(st, rgba, t0, t1, thr, max_k=k)
            return sf.seg_finalize(st)
    elif variant in ("pallas_seg", "pallas_seg_c"):
        compact = variant == "pallas_seg_c"
        length = torch.ones((h, w), device=dev)

        def run():
            packed = cs.init_seg_packed(k, h, w, dev)
            for ci, (rgba, t0, t1) in enumerate(chunks()):
                if compact:
                    # t0 = s * 0.01 with length 1 is exactly this product
                    sk0 = (ci * c + torch.arange(c, dtype=torch.float32,
                                                 device=dev)) * 0.01
                    cs.fold_chunk_packed(packed, rgba, thr, max_k=k,
                                         sk0=sk0, sk1=sk0 + 0.01,
                                         length=length)
                else:
                    cs.fold_chunk_packed(packed, rgba, thr, max_k=k, t0=t0,
                                         t1=t1)
            return sf.seg_finalize(cs.unpack_seg_state(packed))
    elif variant in VAL_FAMILY:
        run = _build_val(variant, s_total, c, k, h, w, dev, thr)
    elif variant == "pallas":
        def run():
            packed = cm.init_packed(k, h, w, dev)
            for rgba, t0, t1 in chunks():
                cm.fold_chunk(packed, rgba, t0, t1, thr, max_k=k)
            return ss.finalize(cm.unpack_state(packed))
    elif variant.startswith("pallas"):
        _pallas_sweep(variant)
    elif variant in ("events", "scratch"):
        fold = events_fold_chunk if variant == "events" \
            else scratch_fold_chunk

        def run():
            big, small = events_init(k, h, w, dev)
            for rgba, t0, t1 in chunks():
                fold(big, small, rgba, t0, t1, thr, max_k=k)
            return events_finalize(big, small)
    elif variant == "count":
        tvec = torch.tensor([THRESHOLD], device=dev)

        def run():
            carry = cm.init_count_multi_packed(1, h, w, dev)
            for rgba, _, _ in chunks():
                cm.count_multi_chunk(carry, rgba, tvec)
            return carry[0]
    elif variant == "none":
        def run():
            acc = torch.zeros((4, h, w), device=dev)
            for rgba, t0, t1 in chunks():
                acc = acc + rgba.sum(0) + (t0.sum(0) + t1.sum(0))[None]
            return acc
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return run


def _build_val(variant, s_total, c, k, h, w, dev, thr):
    """The value-stream family: the same raw chunks shaded in the kernel
    (``fused``, ``fused_stream``) or in torch (``tf_*``)."""
    tf = fused_tf(dev)
    knots = cf.tf_knots(tf)
    length = torch.ones((h, w), device=dev)
    ratio = torch.ones((h, w), device=dev)
    ds = 0.01
    vals = lambda: (stream_val_chunk(ci, c, h, w, dev)
                    for ci in range(s_total // c))

    if variant == "fused":
        def run():
            packed = cs.init_seg_packed(k, h, w, dev)
            for val, sk in vals():
                cf.fused_fold_chunk(packed, val, length, ratio, sk, sk + ds,
                                    thr, max_k=k, tf=tf, knots=knots)
            return sf.seg_finalize(cs.unpack_seg_state(packed))
    elif variant == "fused_stream":
        def run():
            # the whole stream in one buffer (the march's resampling would
            # write it), then one launch over the march
            buf = torch.zeros((s_total, h, w), device=dev)
            skb = torch.zeros((s_total,), device=dev)
            for ci, (val, sk) in enumerate(vals()):
                buf[ci * c:(ci + 1) * c] = val
                skb[ci * c:(ci + 1) * c] = sk
            packed = cf.fused_stream_fold(
                cs.init_seg_packed(k, h, w, dev), buf, length, ratio, skb,
                skb + ds, thr, max_k=k, chunk=c, tf=tf, knots=knots)
            return sf.seg_finalize(cs.unpack_seg_state(packed))
    elif variant == "tf_pallas_seg":
        def run():
            packed = cs.init_seg_packed(k, h, w, dev)
            for val, sk in vals():
                rgba, t0, t1 = shade(val, sk, tf, length, ratio, ds)
                cs.fold_chunk_packed(packed, rgba, thr, max_k=k, t0=t0,
                                     t1=t1)
            return sf.seg_finalize(cs.unpack_seg_state(packed))
    else:
        def run():
            st = sf.init_seg_state(k, h, w, dev)
            for val, sk in vals():
                rgba, t0, t1 = shade(val, sk, tf, length, ratio, ds)
                st = sf.seg_fold_chunk(st, rgba, t0, t1, thr, max_k=k)
            return sf.seg_finalize(st)
    return run


# ---------------------------------------------------------------- sweep


class _Counted:
    """A variant's ``run`` that counts its calls and the kernel launches
    they make."""

    def __init__(self, run):
        self.run, self.marches, self.launches = run, 0, {}

    def __call__(self):
        before = kernels.launches()
        out = self.run()
        self.marches += 1
        for name, n in kernels.launches().items():
            if n > before[name]:
                self.launches[name] = (self.launches.get(name, 0) + n
                                       - before[name])
        return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _time(run, iters: int, dev: torch.device):
    """(compile_s, ms per march): one untimed march, then ``iters``."""
    cuda = dev.type == "cuda"
    t = time.perf_counter()
    run()
    if cuda:
        torch.cuda.synchronize(dev)
    compile_s = time.perf_counter() - t
    if cuda:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            run()
        b.record()
        b.synchronize()
        return compile_s, a.elapsed_time(b) / iters
    t = time.perf_counter()
    for _ in range(iters):
        run()
    return compile_s, (time.perf_counter() - t) / iters * 1e3


def print_row(row: dict) -> None:
    print(json.dumps(row), flush=True)


def sweep(variants: Sequence[str], s_total: int, c: int, k: int, *,
          iters: int, check: bool, device=None, keep_going: bool = False,
          emit: Callable[[dict], None] = print_row) -> List[dict]:
    """Check (with ``check``) and time each variant; every row goes to
    ``emit`` and is returned. A failure raises, or with ``keep_going``
    gives an error row ``{"variant", "error"}`` and drops the variant."""
    dev = resolve_device(device)
    h = w = image_side(s_total)
    on_card = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    print(f"[fold_microbench] {dev.type} {name} S={s_total} HxW={h}x{w} "
          f"K={k} C={c}", file=sys.stderr, flush=True)
    rows, runs = [], {}

    def fail(v, what, e):
        if not keep_going:
            raise e
        rows.append({"variant": v,
                     "error": f"{what}{type(e).__name__}: {e}"[:300]})
        emit(rows[-1])

    def get(v):
        if v not in runs:
            runs[v] = _Counted(build(v, s_total, c, k, h, w, dev))
        return runs[v]

    timed = list(variants)
    if check:
        refs = {}
        for v in [x for x in timed if x not in UNCHECKED]:
            base = "tf_xla_seg" if v in VAL_FAMILY else "xla"
            try:
                if base not in refs:
                    refs[base] = get(base)()
                got = get(v)()
                for a, b, part in zip(refs[base], got, ("color", "depth")):
                    np.testing.assert_allclose(_np(a), _np(b),
                                               err_msg=f"{v} {part}",
                                               **CHECK_TOL)
            except Exception as e:            # noqa: BLE001 - see fail()
                fail(v, "check: ", e)
                timed.remove(v)
        print(f"[fold_microbench] parity check: failed="
              f"{[r['variant'] for r in rows]}", file=sys.stderr, flush=True)
    for v in timed:
        try:
            run = get(v)
            compile_s, ms = _time(run, iters, dev)
        except Exception as e:                # noqa: BLE001 - see fail()
            fail(v, "", e)
            continue
        rows.append({
            "variant": v, "ms_per_march": round(ms, 4),
            "compile_s": round(compile_s, 2), "grid": s_total,
            "hw": [h, w], "k": k, "chunk": c, "platform": dev.type,
            "device": name, "marches": run.marches,
            "launches": dict(run.launches)})
        emit(rows[-1])
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=256,
                    help="slices S; H = W = grid * 5/4 (the 512 -> 640 "
                         "ratio), rounded up to a multiple of 32")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--variants", default="none,count,xla,pallas")
    ap.add_argument("--check", action="store_true",
                    help="hold every fold variant against the xla fold "
                         "(the value-stream family against tf_xla_seg) "
                         "before timing")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    rows = sweep([v.strip() for v in args.variants.split(",")], args.grid,
                 args.chunk, args.k, iters=args.iters, check=args.check,
                 device=args.device, keep_going=True)
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
