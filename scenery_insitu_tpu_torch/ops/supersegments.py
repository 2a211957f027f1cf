"""The supersegment state machine — the semantics every fold of the port
is held to.

A depth-ordered stream of items is folded front to back into at most K
output supersegments per pixel. An open segment accumulates items by
alpha-under composition; it closes when the premultiplied-RGB distance
between the incoming item and the previous item exceeds a threshold, or
when the stream turns from non-empty to empty. The break metric compares
consecutive items, so the segment count is a monotone function of the
threshold that an O(1)-state counting pass evaluates. Overflow merges into
the last slot.

All functions are ``[H, W]``-batched and pure (they return new states).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch.device import resolve_device

EMPTY_ALPHA = 1e-4


def rgb_distance(d: torch.Tensor, dim: int) -> torch.Tensor:
    """Euclidean norm of the 3-vector along ``dim``, written out as
    ``sqrt(d0*d0 + d1*d1 + d2*d2)`` — the same operation order the CUDA
    kernels use, so a start flag never flips between a kernel and its
    plain version."""
    d0, d1, d2 = d.unbind(dim)
    return torch.sqrt(d0 * d0 + d1 * d1 + d2 * d2)


class SegState(NamedTuple):
    """Per-pixel fold state; every field is [H, W]-shaped (or [K.., H, W])."""

    out_color: torch.Tensor    # [K, 4, H, W]
    out_start: torch.Tensor    # [K, H, W]
    out_end: torch.Tensor      # [K, H, W]
    k: torch.Tensor            # i32[H, W] next free slot
    open_: torch.Tensor        # bool[H, W] a segment is accumulating
    seg_rgba: torch.Tensor     # [4, H, W] open segment premultiplied RGBA
    seg_start: torch.Tensor    # [H, W]
    seg_end: torch.Tensor      # [H, W]
    prev_rgb: torch.Tensor     # [3, H, W] previous item premultiplied RGB
    prev_empty: torch.Tensor   # bool[H, W]


def init_state(k: int, height: int, width: int, device=None) -> SegState:
    dev = resolve_device(device)
    f = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    return SegState(
        out_color=f(k, 4, height, width),
        out_start=torch.full((k, height, width), torch.inf, device=dev),
        out_end=torch.full((k, height, width), torch.inf, device=dev),
        k=torch.zeros((height, width), dtype=torch.int32, device=dev),
        open_=torch.zeros((height, width), dtype=torch.bool, device=dev),
        seg_rgba=f(4, height, width),
        seg_start=f(height, width),
        seg_end=f(height, width),
        prev_rgb=f(3, height, width),
        prev_empty=torch.ones((height, width), dtype=torch.bool, device=dev),
    )


def push(state: SegState, max_k: int, threshold, rgba: torch.Tensor,
         t0: torch.Tensor, t1: torch.Tensor,
         gap_eps: float = -1.0) -> SegState:
    """Feed one depth-ordered item per pixel into the machine.

    rgba: [4, H, W] premultiplied; t0/t1: [H, W] item depth extent.
    threshold: scalar or [H, W]. ``gap_eps >= 0`` also breaks on a depth
    gap between the open segment's end and the incoming item (used when
    merging already-built supersegments)."""
    is_empty = rgba[3] < EMPTY_ALPHA
    diff = rgb_distance(rgba[:3] - state.prev_rgb, 0)
    want_break = (~is_empty & ~state.prev_empty & (diff > threshold)) | \
                 (is_empty & ~state.prev_empty)
    if gap_eps >= 0.0:
        want_break |= ~is_empty & state.open_ & (t0 > state.seg_end + gap_eps)
    # merge-overflow: the last slot never closes mid-stream
    do_close = state.open_ & want_break & (state.k < max_k - 1)

    out_color, out_start, out_end, k = _write(
        state, do_close, state.out_color, state.out_start, state.out_end)
    open_ = state.open_ & ~do_close

    start_new = ~is_empty & ~open_
    accumulate = ~is_empty & open_

    seg_rgba = torch.where(start_new[None], rgba, state.seg_rgba)
    seg_rgba = torch.where(accumulate[None],
                           state.seg_rgba + (1.0 - state.seg_rgba[3:4]) * rgba,
                           seg_rgba)
    seg_start = torch.where(start_new, t0, state.seg_start)
    seg_end = torch.where(start_new | accumulate, t1, state.seg_end)
    open_ = open_ | start_new

    return SegState(out_color, out_start, out_end, k, open_,
                    seg_rgba, seg_start, seg_end,
                    torch.where(is_empty[None], state.prev_rgb, rgba[:3]),
                    is_empty)


def finalize(state: SegState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Close any open segment; returns (color [K,4,H,W], depth [K,2,H,W])."""
    out_color, out_start, out_end, _ = _write(
        state, state.open_, state.out_color, state.out_start, state.out_end)
    return out_color, torch.stack([out_start, out_end], dim=1)


def _write(state: SegState, do_write: torch.Tensor, out_color, out_start,
           out_end):
    kmax = out_color.shape[0]
    slot = torch.clamp(state.k, max=kmax - 1)
    slot_ids = torch.arange(kmax, dtype=torch.int32,
                            device=slot.device).reshape(kmax, 1, 1)
    onehot = (slot_ids == slot[None]) & do_write[None]      # [K, H, W]
    out_color = torch.where(onehot[:, None], state.seg_rgba[None], out_color)
    out_start = torch.where(onehot, state.seg_start[None], out_start)
    out_end = torch.where(onehot, state.seg_end[None], out_end)
    k = torch.where(do_write, state.k + 1, state.k)
    return out_color, out_start, out_end, k


# ---------------------------------------------------------------- counting

class CountState(NamedTuple):
    count: torch.Tensor       # i32[H, W] (or [B, H, W]) segments started
    prev_rgb: torch.Tensor    # [3, H, W]
    prev_empty: torch.Tensor  # bool[H, W]
    prev_end: torch.Tensor    # [H, W] end depth of previous live item


def init_count(height: int, width: int, device=None) -> CountState:
    return init_count_multi(None, height, width, device)


def init_count_multi(bins, height: int, width: int,
                     device=None) -> CountState:
    """CountState whose count is [B, H, W] (``bins=None``: [H, W]). Feed it
    through the ordinary `push_count` with ``threshold=tvec[:, None,
    None]`` to evaluate every candidate threshold in one march."""
    dev = resolve_device(device)
    shape = (height, width) if bins is None else (bins, height, width)
    return CountState(
        torch.zeros(shape, dtype=torch.int32, device=dev),
        torch.zeros((3, height, width), dtype=torch.float32, device=dev),
        torch.ones((height, width), dtype=torch.bool, device=dev),
        torch.full((height, width), -torch.inf, device=dev))


def _start_mask(prev_rgb, prev_empty, prev_end, rgba, thr, t0,
                gap_eps: float):
    """Segment-START predicate shared by every counting variant. ``thr``
    broadcasts against [H, W] (per-pixel, scalar, or candidates [B,1,1]).
    Returns (starts, is_empty)."""
    is_empty = rgba[3] < EMPTY_ALPHA
    diff = rgb_distance(rgba[:3] - prev_rgb, 0)
    starts = ~is_empty & (prev_empty | (diff > thr))
    if gap_eps >= 0.0 and t0 is not None:
        starts = starts | (~is_empty & ~prev_empty
                           & (t0 > prev_end + gap_eps))
    return starts, is_empty


def push_count(state: CountState, threshold, rgba: torch.Tensor,
               t0: torch.Tensor = None, t1: torch.Tensor = None,
               gap_eps: float = -1.0) -> CountState:
    """O(1)-state counterpart of `push`: counts segment starts."""
    starts, is_empty = _start_mask(state.prev_rgb, state.prev_empty,
                                   state.prev_end, rgba, threshold, t0,
                                   gap_eps)
    prev_end = state.prev_end if t1 is None else \
        torch.where(is_empty, state.prev_end, t1)
    return CountState(state.count + starts.to(torch.int32),
                      torch.where(is_empty[None], state.prev_rgb, rgba[:3]),
                      is_empty, prev_end)


def adaptive_threshold(count_fn: Callable[[torch.Tensor], torch.Tensor],
                       max_k: int, iters: int, height: int, width: int,
                       thr_max: float = 2.0, device=None) -> torch.Tensor:
    """Per-pixel binary search for the smallest threshold whose segment
    count is <= max_k. ``count_fn(thr [H,W]) -> i32[H,W]``."""
    dev = resolve_device(device)
    lo = torch.zeros((height, width), dtype=torch.float32, device=dev)
    hi = torch.full((height, width), thr_max, dtype=torch.float32,
                    device=dev)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_many = count_fn(mid) > max_k
        lo, hi = torch.where(too_many, mid, lo), torch.where(too_many, hi, mid)
    return hi


def threshold_candidates(bins: int, thr_max: float = 2.0,
                         octaves: float = 8.0, device=None) -> torch.Tensor:
    """f32[B] ascending candidate thresholds: 0 followed by log spacing over
    ``octaves`` doublings up to thr_max."""
    t = np.geomspace(thr_max / 2.0 ** octaves, thr_max, bins - 1)
    return torch.as_tensor(np.concatenate([[0.0], t]).astype(np.float32),
                           device=resolve_device(device))


class ThresholdState(NamedTuple):
    """Carried state of the temporal threshold controller: the active
    per-pixel threshold and the bisection bracket [lo, hi]. All [H, W]."""

    thr: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


def init_threshold_state(thr: torch.Tensor, thr_min: float = 1e-3,
                         thr_max: float = 2.0) -> ThresholdState:
    thr = torch.clamp(thr, thr_min, thr_max)
    return ThresholdState(thr, torch.full_like(thr, thr_min),
                          torch.full_like(thr, thr_max))


def update_threshold(state: ThresholdState, count: torch.Tensor, max_k,
                     delta: float = 0.15, thr_min: float = 1e-3,
                     thr_max: float = 2.0, track: float = 0.9
                     ) -> ThresholdState:
    """One bisection step per frame toward the target band
    ``[K*(1-delta), K]`` from the TRUE (uncapped) per-pixel segment count
    observed while writing with ``state.thr``: over the cap the threshold
    becomes the lower bound and bisects up; under the band it becomes the
    upper bound and bisects down (only when the bracket allows a >= 25%
    step); in band it holds. The bracket then decays outward by
    ``track``.

    ``max_k`` is an int K or an f32 0-dim tensor: the per-rank target of
    the occupancy K budget (``ops/occupancy.k_budget_target``), compared
    with the counts as f32 and never rounded to an int."""
    over = count > max_k
    under = count < _band_edge(max_k, delta)
    thr, lo, hi = state

    lo = torch.where(over, thr, lo)
    hi = torch.where(~over, torch.minimum(hi, thr), hi)
    up = 0.5 * (thr + torch.where(hi > thr, hi, 2.0 * thr))
    dn = 0.5 * (thr + torch.where(lo < thr, lo, 0.5 * thr))
    new = torch.where(over, up,
                      torch.where(under & (dn <= 0.75 * thr), dn, thr))
    new = torch.clamp(new, thr_min, thr_max)
    lo = torch.clamp(lo * track, min=thr_min)
    hi = torch.clamp(hi / track, max=thr_max)
    return ThresholdState(new, lo, hi)


def _band_edge(max_k, delta: float):
    """The lower band edge ``floor(max_k * (1 - delta))``: for an int K
    the f64 product rounded to f32, then floored (a host float); for an
    f32 tensor target the f32 product floored on its device."""
    if isinstance(max_k, torch.Tensor):
        return torch.floor(max_k * (1.0 - delta))
    return float(np.floor(np.float32(max_k * (1.0 - delta))))


def pick_threshold(counts: torch.Tensor, tvec: torch.Tensor,
                   max_k) -> torch.Tensor:
    """Smallest candidate whose count is <= max_k (counts are
    non-increasing in threshold). counts i32[B, H, W] -> thr f32[H, W].
    ``max_k``: an int K, or an f32 tensor target compared as f32."""
    ok = counts <= max_k                                    # [B, H, W]
    idx = torch.argmax(ok.to(torch.int8), dim=0)            # first True
    idx = torch.where(torch.any(ok, dim=0), idx, len(tvec) - 1)
    return tvec[idx]
