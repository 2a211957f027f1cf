"""The kernels of the reference's ``pallas_march``: K2, the
multi-threshold segment-start count (``csrc/count_multi.cu``), and B7,
the sequential machine's write fold (``csrc/fold_chunk.cu``).

K2 is one chunk of the all-candidates counting march: ≅ feeding
``supersegments.init_count_multi`` state through ``push_count`` with
``threshold = tvec[:, None, None]``. The carry is packed as ``(count
i32[B,H,W], prev f32[3,H,W], prev_empty f32[H,W])``.

B7 (`fold_chunk`) is C sequential ``supersegments.push`` calls on the
machine state packed as the reference packs it (`init_packed`,
`pack_state`, `unpack_state`): ``color f32[K,4,H,W]``, ``depth
f32[K,2,H,W]`` (+inf in both columns until written, as
``supersegments.init_state``) and ``small f32[12,H,W]`` = open segment
rgba (0-3), start (4), end (5), prev rgb (6-8), open (9), prev empty
(10), next slot k (11). With ``count`` it also adds the true segment
starts (``push_count``'s), the temporal controller's feedback.

Unlike the reference's immutable carries, both update their state IN
PLACE. On a CUDA tensor a wrapper launches its kernel (or raises); on a
CPU tensor it runs its plain version (`count_multi_chunk_plain`,
`fold_chunk_plain`). Counts equal the plain versions' exactly.
"""

from __future__ import annotations

from typing import Optional

import torch

from scenery_insitu_tpu_torch import kernels
from scenery_insitu_tpu_torch.device import resolve_device
from scenery_insitu_tpu_torch.ops import cuda_seg as cs
from scenery_insitu_tpu_torch.ops import supersegments as ss

MAX_BINS = 32   # kMaxBins of the kernel: the counts live in registers

# small-state rows of the packed machine
_SEG_RGBA = slice(0, 4)
_SEG_START, _SEG_END = 4, 5
_PREV_RGB = slice(6, 9)
_OPEN, _PREV_EMPTY, _K = 9, 10, 11
NSMALL = 12


def init_count_multi_packed(bins: int, height: int, width: int,
                            device=None):
    dev = resolve_device(device)
    return (torch.zeros((bins, height, width), dtype=torch.int32,
                        device=dev),
            torch.zeros((3, height, width), device=dev),
            torch.ones((height, width), device=dev))


def _check(carry, rgba, tvec):
    count, prev, fe = carry
    b, h, w = count.shape
    c = rgba.shape[0]
    kernels.check_operands({
        "count": (count, (b, h, w), torch.int32),
        "prev": (prev, (3, h, w), torch.float32),
        "prev_empty": (fe, (h, w), torch.float32),
        "rgba": (rgba, (c, 4, h, w), torch.float32),
        "tvec": (tvec, (b,), torch.float32)}, "count")
    if not 1 <= b <= MAX_BINS:
        raise ValueError(f"{b} candidate thresholds; the kernel takes "
                         f"1..{MAX_BINS}")
    if c < 1:
        raise ValueError("a chunk holds at least one slice")


def count_multi_chunk(carry, rgba: torch.Tensor, tvec: torch.Tensor):
    """Count one chunk ``rgba f32[C,4,H,W]`` into ``carry`` in place and
    return it. ``tvec f32[B]`` are the candidate thresholds."""
    count, prev, fe = carry
    tvec = torch.as_tensor(tvec, dtype=torch.float32, device=count.device)
    _check(carry, rgba, tvec)
    if count.device.type == "cpu":
        return count_multi_chunk_plain(carry, rgba, tvec)
    if count.device.type != "cuda":
        raise ValueError(f"unsupported device {count.device}")
    b, h, w = count.shape
    kernels.launch("count_multi", rgba.data_ptr(), tvec.data_ptr(),
                   count.data_ptr(), prev.data_ptr(), fe.data_ptr(),
                   rgba.shape[0], b, h, w)
    return carry


def count_attributes(c: int, bins: int) -> dict:
    """The build of K2 that a chunk of ``c`` slices and ``bins``
    thresholds takes, on the current card: registers and local-memory
    bytes a thread, shared bytes a block, resident blocks an SM, threads
    a block and the slices whose loads go out together. Needs a card: it
    loads the kernel library."""
    if c < 1 or not 1 <= bins <= MAX_BINS:
        raise ValueError(f"c={c}, bins={bins}: the kernel takes c >= 1 "
                         f"and 1..{MAX_BINS} thresholds")
    out = kernels.query("count_multi_attributes", c, bins, nout=6)
    keys = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm",
            "threads", "slices")
    return dict(zip(keys, out))


def count_multi_chunk_plain(carry, rgba: torch.Tensor, tvec: torch.Tensor):
    """Plain version of K2: sequential ``push_count`` over the slices
    with the candidate stack as the threshold, in place. Any device."""
    count, prev, fe = carry
    st = ss.CountState(count, prev, fe > 0.5, None)
    thr = tvec[:, None, None]
    for i in range(rgba.shape[0]):
        st = ss.push_count(st, thr, rgba[i])
    count.copy_(st.count)
    prev.copy_(st.prev_rgb)
    fe.copy_(st.prev_empty.to(torch.float32))
    return carry


# ------------------------------------------------ B7: the machine's fold


def init_packed(k: int, height: int, width: int, device=None):
    """Packed machine state ≅ ``supersegments.init_state``: both depth
    columns start at +inf."""
    dev = resolve_device(device)
    color = torch.zeros((k, 4, height, width), device=dev)
    depth = torch.full((k, 2, height, width), torch.inf, device=dev)
    small = torch.zeros((NSMALL, height, width), device=dev)
    small[_PREV_EMPTY] = 1.0
    return color, depth, small


def pack_state(st: ss.SegState):
    f32 = lambda x: x.to(torch.float32)[None]
    small = torch.cat([st.seg_rgba, st.seg_start[None], st.seg_end[None],
                       st.prev_rgb, f32(st.open_), f32(st.prev_empty),
                       f32(st.k)])
    return (st.out_color.contiguous(),
            torch.stack([st.out_start, st.out_end], dim=1), small)


def unpack_state(packed) -> ss.SegState:
    color, depth, small = packed
    return ss.SegState(
        out_color=color, out_start=depth[:, 0], out_end=depth[:, 1],
        k=small[_K].to(torch.int32), open_=small[_OPEN] > 0.5,
        seg_rgba=small[_SEG_RGBA], seg_start=small[_SEG_START],
        seg_end=small[_SEG_END], prev_rgb=small[_PREV_RGB],
        prev_empty=small[_PREV_EMPTY] > 0.5)


def fold_chunk(packed, rgba: torch.Tensor, t0: torch.Tensor,
               t1: torch.Tensor, threshold, *, max_k: int,
               count: Optional[torch.Tensor] = None, gap_eps: float = -1.0):
    """Fold one chunk ``rgba f32[C,4,H,W]`` with depths ``t0``/``t1
    f32[C,H,W]`` through the machine, in place. ``threshold`` is a
    scalar or [H, W]; ``max_k`` must equal the state's K; ``count``
    (i32[H,W]) accumulates the true segment starts in place. Returns
    ``packed``, or ``(packed, count)`` when ``count`` is given."""
    color, depth, small = packed
    k, _, h, w = color.shape
    if max_k != k:
        raise ValueError(f"max_k={max_k} but the state holds {k} slots")
    c = rgba.shape[0]
    threshold = cs.as_plane(threshold, h, w, color.device)
    f32 = torch.float32
    want = {**cs.check_packed(packed, c, NSMALL),
            "rgba": (rgba, (c, 4, h, w), f32),
            "t0": (t0, (c, h, w), f32), "t1": (t1, (c, h, w), f32),
            "threshold": (threshold, (h, w), f32)}
    if count is not None:
        want["count"] = (count, (h, w), torch.int32)
    kernels.check_operands(want, "color")
    if color.device.type == "cpu":
        return fold_chunk_plain(packed, rgba, t0, t1, threshold,
                                max_k=max_k, count=count, gap_eps=gap_eps)
    if color.device.type != "cuda":
        raise ValueError(f"unsupported device {color.device}")
    kernels.launch("fold_chunk", rgba.data_ptr(), t0.data_ptr(),
                   t1.data_ptr(), threshold.data_ptr(), color.data_ptr(),
                   depth.data_ptr(), small.data_ptr(),
                   None if count is None else count.data_ptr(), c, k, h, w,
                   gap_eps)
    return packed if count is None else (packed, count)


def fold_chunk_plain(packed, rgba: torch.Tensor, t0: torch.Tensor,
                     t1: torch.Tensor, threshold, *, max_k: int,
                     count: Optional[torch.Tensor] = None,
                     gap_eps: float = -1.0):
    """Plain version of B7: C sequential ``supersegments.push`` calls
    (and ``push_count`` calls when ``count`` is given) on the unpacked
    state, written back in place. Any device."""
    st = unpack_state(packed)
    cst = None if count is None else ss.CountState(
        count, st.prev_rgb, st.prev_empty, None)
    for i in range(rgba.shape[0]):
        st = ss.push(st, max_k, threshold, rgba[i], t0[i], t1[i], gap_eps)
        if cst is not None:
            cst = ss.push_count(cst, threshold, rgba[i])
    for dst, src in zip(packed, pack_state(st)):
        dst.copy_(src)
    if count is None:
        return packed
    count.copy_(cst.count)
    return packed, count
