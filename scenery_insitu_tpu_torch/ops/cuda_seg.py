"""Kernel K1: the segmented write fold on packed state (``csrc/seg_fold.cu``).

Semantics = ``seg_fold.seg_fold_chunk`` on one chunk of shaded slices.
The fold state is carried in the packed layout of the reference's
``pallas_seg``: ``color f32[K,4,H,W]``, ``depth f32[K,2,H,W]`` (start
+inf / end -inf until written) and ``small f32[5,H,W]`` = count
(f32-encoded), prev rgb, prev empty. Depths come in one of two forms:
the compact form the march feeds, per-slice ratios ``sk0``/``sk1
f32[C]`` and the per-pixel ray ``length f32[H,W]`` with ``t = sk *
length`` (entry ``seg_fold_compact``), or the planes form ``t0``/``t1
f32[C,H,W]`` (entry ``seg_fold_planes``, the reference's B1b).

Unlike the reference, whose state was immutable, `fold_chunk_packed`
updates the three state tensors IN PLACE and returns the same triple.
On a CUDA tensor it launches the kernel (or raises); on a CPU tensor it
runs `fold_chunk_packed_plain`, the plain version the kernel is held
against.

The kernel has one build for a live chunk's slice count, C = 16, with
the walk unrolled, and a generic build for any other C (a skipped
chunk's one sample included); both issue 4 slices' loads before they
walk them. `attributes` reports each build's registers, memory,
resident blocks and the slices it holds at once.
"""

from __future__ import annotations

import torch

from scenery_insitu_tpu_torch import kernels
from scenery_insitu_tpu_torch.device import resolve_device
from scenery_insitu_tpu_torch.ops import seg_fold as sf

_CNT, _PREV_RGB, _PREV_EMPTY = 0, slice(1, 4), 4
NSMALL = 5


def init_seg_packed(k: int, height: int, width: int, device=None):
    """Packed fold state ≅ ``seg_fold.init_seg_state``."""
    dev = resolve_device(device)
    color = torch.zeros((k, 4, height, width), device=dev)
    depth = torch.empty((k, 2, height, width), device=dev)
    depth[:, 0] = torch.inf
    depth[:, 1] = -torch.inf
    small = torch.zeros((NSMALL, height, width), device=dev)
    small[_PREV_EMPTY] = 1.0
    return color, depth, small


def pack_seg_state(st: sf.SegFoldState):
    small = torch.cat([st.cnt.to(torch.float32)[None], st.prev_rgb,
                       st.prev_empty.to(torch.float32)[None]])
    return (st.out_color.contiguous(),
            torch.stack([st.out_start, st.out_end], dim=1), small)


def unpack_seg_state(packed) -> sf.SegFoldState:
    color, depth, small = packed
    return sf.SegFoldState(
        out_color=color, out_start=depth[:, 0], out_end=depth[:, 1],
        cnt=small[_CNT].to(torch.int32), prev_rgb=small[_PREV_RGB],
        prev_empty=small[_PREV_EMPTY] > 0.5)


def check_packed(packed, c: int, nsmall: int = NSMALL) -> dict:
    """The operand table of a packed fold state (colour, depth, small of
    ``nsmall`` rows) for `kernels.check_operands`; ``c`` must be >= 1."""
    color, depth, small = packed
    k, _, h, w = color.shape
    if c < 1:
        raise ValueError("a chunk holds at least one slice")
    f32 = torch.float32
    return {"color": (color, (k, 4, h, w), f32),
            "depth": (depth, (k, 2, h, w), f32),
            "small": (small, (nsmall, h, w), f32)}


def _depth_form(c, h, w, sk0, sk1, length, t0, t1) -> dict:
    """The operand table of exactly one complete depth form, (t0, t1) or
    (sk0, sk1, length); raises on a mixed or incomplete set."""
    planes = {"t0": t0, "t1": t1}
    compact = {"sk0": sk0, "sk1": sk1, "length": length}
    planes_any = any(x is not None for x in planes.values())
    compact_any = any(x is not None for x in compact.values())
    if planes_any and compact_any:
        raise ValueError("depth forms cannot be mixed: got t0/t1 plane "
                         "args together with sk0/sk1/length compact args")
    if not (all(x is not None for x in planes.values())
            or all(x is not None for x in compact.values())):
        raise ValueError("pass exactly one COMPLETE depth form: "
                         "(t0, t1) or (sk0, sk1, length)")
    f32 = torch.float32
    if planes_any:
        return {n: (x, (c, h, w), f32) for n, x in planes.items()}
    return {"sk0": (sk0, (c,), f32), "sk1": (sk1, (c,), f32),
            "length": (length, (h, w), f32)}


def attributes(c: int, planes: bool = False) -> dict:
    """The build of K1 (``planes=False``) or B1b that a chunk of ``c``
    slices takes, on the current card: registers and local-memory bytes
    a thread, shared bytes a block, resident blocks an SM, threads a
    block and the slices it holds at once (the smaller of ``c`` and 4).
    Needs a card: it loads the kernel library."""
    if c < 1:
        raise ValueError("a chunk holds at least one slice")
    out = kernels.query("seg_fold_attributes", c, int(planes), nout=6)
    keys = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm",
            "threads", "slices")
    return dict(zip(keys, out))


def as_plane(value, h, w, dev) -> torch.Tensor:
    """``value`` (a scalar or [H, W]) as a contiguous f32[H, W]."""
    return torch.as_tensor(value, dtype=torch.float32,
                           device=dev).expand(h, w).contiguous()


def fold_chunk_packed(packed, rgba: torch.Tensor, threshold, *, max_k: int,
                      sk0=None, sk1=None, length=None, t0=None, t1=None):
    """Fold one chunk ``rgba f32[C,4,H,W]`` into ``packed`` in place and
    return it. ``threshold`` is a scalar or [H, W]; ``max_k`` must equal
    the state's K. Depths: exactly one of (``sk0``, ``sk1``, ``length``)
    and (``t0``, ``t1``)."""
    color, depth, small = packed
    k, _, h, w = color.shape
    if max_k != k:
        raise ValueError(f"max_k={max_k} but the state holds {k} slots")
    c = rgba.shape[0]
    threshold = as_plane(threshold, h, w, color.device)
    want = {**check_packed(packed, c),
            "rgba": (rgba, (c, 4, h, w), torch.float32),
            "threshold": (threshold, (h, w), torch.float32),
            **_depth_form(c, h, w, sk0, sk1, length, t0, t1)}
    kernels.check_operands(want, "color")
    if color.device.type == "cpu":
        return fold_chunk_packed_plain(packed, rgba, threshold, max_k=max_k,
                                       sk0=sk0, sk1=sk1, length=length,
                                       t0=t0, t1=t1)
    if color.device.type != "cuda":
        raise ValueError(f"unsupported device {color.device}")
    if t0 is not None:
        kernels.launch("seg_fold_planes", rgba.data_ptr(), t0.data_ptr(),
                       t1.data_ptr(), threshold.data_ptr(), color.data_ptr(),
                       depth.data_ptr(), small.data_ptr(), c, k, h, w)
    else:
        kernels.launch("seg_fold_compact", rgba.data_ptr(),
                       length.data_ptr(), threshold.data_ptr(),
                       sk0.data_ptr(), sk1.data_ptr(), color.data_ptr(),
                       depth.data_ptr(), small.data_ptr(), c, k, h, w)
    return packed


def fold_chunk_packed_plain(packed, rgba: torch.Tensor, threshold, *,
                            max_k: int, sk0=None, sk1=None, length=None,
                            t0=None, t1=None):
    """Plain version of K1: ``seg_fold.seg_fold_chunk`` on the unpacked
    state (with ``t = sk * length`` in the compact form), written back
    into ``packed`` in place. Any device."""
    if t0 is None:
        t0 = sk0[:, None, None] * length[None]
        t1 = sk1[:, None, None] * length[None]
    st = sf.seg_fold_chunk(unpack_seg_state(packed), rgba, t0, t1,
                           threshold, max_k=max_k)
    for dst, src in zip(packed, pack_seg_state(st)):
        dst.copy_(src)
    return packed


def seg_fold_chunk(st: sf.SegFoldState, rgba: torch.Tensor,
                   t0: torch.Tensor, t1: torch.Tensor, threshold, *,
                   max_k: int) -> sf.SegFoldState:
    """Drop-in twin of ``seg_fold.seg_fold_chunk`` (NamedTuple in and
    out) through the planes form: packs the state, folds, unpacks; ``st``
    itself is left as it was."""
    color, depth, small = pack_seg_state(st)
    packed = (color.clone(), depth, small)
    fold_chunk_packed(packed, rgba, threshold, max_k=max_k, t0=t0, t1=t1)
    return unpack_seg_state(packed)
