"""Kernel K4: the sort-last composite's resegment (``csrc/resegment.cu``).

Semantics = the reference's ``pallas_composite.resegment_sorted``: a
per-pixel depth-sorted stream ``sc f32[NK,4,H,W]``, ``sd f32[NK,2,H,W]``
(empty slots: zero colour, +inf depth) is folded into at most ``k_out``
supersegments. ``adaptive_iters > 0`` runs that many counting passes of
the per-pixel threshold bisection over ``[0, thr_max]`` first;
otherwise ``threshold f32[H,W]`` (zeros when None) is used as it is.

On a CUDA tensor `resegment_sorted` launches the kernel (or raises); on
a CPU tensor it runs `resegment_sorted_plain`, the plain version the
kernel is held against. Its thresholds, and so its segment counts,
equal the plain version's exactly; ``threshold_out`` (f32[H,W]) receives
the per-pixel threshold either one used.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from scenery_insitu_tpu_torch import kernels
from scenery_insitu_tpu_torch.ops import supersegments as ss


def _check(sc, sd, threshold, threshold_out):
    nk, _, h, w = sc.shape
    f32 = torch.float32
    want = {"sc": (sc, (nk, 4, h, w), f32), "sd": (sd, (nk, 2, h, w), f32),
            "threshold": (threshold, (h, w), f32)}
    if threshold_out is not None:
        want["threshold_out"] = (threshold_out, (h, w), f32)
    kernels.check_operands(want, "sc")
    if nk < 1:
        raise ValueError("the stream holds at least one slot")


def resegment_sorted(sc: torch.Tensor, sd: torch.Tensor,
                     threshold: Optional[torch.Tensor], k_out: int,
                     gap_eps: float = 1e-4, adaptive_iters: int = 0,
                     thr_max: float = 2.0,
                     threshold_out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a depth-sorted slab stream into ``k_out`` supersegments per
    pixel. Returns (color f32[k_out,4,H,W], depth f32[k_out,2,H,W])."""
    _, _, h, w = sc.shape
    if threshold is None:
        threshold = torch.zeros((h, w), dtype=torch.float32,
                                device=sc.device)
    _check(sc, sd, threshold, threshold_out)
    if k_out < 1:
        raise ValueError(f"k_out must be >= 1, got {k_out}")
    if sc.device.type == "cpu":
        return resegment_sorted_plain(sc, sd, threshold, k_out, gap_eps,
                                      adaptive_iters, thr_max, threshold_out)
    if sc.device.type != "cuda":
        raise ValueError(f"unsupported device {sc.device}")
    color = torch.empty((k_out, 4, h, w), dtype=torch.float32,
                        device=sc.device)
    depth = torch.empty((k_out, 2, h, w), dtype=torch.float32,
                        device=sc.device)
    kernels.launch("resegment_sorted", sc.data_ptr(), sd.data_ptr(),
                   threshold.data_ptr(), color.data_ptr(), depth.data_ptr(),
                   None if threshold_out is None else threshold_out.data_ptr(),
                   sc.shape[0], k_out, h, w, adaptive_iters, gap_eps,
                   thr_max, nbytes=kernels.operand_bytes(
                       (sc, sd, threshold), (color, depth, threshold_out)))
    return color, depth


def attributes(nk: int, k_out: int, adaptive_iters: int) -> dict:
    """The build of K4 that a call of (``nk``, ``k_out``,
    ``adaptive_iters``) takes, on the current card: registers and
    local-memory bytes a thread, shared bytes a block, resident blocks an
    SM, threads a block, the search list's entries (0 without the
    search) and whether the list lives in registers. Needs a card: it
    loads the kernel library."""
    if nk < 1 or k_out < 1:
        raise ValueError("the stream and the output hold at least one slot")
    out = kernels.query("resegment_attributes", nk, k_out, adaptive_iters,
                        nout=7)
    keys = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm",
            "threads", "list", "list_in_registers")
    return dict(zip(keys, out))


def resegment_sorted_plain(sc: torch.Tensor, sd: torch.Tensor,
                           threshold: Optional[torch.Tensor], k_out: int,
                           gap_eps: float = 1e-4, adaptive_iters: int = 0,
                           thr_max: float = 2.0,
                           threshold_out: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: ``supersegments.push_count`` passes of the
    bisection, then ``push`` over the slots and ``finalize``. Any
    device."""
    _, _, h, w = sc.shape
    dev = sc.device
    if adaptive_iters > 0:
        def count_fn(thr):
            st = ss.init_count(h, w, device=dev)
            for c, d in zip(sc, sd):
                st = ss.push_count(st, thr, c, d[0], d[1], gap_eps)
            return st.count
        threshold = ss.adaptive_threshold(count_fn, k_out, adaptive_iters,
                                          h, w, thr_max, device=dev)
    elif threshold is None:
        threshold = torch.zeros((h, w), dtype=torch.float32, device=dev)
    if threshold_out is not None:
        threshold_out.copy_(threshold)
    state = ss.init_state(k_out, h, w, device=dev)
    for c, d in zip(sc, sd):
        state = ss.push(state, k_out, threshold, c, d[0], d[1], gap_eps)
    return ss.finalize(state)
