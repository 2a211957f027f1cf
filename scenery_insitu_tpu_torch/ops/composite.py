"""Sort-last VDI compositing: merge N ranks' sub-VDIs of the same pixels
into one VDI of at most K_out supersegments. The N·K segments of a pixel
are sorted by start depth and folded through the supersegment machine
for re-segmentation: the adaptive threshold search and the write fold,
either as the sequential machine over the slots (``backend="xla"``) or
fused in kernel K4 (``backend="pallas"``, ``ops/cuda_composite.py``).
``"auto"`` picks K4 for a CUDA tensor and the sequential machine on the
CPU. With one rank whose VDI already fits, the input is returned
unchanged (padded to K_out).
"""

from __future__ import annotations

from typing import Optional

import torch

from scenery_insitu_tpu_torch.config import CompositeConfig
from scenery_insitu_tpu_torch.core.vdi import VDI
from scenery_insitu_tpu_torch.ops import cuda_composite as cc


def composite_vdis(colors: torch.Tensor, depths: torch.Tensor,
                   cfg: Optional[CompositeConfig] = None,
                   gap_eps: float = 1e-4,
                   assume_sorted: Optional[bool] = None) -> VDI:
    """colors f32[N, K, 4, H, W], depths f32[N, K, 2, H, W] -> VDI[K_out].

    ``assume_sorted`` skips the per-pixel depth sort and stale-color
    masking; it defaults to True for N == 1, whose VDI comes out of
    generation front-to-back ordered with zeroed empty slots."""
    cfg = cfg or CompositeConfig()
    n, k, _, h, w = colors.shape
    nk = n * k
    flat_c = colors.reshape(nk, 4, h, w)
    flat_d = depths.reshape(nk, 2, h, w)

    if assume_sorted is None:
        assume_sorted = (n == 1)
    if assume_sorted:
        sc, sd = flat_c, flat_d
    else:
        sc, sd = sort_stream(flat_c, flat_d)

    k_out = cfg.max_output_supersegments
    if (assume_sorted and n == 1 and k_out >= k and cfg.adaptive
            and cfg.backend == "auto"):
        # one already-segmented ray with enough output slots: the input
        # verbatim, padded with empty slots (zero color, +inf depth)
        pad = k_out - k
        if not pad:
            return VDI(flat_c, flat_d)
        return VDI(torch.cat([flat_c, flat_c.new_zeros(
                       (pad,) + tuple(flat_c.shape[1:]))]),
                   torch.cat([flat_d, torch.full(
                       (pad,) + tuple(flat_d.shape[1:]), torch.inf,
                       dtype=flat_d.dtype, device=flat_d.device)]))
    return resegment_stream(sc, sd, cfg, gap_eps)


def sort_stream(flat_c: torch.Tensor, flat_d: torch.Tensor):
    """Per-pixel sort by start depth of a stacked segment stream
    (``f32[M,4,H,W]``, ``f32[M,2,H,W]``), with non-live slots' colors
    zeroed."""
    order = torch.argsort(flat_d[:, 0], dim=0, stable=True)
    sc = torch.take_along_dim(flat_c, order[:, None], dim=0)
    sd = torch.take_along_dim(flat_d, order[:, None], dim=0)
    live = torch.isfinite(sd[:, 0])
    return torch.where(live[:, None], sc, 0.0), sd


def resegment_stream(sc: torch.Tensor, sd: torch.Tensor,
                     cfg: Optional[CompositeConfig] = None,
                     gap_eps: float = 1e-4) -> VDI:
    """Re-segment one per-pixel depth-sorted stream into at most
    ``cfg.max_output_supersegments`` supersegments: adaptive threshold
    search by counting passes, then one ``push`` fold, under the
    backend of ``cfg.backend``."""
    cfg = cfg or CompositeConfig()
    _, _, h, w = sc.shape
    k_out = cfg.max_output_supersegments
    backend = cfg.backend
    if backend == "auto":
        backend = "pallas" if sc.device.type == "cuda" else "xla"
    iters = cfg.adaptive_iters if cfg.adaptive else 0
    if backend == "pallas":
        # fully fused: the threshold search runs inside the kernel
        color, depth = cc.resegment_sorted(sc, sd, None, k_out, gap_eps,
                                           adaptive_iters=iters)
        return VDI(color, depth)
    # the sequential machine; with no search iterations an adaptive
    # composite keeps the bisection's upper end, as the reference does
    thr = torch.full((h, w), 2.0 if cfg.adaptive else 0.0,
                     dtype=torch.float32, device=sc.device)
    color, depth = cc.resegment_sorted_plain(sc, sd, thr, k_out, gap_eps,
                                             adaptive_iters=iters)
    return VDI(color, depth)
