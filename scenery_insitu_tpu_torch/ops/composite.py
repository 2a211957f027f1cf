"""Sort-last VDI compositing: merge N ranks' sub-VDIs of the same pixels
into one VDI of at most K_out supersegments. The N·K segments of a pixel
are sorted by start depth and folded through the supersegment machine
for re-segmentation: the adaptive threshold search and the write fold,
either as the sequential machine over the slots (``backend="xla"``) or
fused in kernel K4 (``backend="pallas"``, ``ops/cuda_composite.py``).
``"auto"`` picks K4 for a CUDA tensor and the sequential machine on the
CPU. With one rank whose VDI already fits, the input is returned
unchanged (padded to K_out).

The ring exchange folds each arriving fragment into a sorted accumulator
with `merge_vdis_pairwise` instead of sorting all N·K slots;
`modeled_exchange_traffic` models the bytes either exchange moves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from scenery_insitu_tpu_torch.config import CompositeConfig
from scenery_insitu_tpu_torch.core.vdi import VDI
from scenery_insitu_tpu_torch.obs.profiler import phase as _phase
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
        with _phase("merge"):
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
    with _phase("resegment"):
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


def merge_vdis_pairwise(color_a: torch.Tensor, depth_a: torch.Tensor,
                        color_b: torch.Tensor, depth_b: torch.Tensor,
                        k_cap: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ordered merge of two per-pixel depth-sorted segment streams, the
    ring exchange's merge.

    ``color_a`` f32[Ka, 4, H, W], ``depth_a`` f32[Ka, 2, H, W] and the
    ``b`` pair likewise, each sorted by start depth per pixel with empty
    slots (+inf) at the back and their colours zeroed; unsorted inputs
    give garbage. A segment's merged position is its own index plus the
    count of the other stream's segments before it; ties go to stream
    ``a`` (the accumulator). The payloads move by gather, so +inf depths
    survive bit for bit.

    ``k_cap`` truncates the merged stream to its nearest ``k_cap``
    segments (the capped ring, ``CompositeConfig.ring_slots``); None
    keeps all Ka + Kb. Returns (color [M, 4, H, W], depth [M, 2, H, W]),
    M = min(Ka + Kb, k_cap or Ka + Kb)."""
    ka, kb = color_a.shape[0], color_b.shape[0]
    sa, sb = depth_a[:, 0], depth_b[:, 0]
    dev = sa.device
    # b_j precedes a_i iff sb_j < sa_i (ties -> a first)
    b_before_a = (sb[None] < sa[:, None]).sum(1)
    a_before_b = (sa[None] <= sb[:, None]).sum(1)
    ia = torch.arange(ka, device=dev).reshape(ka, 1, 1)
    ib = torch.arange(kb, device=dev).reshape(kb, 1, 1)
    pos = torch.cat([ia + b_before_a, ib + a_before_b])
    m = ka + kb
    m_out = m if k_cap is None else min(int(k_cap), m)
    # invert the permutation by a scatter, then gather the payloads; the
    # output slots past m_out (the farthest segments) are dropped
    in_ids = torch.arange(m, device=dev).reshape(m, 1, 1).expand_as(pos)
    inv = torch.zeros_like(pos).scatter(0, pos, in_ids)[:m_out]
    color = torch.take_along_dim(torch.cat([color_a, color_b]),
                                 inv[:, None], dim=0)
    depth = torch.take_along_dim(torch.cat([depth_a, depth_b]),
                                 inv[:, None], dim=0)
    return color, depth


def modeled_exchange_traffic(n: int, k: int, height: int, width: int,
                             k_out: Optional[int] = None,
                             mode: str = "all_to_all", ring_slots: int = 0,
                             itemsize: int = 4,
                             wire: str = "f32",
                             schedule: str = "frame",
                             wave_tiles: int = 1) -> dict:
    """Modeled per-rank bytes of one frame's sort-last exchange and
    composite; the reference's model, key for key.

    ``ici_bytes_per_rank``: the wire bytes each rank ships, n - 1
    K-fragments of its W/n column block under ``wire``'s slot bytes
    (``ops/wire.WIRE_SLOT_BYTES``; qpack8's 8-byte scale is left out),
    the same under either exchange. ``peak_stream_slots_per_pixel``: the
    merge's working set, N·K for the all_to_all and the lossless ring,
    ring_slots + K for the capped ring. ``stream_bytes_per_rank``: that
    working set and the ``k_out`` output slots in f32 ``itemsize``.
    ``schedule="waves"`` adds the tile waves' accounting: the same total
    bytes, of which waves 0..T-2 can hide behind the next wave's march
    and the last wave's stay exposed. On one card the in-process ranks
    move no bytes across a link: this is a model, not a measurement."""
    from scenery_insitu_tpu_torch.ops.wire import wire_slot_bytes

    wb = max(width // max(n, 1), 1)
    cb, db = wire_slot_bytes(wire)
    seg = 6 * itemsize
    frag = k * height * wb * (cb + db)
    if mode == "ring" and ring_slots:
        slots = min(int(ring_slots), n * k) + k
    else:
        slots = n * k
    out = {
        "mode": mode, "ranks": n, "k": k,
        "k_out": k_out, "ring_slots": ring_slots,
        "wire": wire,
        "schedule": schedule,
        "wire_color_bytes_per_slot": cb,
        "wire_depth_bytes_per_slot": db,
        "ici_bytes_per_rank": (n - 1) * frag,
        "peak_stream_slots_per_pixel": slots,
        "stream_bytes_per_rank": (slots + (k_out or 0)) * height * wb * seg,
    }
    if schedule == "waves":
        t = max(int(wave_tiles), 1)
        # hidden + exposed always equals the total; a remainder is
        # charged to the exposed (last) wave
        total = out["ici_bytes_per_rank"]
        per_wave = total // t
        hidden = (t - 1) * per_wave
        out["wave_tiles"] = t
        out["ici_bytes_per_wave_per_rank"] = per_wave
        out["ici_bytes_hidden_per_rank"] = hidden
        out["ici_bytes_exposed_per_rank"] = total - hidden
        out["overlap_hidden_frac"] = round(hidden / total, 4) if total \
            else 0.0
    return out


def composite_plain(images: torch.Tensor, depths: torch.Tensor,
                    background: Tuple[float, ...] = (0, 0, 0, 0)
                    ) -> torch.Tensor:
    """Plain-image sort-last composite: ``images f32[N, 4, H, W]``
    premultiplied, ``depths f32[N, H, W]`` (+inf for empty pixels) ->
    ``f32[4, H, W]`` by per-pixel nearest-first alpha-under, the
    background blended once. The sort is stable: tied depths (every
    empty rank's +inf) keep the ranks' order."""
    order = torch.argsort(depths, dim=0, stable=True)      # [N, H, W]
    sorted_imgs = torch.take_along_dim(images, order[:, None], dim=0)
    acc = torch.zeros_like(images[0])
    for src in sorted_imgs:
        acc = acc + (1.0 - acc[3:4]) * src
    bg = torch.tensor(background, dtype=torch.float32,
                      device=acc.device).reshape(4, 1, 1)
    return acc + (1.0 - acc[3:4]) * bg


def composite_depth_min(images: torch.Tensor, depths: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-first composite: per pixel the rank whose fragment is
    nearest (the first on a tie). Returns (image [4, H, W], depth [H,
    W])."""
    idx = torch.argmin(depths, dim=0, keepdim=True)         # [1, H, W]
    img = torch.take_along_dim(images, idx[:, None], dim=0)[0]
    return img, torch.take_along_dim(depths, idx, dim=0)[0]
