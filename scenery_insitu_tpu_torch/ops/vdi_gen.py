"""VDI generation on the gather engine: every ray of the image marches
the volume at ``max_steps`` uniform steps (``ops/raycast.ray_ladder``)
and feeds the supersegment machine (``ops/supersegments.py``) one sample
a step. The adaptive threshold comes from ``adaptive_iters`` counting
marches (``"search"``) or one counting march over every candidate
(``"histogram"``); ``"temporal"`` is the slice march's
(``ops/slicer.generate_vdi_mxu_temporal``). The march is a Python loop
over the steps, as `raycast`'s is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from scenery_insitu_tpu_torch.config import VDIConfig
from scenery_insitu_tpu_torch.core.camera import (Camera,
                                                  projection_matrix,
                                                  view_matrix)
from scenery_insitu_tpu_torch.core.transfer import TransferFunction
from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata
from scenery_insitu_tpu_torch.core.volume import Volume
from scenery_insitu_tpu_torch.ops import supersegments as ss
from scenery_insitu_tpu_torch.ops.raycast import ray_ladder
from scenery_insitu_tpu_torch.ops.sampling import (adjust_opacity,
                                                   nominal_step,
                                                   sample_volume_world)


def generate_vdi(vol: Volume, tf: TransferFunction, cam: Camera,
                 width: int, height: int, cfg: Optional[VDIConfig] = None,
                 max_steps: int = 512, frame_index: int = 0,
                 clip_min=None, clip_max=None, sample_min=None,
                 sample_max=None) -> Tuple[VDI, VDIMetadata]:
    """The VDI ``[K, 4|2, height, width]`` of ``vol`` from ``cam`` and
    its metadata. ``clip_min``/``clip_max``: the box the rays clip to;
    ``sample_min``/``sample_max``: the global box the t ladder derives
    from, the clip box then only gating ownership (see
    `ops.raycast.ray_ladder`): the distributed step's ranks march the
    samples a single-device frame marches."""
    cfg = cfg or VDIConfig()
    if cfg.adaptive and cfg.adaptive_mode == "temporal":
        raise ValueError(
            "adaptive_mode='temporal' is an MXU slice-march feature "
            "(slicer.generate_vdi_mxu_temporal carries its per-frame "
            "state); the gather path supports 'search' and 'histogram'")
    k = cfg.max_supersegments
    n = max_steps
    origin, dirs, tnear, dt, hit, own = ray_ladder(
        vol, cam, width, height, n, clip_min, clip_max, sample_min,
        sample_max)
    nw = nominal_step(vol)
    ratio = dt / nw
    o = origin.reshape(3, 1, 1)
    dev = dirs.device

    def sample_at(i):
        """Premultiplied RGBA [4, H, W] of march step i, and t."""
        t = tnear + (i + 0.5) * dt
        rgb, a = tf(sample_volume_world(vol, (o + t[None] * dirs)
                                        .movedim(0, -1)))
        a = torch.where(hit, adjust_opacity(a, ratio), 0.0)
        if own is not None:
            a = torch.where((t >= own[0]) & (t < own[1]), a, 0.0)
        return torch.cat([rgb.movedim(-1, 0) * a[None], a[None]]), t

    if cfg.adaptive and cfg.adaptive_mode == "histogram":
        # one counting march evaluates every candidate threshold
        tvec = ss.threshold_candidates(cfg.histogram_bins, device=dev)
        st = ss.init_count_multi(cfg.histogram_bins, height, width,
                                 device=dev)
        for i in range(n):
            st = ss.push_count(st, tvec[:, None, None], sample_at(i)[0])
        threshold = ss.pick_threshold(st.count, tvec, k)
    elif cfg.adaptive:
        def count_fn(thr):
            st = ss.init_count(height, width, device=dev)
            for i in range(n):
                st = ss.push_count(st, thr, sample_at(i)[0])
            return st.count
        threshold = ss.adaptive_threshold(count_fn, k, cfg.adaptive_iters,
                                          height, width, device=dev)
    else:
        threshold = torch.full((height, width), cfg.threshold, device=dev)

    state = ss.init_state(k, height, width, device=dev)
    for i in range(n):
        rgba, t = sample_at(i)
        state = ss.push(state, k, threshold, rgba, t - 0.5 * dt,
                        t + 0.5 * dt)
    color, depth = ss.finalize(state)
    meta = VDIMetadata.create(
        projection=projection_matrix(cam, width, height),
        view=view_matrix(cam),
        volume_dims=torch.tensor(vol.dims_xyz, dtype=torch.float32),
        window_dims=(width, height), nw=nw, index=frame_index)
    return VDI(color, depth), meta


def occupancy_grid(vdi: VDI, tnear: torch.Tensor, tfar: torch.Tensor,
                   cell: int = 8,
                   depth_bins: Optional[int] = None) -> torch.Tensor:
    """Screen-space occupancy of a finished VDI: i32[B, H//cell,
    W//cell], the supersegments overlapping each depth bin in each pixel
    cell, the bins spanning [min tnear, max finite tfar] linearly."""
    k = vdi.color.shape[0]
    b = depth_bins or k
    lo = torch.amin(tnear)
    hi = torch.maximum(torch.amax(torch.where(torch.isfinite(tfar), tfar,
                                              lo)), lo + 1e-6)
    edges = lo + (hi - lo) * torch.linspace(0.0, 1.0, b + 1,
                                            device=tnear.device)
    start, end = vdi.depth[:, 0], vdi.depth[:, 1]          # [K, H, W]
    live = vdi.color[:, 3] > 0.0
    overlap = ((start[None] < edges[1:, None, None, None])
               & (end[None] > edges[:-1, None, None, None]) & live[None])
    per_pixel = overlap.sum(dim=1)                          # [B, H, W]
    hh = (per_pixel.shape[1] // cell) * cell
    ww = (per_pixel.shape[2] // cell) * cell
    pooled = per_pixel[:, :hh, :ww].reshape(b, hh // cell, cell,
                                            ww // cell, cell)
    return pooled.sum(dim=(2, 4)).to(torch.int32)
