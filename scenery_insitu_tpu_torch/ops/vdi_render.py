"""Novel-view rendering of a VDI by gathers: the portable renderer and the
quality reference of the banded-matmul renderers (`ops/vdi_novel`).

A VDI is a per-pixel list of depth slabs of its generating camera. A new
camera's ray is marched in a fixed number of steps over the generating
frustum's AABB; each step projects the world point into the generating
camera (one matrix product), gathers that pixel's K slabs, tests "inside
a slab" with a masked reduction over K (the slabs of a pixel are
disjoint, so a sum selects the one that holds the point), and corrects
the slab's opacity for the step's share of its thickness. VDI depths are
the generating camera's ray parameter (distance from its eye along unit
directions), so the in-slab test is one distance comparison.
"""

from __future__ import annotations

from typing import Tuple

import torch

from scenery_insitu_tpu_torch.core.camera import Camera, pixel_rays
from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata
from scenery_insitu_tpu_torch.ops.sampling import (adjust_opacity,
                                                   intersect_aabb)


def original_eye(meta: VDIMetadata) -> torch.Tensor:
    """The generating camera's world position from its view matrix (eye =
    -R^T t)."""
    rot = meta.view[:3, :3]
    return -rot.T @ meta.view[:3, 3]


def frustum_aabb(meta: VDIMetadata) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space AABB of the generating camera's frustum: where the VDI
    can hold content."""
    dev = meta.view.device
    inv = torch.linalg.inv(meta.projection @ meta.view)
    pm = torch.tensor([-1.0, 1.0], device=dev)
    corners = torch.stack(torch.meshgrid(pm, pm, pm, indexing="ij"),
                          dim=-1).reshape(-1, 3)
    h = torch.cat([corners, torch.ones((8, 1), device=dev)], dim=-1)
    w = h @ inv.T
    pts = w[:, :3] / w[:, 3:4]
    return torch.amin(pts, dim=0), torch.amax(pts, dim=0)


def render_vdi(vdi: VDI, meta: VDIMetadata, cam: Camera, width: int,
               height: int, steps: int = 256,
               background: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
               ) -> torch.Tensor:
    """Render a VDI from an arbitrary new camera -> f32[4, H, W]
    premultiplied. ``steps`` is the march length along each output ray,
    clipped to the generating frustum's AABB."""
    k, _, h0, w0 = vdi.color.shape
    dev = vdi.color.device
    origin, dirs = pixel_rays(cam, width, height)

    box_min, box_max = frustum_aabb(meta)
    tnear, tfar = intersect_aabb(origin, dirs, box_min, box_max)
    hit = tfar > tnear
    tfar = torch.maximum(tfar, tnear)
    dt = (tfar - tnear) / steps                             # [H, W]

    eye0 = original_eye(meta).reshape(3, 1, 1)
    pv0 = meta.projection @ meta.view                       # [4, 4]

    # the per-pixel lists, flattened for gathering
    flat_c = vdi.color.reshape(k, 4, h0 * w0)
    flat_start = vdi.depth[:, 0].reshape(k, h0 * w0)
    flat_end = vdi.depth[:, 1].reshape(k, h0 * w0)

    acc = torch.zeros((4, height, width), dtype=torch.float32, device=dev)
    for i in range(steps):
        t = tnear + (i + 0.5) * dt                          # [H, W]
        pos = origin.reshape(3, 1, 1) + t[None] * dirs      # [3, H, W]
        # project into the generating camera's pixel grid
        ph = torch.cat([pos, torch.ones_like(pos[:1])])
        clip = torch.einsum("ab,bhw->ahw", pv0, ph)
        behind = clip[3] <= 1e-6
        ndc = clip[:3] / torch.where(behind, 1.0, clip[3])[None]
        u = (ndc[0] + 1.0) * 0.5 * w0
        v = (1.0 - ndc[1]) * 0.5 * h0
        iu = torch.clamp(u.to(torch.int32), 0, w0 - 1).to(torch.int64)
        iv = torch.clamp(v.to(torch.int32), 0, h0 - 1).to(torch.int64)
        in_view = (~behind & (u >= 0) & (u < w0) & (v >= 0) & (v < h0)
                   & (ndc[2] >= -1.0) & (ndc[2] <= 1.0) & hit)
        lin = iv * w0 + iu                                  # [H, W]

        # distance from the generating eye: the VDI's depth coordinate
        r = torch.linalg.norm(pos - eye0, dim=0)

        lists_c = flat_c[:, :, lin]                         # [K, 4, H, W]
        starts = flat_start[:, lin]                         # [K, H, W]
        ends = flat_end[:, lin]
        inside = (r[None] >= starts) & (r[None] < ends) & in_view[None]
        # an empty slot's extent is inf - inf = nan; it takes the floor,
        # as the reference's CPU max (x > lo ? x : lo) gives it
        ext = ends - starts
        slab_len = torch.where(ext > 1e-6, ext, 1e-6)

        # at most one slab holds r, so the masked sums select it
        sel = inside.to(torch.float32)[:, None]             # [K, 1, H, W]
        rgba = torch.sum(lists_c * sel, dim=0)              # [4, H, W]
        length = torch.sum(slab_len * inside, dim=0)        # [H, W]

        # the step's alpha: dt of a slab whose whole-thickness opacity is
        # rgba[3]
        a_slab = torch.clamp(rgba[3], 0.0, 1.0 - 1e-6)
        a_step = adjust_opacity(a_slab, dt / torch.clamp(length, min=1e-6))
        a_step = torch.where(torch.any(inside, dim=0), a_step, 0.0)
        rgb_unit = rgba[:3] / torch.clamp(a_slab, min=1e-6)[None]
        src = torch.cat([rgb_unit * a_step[None], a_step[None]])
        acc = acc + (1.0 - acc[3:4]) * src
    bg = torch.tensor(background, dtype=torch.float32,
                      device=dev).reshape(4, 1, 1)
    return acc + (1.0 - acc[3:4]) * bg
