"""Viewer-side reprojection between VDI keyframes (docs/SERVING.md
"Local reprojection").

Between two server answers, a small camera move does not need a round
trip: the classic VDI trick (PAPER.md — the representation is
view-independent, so the VIEW side owns small-motion latency) is to warp
the last rendered image onto the new camera through a proxy surface.
Here the proxy is the plane through the old camera's look-at target,
perpendicular to its view direction — exact for content on that plane,
a parallax-free approximation elsewhere, and always bounded by the next
keyframe (the server answer replaces the warp wholesale).

Pure numpy, host-side: this runs in the viewer process per displayed
frame, not on the render tier. The port of the reference's
``serve/reproject.py``; the cameras' tensors may lie on any device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import torch

from scenery_insitu_tpu_torch.core.camera import (Camera, pixel_rays,
                                                  projection_matrix,
                                                  view_matrix, world_to_ndc)
from scenery_insitu_tpu_torch.runtime.streaming import _host


def _cpu(cam: Camera) -> Camera:
    return Camera(*(torch.as_tensor(_host(x)) for x in cam))


def reproject_planar(img: np.ndarray, cam_from: Camera, cam_to: Camera,
                     plane_point: Optional[np.ndarray] = None,
                     plane_normal: Optional[np.ndarray] = None,
                     background: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
                     ) -> np.ndarray:
    """Inverse-warp ``img`` (f32[4, H, W] premultiplied, rendered from
    ``cam_from``) onto ``cam_to``'s pixels: each new pixel's ray is
    intersected with the proxy plane, the hit projected back through the
    OLD camera, and the old image bilinearly sampled there. Pixels whose
    ray misses the plane (behind the eye / parallel) or lands outside
    the old frame get ``background``. ``cam_to == cam_from`` is the
    identity up to bilinear epsilon."""
    img = np.asarray(_host(img), np.float32)
    _, h, w = img.shape
    cam_from, cam_to = _cpu(cam_from), _cpu(cam_to)
    eye_from = _host(cam_from.eye).astype(np.float64)
    target_from = _host(cam_from.target).astype(np.float64)
    p0 = (target_from if plane_point is None
          else np.asarray(plane_point, np.float64))
    n = ((p0 - eye_from) if plane_normal is None
         else np.asarray(plane_normal, np.float64))
    n = n / max(float(np.linalg.norm(n)), 1e-12)

    origin, dirs = pixel_rays(cam_to, w, h)
    origin = _host(origin).astype(np.float64)           # [3]
    dirs = _host(dirs).astype(np.float64)               # [3, H, W]
    denom = np.einsum("c,chw->hw", n, dirs)
    safe = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    t = float(np.dot(n, p0 - origin)) / safe            # [H, W]
    valid = (np.abs(denom) >= 1e-9) & (t > 0.0)
    world = origin[:, None, None] + t[None] * dirs      # [3, H, W]

    view = view_matrix(cam_from)
    proj = projection_matrix(cam_from, w, h)
    ndc = _host(world_to_ndc(
        torch.from_numpy(np.moveaxis(world, 0, -1).astype(np.float32)),
        view, proj))                                    # [H, W, 3]
    px = (ndc[..., 0] + 1.0) * 0.5 * w - 0.5
    py = (1.0 - ndc[..., 1]) * 0.5 * h - 0.5

    x0 = np.floor(px).astype(np.int64)
    y0 = np.floor(py).astype(np.int64)
    fx = (px - x0).astype(np.float32)
    fy = (py - y0).astype(np.float32)
    inside = valid & (px >= -0.5) & (px <= w - 0.5) \
        & (py >= -0.5) & (py <= h - 0.5)

    def tap(yy, xx):
        oob = (xx < 0) | (xx >= w) | (yy < 0) | (yy >= h)
        s = img[:, np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(oob[None], 0.0, s)

    out = ((1 - fx) * (1 - fy))[None] * tap(y0, x0) \
        + (fx * (1 - fy))[None] * tap(y0, x0 + 1) \
        + ((1 - fx) * fy)[None] * tap(y0 + 1, x0) \
        + (fx * fy)[None] * tap(y0 + 1, x0 + 1)
    bg = np.asarray(background, np.float32).reshape(4, 1, 1)
    return np.where(inside[None], out, bg).astype(np.float32)
