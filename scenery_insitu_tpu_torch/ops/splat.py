"""Particle rendering: lit sphere impostors splatted into a z-buffer.

The reference renders particles as one scene-graph sphere each; here the
pass is one vectorized scatter program:

  project N particles -> an S x S pixel stamp a particle -> z-buffer
  scatter-min -> the winning fragment's colour a pixel

Spheres are shaded as impostors (a per-pixel depth offset and a
headlight Lambert term), so a particle occludes correctly against other
particles, within a rank and across ranks (the sort-first depth-min
composite, ``ops/composite.composite_depth_min``).

Depths are the world-space ray parameter t, the distance from the eye:
the one depth convention of the renderers and VDIs, so particle
fragments depth-compare with volume supersegments everywhere in the
frame (``ops/hybrid.py``).

Coincident fragments: where two fragments reach a pixel at the same
depth, the one with the largest flat fragment index (particle, then
stamp pixel) writes its colour, the order a serial scatter writes in.
The winner is picked by a second scatter (the largest index among the
fragments at the pixel's depth), so the choice is deterministic on a
card too.

Only the fragments that land (a visible particle's covered, in-frame
stamp pixels) reach the two scatters: the reference routes the others
to a spill slot, which on a card is one address every dropped fragment
of a million-particle frame would contend for. Selecting them (and the
winners at a pixel's depth) costs three copies of a count to the host
a call.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from scenery_insitu_tpu_torch.core.camera import (Camera, projection_matrix,
                                                  view_matrix)
from scenery_insitu_tpu_torch.core.transfer import colormap_lut


class SplatOutput(NamedTuple):
    image: torch.Tensor   # f32[4, H, W] premultiplied RGBA
    depth: torch.Tensor   # f32[H, W] ray-parameter depth; +inf where empty


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as ``sqrt(sum(x * x))``."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def speed_colors(vel: torch.Tensor, colormap: str = "jet",
                 alpha: float = 1.0, mean: Optional[torch.Tensor] = None,
                 std: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Colour particles by sigmoid-normalised speed: speeds standardised
    against the population mean and (population) std, squashed through a
    sigmoid, used as the colormap coordinate. -> ``f32[N, 4]`` straight
    RGBA. ``mean``/``std`` override the population statistics: the
    distributed steps pass the ones summed over every rank."""
    speed = _norm(vel)
    mean = torch.mean(speed) if mean is None else mean
    if std is None:
        std = torch.sqrt(torch.mean((speed - mean) ** 2))
    std = torch.clamp(std, min=1e-8)
    u = 1.0 / (1.0 + torch.exp(-(speed - mean) / std))
    lut = torch.as_tensor(colormap_lut(colormap), device=vel.device)
    n = lut.shape[0]
    x = torch.clamp(u, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, n - 2)
    frac = (x - i0)[..., None]
    rgb = lut[i0] * (1 - frac) + lut[i0 + 1] * frac
    return torch.cat([rgb, torch.full_like(rgb[..., :1], alpha)], dim=-1)


def _affine(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``p @ m[:3, :3].T + m[:3, 3]`` as elementwise products summed in
    column order: every particle's result is the same whatever the batch
    (a batched matmul may change its summation with the batch's size)."""
    r = m[:3, :3]
    return (p[:, 0:1] * r[:, 0] + p[:, 1:2] * r[:, 1] + p[:, 2:3] * r[:, 2]
            + m[:3, 3])


def splat_particles(pos: torch.Tensor, rgba: torch.Tensor, radius,
                    cam: Optional[Camera], width: int, height: int,
                    stamp: int = 9, ambient: float = 0.25,
                    radii: Optional[torch.Tensor] = None,
                    view: Optional[torch.Tensor] = None,
                    proj: Optional[torch.Tensor] = None,
                    near: float = 1e-3, far: float = math.inf
                    ) -> SplatOutput:
    """Render particles as lit opaque spheres.

    ``pos f32[N, 3]`` world positions; ``rgba f32[N, 4]`` straight
    colours; ``radius`` the world-space sphere radius (or per particle,
    ``radii f32[N]``); ``stamp`` the odd stamp side in pixels (the
    on-screen radius is clamped to ``stamp // 2``). Explicit ``view``
    and ``proj`` 4x4 matrices (with ``cam=None``) splat onto another
    frustum, e.g. the slice march's virtual axis camera, which is how
    the hybrid frame shares rays between particles and the volume."""
    n = pos.shape[0]
    dev = pos.device
    if view is None:
        view = view_matrix(cam)
    if proj is None:
        proj = projection_matrix(cam, width, height)
    if cam is not None:
        near, far = cam.near, cam.far
    r_world = (torch.full((n,), float(radius), dtype=torch.float32,
                          device=dev) if radii is None else radii)

    p_eye = _affine(pos, view)                              # [N, 3]
    z = -p_eye[:, 2]                                        # > 0 in front
    t_ray = _norm(p_eye)                                    # ray parameter
    clip = _affine(p_eye, proj)
    w_clip = -p_eye[:, 2]                                   # proj[3] = (0,0,-1,0)
    ndc = clip[:, :2] / torch.where(w_clip == 0.0, 1e-12, w_clip)[:, None]
    px = (ndc[:, 0] + 1.0) * 0.5 * width - 0.5
    py = (1.0 - ndc[:, 1]) * 0.5 * height - 0.5
    r_px = r_world * proj[1, 1] * (height * 0.5) / torch.clamp(z, min=1e-6)
    r_px = torch.clamp(r_px, max=float(stamp // 2))
    visible = (z > near) & (z < far) & (r_px > 0.05)

    # only visible particles make fragments; their indices ascend, so a
    # kept fragment's position orders the fragments as their flat index
    # (particle * S² + stamp pixel) does
    vis = torch.nonzero(visible).squeeze(1)
    px, py, r_px = px[vis], py[vis], r_px[vis]

    # the S x S stamp about each particle's centre pixel
    half = stamp // 2
    offs = torch.arange(-half, half + 1, dtype=torch.float32, device=dev)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    ox, oy = ox.reshape(-1), oy.reshape(-1)                 # [S²]
    s2 = ox.numel()
    cx = torch.round(px)[:, None] + ox[None]                # [Nv, S²]
    cy = torch.round(py)[:, None] + oy[None]
    dx = cx - px[:, None]
    dy = cy - py[:, None]
    d2 = dx * dx + dy * dy
    r2 = r_px[:, None] ** 2
    covered = d2 <= r2
    in_bounds = (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
    # the kept fragments only: the dropped ones would all contend for
    # one spill slot of the scatters
    keep = torch.nonzero((covered & in_bounds).reshape(-1)).squeeze(1)
    part = vis[keep // s2]                                  # particle
    lin = (cy.reshape(-1)[keep].to(torch.int64) * width
           + cx.reshape(-1)[keep].to(torch.int64))
    # impostor depth offset and normal: the pixel samples the sphere
    frac2 = torch.clamp(d2.reshape(-1)[keep]
                        / torch.clamp(r2.reshape(-1)[keep // s2], min=1e-12),
                        0.0, 1.0)
    nz = torch.sqrt(1.0 - frac2)
    depth = t_ray[part] - nz * r_world[part]                # ray parameter t

    zbuf = torch.full((height * width,), math.inf, dtype=torch.float32,
                      device=dev)
    zbuf.scatter_reduce_(0, lin, depth, reduce="amin")

    # winner takes the pixel: of the fragments at the pixel's depth, the
    # one with the largest flat index
    won = torch.nonzero(zbuf[lin] == depth).squeeze(1)
    best = torch.full((height * width,), -1, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, lin[won], won, reduce="amax")
    hit = best >= 0
    f = best[hit]
    i = part[f]
    a = rgba[i, 3]
    shade = ambient + (1.0 - ambient) * nz[f]
    img = torch.zeros((height * width, 4), dtype=torch.float32, device=dev)
    img[hit] = torch.cat([rgba[i, :3] * (shade * a)[:, None], a[:, None]],
                         dim=-1)
    return SplatOutput(img.reshape(height, width, 4).permute(2, 0, 1)
                       .contiguous(), zbuf.reshape(height, width))
