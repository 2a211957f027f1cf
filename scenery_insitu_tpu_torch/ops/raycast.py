"""The plain front-to-back volume raycaster: the gather engine's image.

Every ray samples the volume at ``max_steps`` uniform steps between its
entry and exit of the box (trilinear gathers, ``ops/sampling.py``),
shades each sample through the transfer function, corrects its opacity
for the step length and accumulates alpha-under. The march is a Python
loop over the steps, each one a few dozen ``[H, W]``-wide torch
operations. The slice-march engine (``ops/slicer.raycast_mxu``) renders
the same image without gathers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from scenery_insitu_tpu_torch.config import RenderConfig
from scenery_insitu_tpu_torch.core.camera import Camera, pixel_rays
from scenery_insitu_tpu_torch.core.transfer import TransferFunction
from scenery_insitu_tpu_torch.core.volume import Volume
from scenery_insitu_tpu_torch.ops.sampling import (adjust_opacity,
                                                   intersect_aabb,
                                                   nominal_step,
                                                   sample_volume_world)

__all__ = ["RaycastOutput", "nominal_step", "ray_ladder", "raycast",
           "raycast_image"]


class RaycastOutput(NamedTuple):
    image: torch.Tensor   # f32[4, H, W] premultiplied RGBA
    depth: torch.Tensor   # f32[H, W] ray parameter t of the first hit
                          # (alpha > 1e-4); +inf where the ray saw nothing


def ray_ladder(vol: Volume, cam: Camera, width: int, height: int,
               steps: int, clip_min=None, clip_max=None, sample_min=None,
               sample_max=None):
    """The rays and their t ladder: (origin, dirs [3, H, W], tnear, dt,
    hit, own). ``clip_min``/``clip_max`` override the box the rays clip
    to (a rank's own region while its volume carries halo slices).
    ``sample_min``/``sample_max``: the GLOBAL box the ladder derives
    from, the clip box then only gating ownership ``own = (cn, cf)``,
    half open: the shared plane's t is the same f32 expression on both
    neighbouring ranks, so every sample belongs to exactly one rank and
    a decomposed frame samples where the single-device frame does.
    ``own`` is None without a sample box."""
    origin, dirs = pixel_rays(cam, width, height)
    box_min = vol.world_min if clip_min is None else clip_min
    box_max = vol.world_max if clip_max is None else clip_max
    if sample_min is None:
        tnear, tfar = intersect_aabb(origin, dirs, box_min, box_max)
        own = None
    else:
        tnear, tfar = intersect_aabb(origin, dirs, sample_min, sample_max)
        cn, cf = intersect_aabb(origin, dirs, box_min, box_max)
        own = (cn, torch.maximum(cf, cn))
    hit = tfar > tnear
    tfar = torch.maximum(tfar, tnear)
    return origin, dirs, tnear, (tfar - tnear) / steps, hit, own


def raycast(vol: Volume, tf: TransferFunction, cam: Camera,
            width: int, height: int, cfg: Optional[RenderConfig] = None,
            clip_min=None, clip_max=None,
            ao_field: Optional[Volume] = None,
            sample_min=None, sample_max=None) -> RaycastOutput:
    """The plain image of ``vol`` from ``cam``: ``cfg.max_steps``
    samples a ray, a ray stopping once its alpha reaches
    ``cfg.early_exit_alpha``, the background blended once at the end.
    ``clip_min``/``clip_max``/``sample_min``/``sample_max``: see
    `ray_ladder`. ``ao_field`` (or ``cfg.ao_strength > 0``, which builds
    one, ``ops/ao.ao_field_volume``): an occlusion volume sampled at
    every step, darkening rgb by ``1 - occ``."""
    cfg = cfg or RenderConfig(width=width, height=height)
    if ao_field is None and cfg.ao_strength > 0.0:
        from scenery_insitu_tpu_torch.ops.ao import ao_field_volume

        ao_field = ao_field_volume(vol, tf, cfg.ao_radius, cfg.ao_strength)
    n = cfg.max_steps
    origin, dirs, tnear, dt, hit, own = ray_ladder(
        vol, cam, width, height, n, clip_min, clip_max, sample_min,
        sample_max)
    ratio = dt / nominal_step(vol, cfg.step_scale)
    o = origin.reshape(3, 1, 1)
    dev = dirs.device
    acc = torch.zeros((4, height, width), dtype=torch.float32, device=dev)
    first_t = torch.full((height, width), torch.inf, device=dev)
    for i in range(n):
        t = tnear + (i + 0.5) * dt                          # [H, W]
        pos = (o + t[None] * dirs).movedim(0, -1)           # [H, W, 3]
        rgb, a = tf(sample_volume_world(vol, pos))          # [H,W,3], [H,W]
        if ao_field is not None:
            rgb = rgb * (1.0 - sample_volume_world(ao_field, pos))[..., None]
        a = adjust_opacity(a, ratio)
        a = torch.where(hit & (acc[3] < cfg.early_exit_alpha), a, 0.0)
        if own is not None:
            a = torch.where((t >= own[0]) & (t < own[1]), a, 0.0)
        src = torch.cat([rgb.movedim(-1, 0) * a[None], a[None]])
        acc = acc + (1.0 - acc[3:4]) * src
        first_t = torch.where((first_t == torch.inf) & (a > 1e-4), t,
                              first_t)
    bg = torch.tensor(cfg.background, dtype=torch.float32,
                      device=dev).reshape(4, 1, 1)
    return RaycastOutput(acc + (1.0 - acc[3:4]) * bg, first_t)


def raycast_image(vol: Volume, tf: TransferFunction, cam: Camera,
                  width: int, height: int,
                  cfg: Optional[RenderConfig] = None) -> torch.Tensor:
    """`raycast`'s image f32[4, H, W]."""
    return raycast(vol, tf, cam, width, height, cfg).image
