"""Ambient occlusion for the plain raycasters: the occlusion estimate is
computed once a frame as a volume, a separable edge-clamped box blur of
the per-voxel opacity (three cumulative-sum passes, one an axis), and
each sample is shaded by ``1 - occlusion``. The gather raycaster samples
the field trilinearly beside the value volume
(``ops/raycast.raycast(..., ao_field=...)``); the slice march renders
`shade_volume_ao`'s pre-shaded volume, the TF and the occlusion baked
into premultiplied RGBA. Off by default (``RenderConfig.ao_strength =
0``)."""

from __future__ import annotations

import torch

from scenery_insitu_tpu_torch.core.transfer import TransferFunction
from scenery_insitu_tpu_torch.core.volume import Volume


def _box_blur_1d(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Edge-clamped box blur of window ``2r + 1`` along ``dim`` by
    cumulative sums (O(1) in the radius)."""
    if r <= 0:
        return x
    n = x.shape[dim]
    lo_edge = x.narrow(dim, 0, 1).expand_as(x.narrow(dim, 0, r))
    hi_edge = x.narrow(dim, n - 1, 1).expand_as(x.narrow(dim, 0, r))
    xp = torch.cat([lo_edge, x, hi_edge], dim=dim)
    c = torch.cumsum(xp, dim=dim)
    c = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c], dim=dim)
    w = 2 * r + 1
    return (c.narrow(dim, w, n) - c.narrow(dim, 0, n)) / w


def occlusion_field(alpha: torch.Tensor, radius: int = 4,
                    strength: float = 0.8,
                    max_occ: float = 0.85) -> torch.Tensor:
    """Occlusion in [0, max_occ] from a per-voxel opacity volume
    ``alpha [D, H, W]``: the mean opacity of its ``(2r+1)^3``
    neighbourhood, scaled by ``strength``."""
    occ = alpha
    for dim in range(3):
        occ = _box_blur_1d(occ, radius, dim)
    return torch.clamp(strength * occ, 0.0, max_occ)


def tf_alpha(vol: Volume, tf: TransferFunction) -> torch.Tensor:
    """Per-voxel opacity of a scalar volume under a transfer function."""
    _, alpha = tf(torch.clamp(vol.data, 0.0, 1.0))
    return alpha


def ao_field_volume(vol: Volume, tf: TransferFunction, radius: int = 4,
                    strength: float = 0.8) -> Volume:
    """The occlusion field as a Volume placed as ``vol`` is: the gather
    raycaster samples it at every step."""
    return Volume(occlusion_field(tf_alpha(vol, tf), radius, strength),
                  vol.origin, vol.spacing)


def shade_volume_ao(vol: Volume, tf: TransferFunction, radius: int = 4,
                    strength: float = 0.8) -> Volume:
    """The premultiplied RGBA volume with the TF and AO baked in
    (``f32[4, D, H, W]``, alpha encoded per nominal step: the pre-shaded
    convention of ``ops/slicer.slice_march``). The slice march renders it
    without a transfer function: ``render_slices(shaded, None, ...)``,
    ``raycast_mxu(shaded, None, ...)``."""
    rgb, alpha = tf(torch.clamp(vol.data, 0.0, 1.0))   # [D,H,W,3], [D,H,W]
    occ = occlusion_field(alpha, radius, strength)
    rgb = rgb * (1.0 - occ)[..., None]
    rgba = torch.cat([(rgb * alpha[..., None]).movedim(-1, 0),
                      alpha[None]], dim=0)
    return Volume(rgba, vol.origin, vol.spacing)
