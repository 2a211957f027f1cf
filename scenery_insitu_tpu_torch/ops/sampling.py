"""Volume sampling: trilinear sampling at world positions, the ray/box
intersection, opacity correction and the nominal step."""

from __future__ import annotations

import torch


def sample_trilinear(data: torch.Tensor, pos_xyz: torch.Tensor
                     ) -> torch.Tensor:
    """Trilinearly sample ``data [D, H, W]`` at continuous voxel
    coordinates ``pos_xyz f32[..., 3]`` (x, y, z; voxel centres at
    integer + 0.5), clamped to the border (clamp-to-edge). The eight
    corners are gathered in the storage dtype (a bf16 render copy keeps
    its halved traffic) and the lerp accumulates in f32. Flat indices
    are int64: ``(z*h + y)*w + x`` passes 2^31 at 1024^3."""
    d, h, w = data.shape
    p = pos_xyz - 0.5
    x = torch.clamp(p[..., 0], 0.0, w - 1.0)
    y = torch.clamp(p[..., 1], 0.0, h - 1.0)
    z = torch.clamp(p[..., 2], 0.0, d - 1.0)

    def corner(c, n):
        if n == 1:
            return torch.zeros_like(c, dtype=torch.int64)
        return torch.clamp(torch.floor(c).to(torch.int64), 0, n - 2)

    x0, y0, z0 = corner(x, w), corner(y, h), corner(z, d)
    fx, fy, fz = x - x0, y - y0, z - z0
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    z1 = torch.clamp(z0 + 1, max=d - 1)
    flat = data.reshape(-1)

    def at(zi, yi, xi):
        return flat[(zi * h + yi) * w + xi].to(torch.float32)

    c00 = at(z0, y0, x0) * (1 - fx) + at(z0, y0, x1) * fx
    c01 = at(z0, y1, x0) * (1 - fx) + at(z0, y1, x1) * fx
    c10 = at(z1, y0, x0) * (1 - fx) + at(z1, y0, x1) * fx
    c11 = at(z1, y1, x0) * (1 - fx) + at(z1, y1, x1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def sample_volume_world(vol, world_pos: torch.Tensor) -> torch.Tensor:
    """Sample a Volume at world positions ``f32[..., 3]`` (x, y, z)."""
    return sample_trilinear(vol.data, vol.world_to_voxel(world_pos))


def intersect_aabb(origin: torch.Tensor, dirs: torch.Tensor,
                   box_min: torch.Tensor, box_max: torch.Tensor):
    """Slab-method ray/box intersection. ``origin f32[3]``, ``dirs
    f32[3, ...]``; returns (tnear, tfar), each ``f32[...]``, tnear
    clamped to >= 0; a miss gives tnear > tfar. Components below 1e-12
    in magnitude are replaced by +-1e-12 before the division."""
    tiny = torch.where(dirs < 0, -1e-12, 1e-12)
    inv = 1.0 / torch.where(torch.abs(dirs) < 1e-12, tiny, dirs)
    shape = (3,) + (1,) * (dirs.dim() - 1)
    o = origin.reshape(shape)
    t0 = (box_min.reshape(shape) - o) * inv
    t1 = (box_max.reshape(shape) - o) * inv
    tnear = torch.amax(torch.minimum(t0, t1), dim=0)
    tfar = torch.amin(torch.maximum(t0, t1), dim=0)
    return torch.clamp(tnear, min=0.0), tfar


def adjust_opacity(alpha: torch.Tensor, length_ratio) -> torch.Tensor:
    """Opacity correction for a sampling interval whose length differs from
    the nominal one: ``1 - (1 - a)^ratio``."""
    return 1.0 - torch.pow(torch.clamp(1.0 - alpha, 1e-7, 1.0), length_ratio)


def nominal_step(vol, scale: float = 1.0) -> torch.Tensor:
    """World-space nominal sampling distance: one (min-axis) voxel times
    ``scale``."""
    return torch.amin(vol.spacing) * scale
