"""Volumetric Depth Image (VDI) data model: per pixel an ordered list of at
most K supersegments (premultiplied RGBA + a [t_start, t_end] depth
extent). Unused slots hold alpha 0 and depth +inf; live slots are sorted
front to back."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class VDIMetadata(NamedTuple):
    """Everything needed to interpret or re-render a VDI."""

    projection: torch.Tensor   # f32[4, 4]
    view: torch.Tensor         # f32[4, 4]
    model: torch.Tensor        # f32[4, 4] volume model matrix
    volume_dims: torch.Tensor  # f32[3] (x, y, z) voxel counts
    window_dims: torch.Tensor  # i32[2] (width, height)
    nw: torch.Tensor           # f32[] world-space step size
    index: torch.Tensor        # i32[] frame index
    precision: torch.Tensor    # i32[] payload precision code (0 = f32)

    @classmethod
    def create(cls, projection, view, model=None, volume_dims=(0, 0, 0),
               window_dims=(0, 0), nw=0.0, index: int = 0,
               precision: int = 0) -> "VDIMetadata":
        """The device is that of ``projection``."""
        dev = projection.device
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
        i32 = lambda v: torch.as_tensor(v, dtype=torch.int32, device=dev)
        model = torch.eye(4, dtype=torch.float32, device=dev) \
            if model is None else f32(model)
        return cls(f32(projection), f32(view), model, f32(volume_dims),
                   i32(window_dims), f32(nw), i32(index), i32(precision))


class VDI(NamedTuple):
    color: torch.Tensor   # f32[K, 4, H, W] premultiplied RGBA
    depth: torch.Tensor   # f32[K, 2, H, W] (t_start, t_end); +inf if empty


def render_vdi_same_view(vdi: VDI, background: Tuple[float, ...] = (0, 0, 0, 0)
                         ) -> torch.Tensor:
    """Alpha-under all supersegments front to back from the generating
    camera's own view. Returns f32[4, H, W]."""
    order = torch.argsort(vdi.depth[:, 0], dim=0, stable=True)
    color = torch.take_along_dim(vdi.color, order[:, None], dim=0)
    acc = torch.zeros_like(color[0])
    for src in color:
        acc = acc + (1.0 - acc[3:4]) * src
    bg = torch.tensor(background, dtype=torch.float32,
                      device=acc.device).reshape(4, 1, 1)
    return acc + (1.0 - acc[3:4]) * bg


def vdi_nbytes(k: int, height: int, width: int) -> int:
    """Uncompressed payload size (color + depth) in bytes."""
    return k * height * width * (4 + 2) * 4


def to_numpy(vdi: VDI) -> Tuple[np.ndarray, np.ndarray]:
    """The VDI's color and depth as host numpy arrays."""
    return (vdi.color.detach().cpu().numpy(),
            vdi.depth.detach().cpu().numpy())
