"""VDI depth conventions, interchange layouts and validation.

The system keeps one depth encoding: the world-space ray parameter t of
the generating camera. This module converts at the boundary with
consumers of other conventions:

- `depths_to_ndc` / `depths_from_ndc`: world t <-> NDC z of the
  generating camera, exact per pixel through the metadata's projection
  and view (so also for the slice march's off-axis virtual cameras);
- `pack_reference_layout` / `unpack_reference_layout`: colour rgba32f
  ``[K, H, W, 4]`` and depth r32f ``[2K, H, W]`` with start and end
  interleaved; `pack_3layer` / `unpack_3layer`: one rgba32f texture
  ``[3K, H, W, 4]`` (colour, start, end a supersegment);
- `validate_vdi`: the structural checks as a host-side report;
- the Vulkan frame: the projection fix, gamma, the row flip, and
  `to_reference_frame`, which maps a linear premultiplied image into the
  frame of a Vulkan screenshot.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch.core.camera import _normalize
from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata
from scenery_insitu_tpu_torch.device import resolve_device
from scenery_insitu_tpu_torch.ops.vdi_render import original_eye


def rays_from_metadata(meta: VDIMetadata
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel world rays of the generating camera, rebuilt from the
    metadata's matrices (any projection, the slice march's off-axis
    frusta included): (eye f32[3], unit dirs f32[3, H, W])."""
    wd = meta.window_dims.detach().cpu().numpy()
    w, h = int(wd[0]), int(wd[1])
    dev = meta.view.device
    inv_vp = torch.linalg.inv(meta.projection @ meta.view)
    ndc_x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) \
        / w * 2.0 - 1.0
    ndc_y = 1.0 - (torch.arange(h, dtype=torch.float32, device=dev)
                   + 0.5) / h * 2.0
    gy, gx = torch.meshgrid(ndc_y, ndc_x, indexing="ij")
    ndc = torch.stack([gx, gy, torch.full_like(gx, -1.0),
                       torch.ones_like(gx)])
    pw = torch.einsum("ab,bhw->ahw", inv_vp, ndc)
    near_pt = pw[:3] / pw[3:4]
    eye = original_eye(meta)
    dirs = _normalize(near_pt - eye.reshape(3, 1, 1), dim=0)
    return eye, dirs


def _eye_z_of_dirs(meta: VDIMetadata) -> torch.Tensor:
    """Eye-space z of each unit ray direction (< 0 in front)."""
    _, dirs = rays_from_metadata(meta)
    return torch.einsum("b,bhw->hw", meta.view[2, :3], dirs)


def depths_to_ndc(vdi: VDI, meta: VDIMetadata) -> VDI:
    """World-t depths -> NDC z of the generating camera. Empty slots
    (+inf) stay +inf."""
    p22, p23 = meta.projection[2, 2], meta.projection[2, 3]
    dir_ze = _eye_z_of_dirs(meta)

    def conv(t):                                           # [K, H, W]
        ze = dir_ze[None] * t              # eye-space z, negative in front
        ndc = -(p22 + p23 / torch.where(ze == 0, -1e-20, ze))
        return torch.where(torch.isfinite(t), ndc, torch.inf)

    return VDI(vdi.color, torch.stack([conv(vdi.depth[:, 0]),
                                       conv(vdi.depth[:, 1])], dim=1))


def depths_from_ndc(vdi_ndc: VDI, meta: VDIMetadata) -> VDI:
    """Inverse of `depths_to_ndc`: NDC z -> world ray parameter t."""
    p22, p23 = meta.projection[2, 2], meta.projection[2, 3]
    dir_ze = _eye_z_of_dirs(meta)

    def conv(ndc):
        ze = -p23 / (p22 + ndc)            # eye-space z, negative in front
        t = ze / dir_ze[None]
        return torch.where(torch.isfinite(ndc), t, torch.inf)

    return VDI(vdi_ndc.color, torch.stack([conv(vdi_ndc.depth[:, 0]),
                                           conv(vdi_ndc.depth[:, 1])],
                                          dim=1))


# ------------------------------------------------------ interchange layouts


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pack_reference_layout(vdi: VDI) -> Tuple[np.ndarray, np.ndarray]:
    """VDI -> colour rgba32f ``[K, H, W, 4]`` and depth r32f ``[2K, H,
    W]`` with start and end interleaved a supersegment; empty slots
    zero-filled."""
    color = np.moveaxis(_host(vdi.color), 1, -1)           # [K, H, W, 4]
    depth = _host(vdi.depth)                               # [K, 2, H, W]
    live = np.isfinite(depth[:, 0])
    color = np.where(live[..., None], color, 0.0).astype(np.float32)
    d = np.where(live[:, None], depth, 0.0).astype(np.float32)
    k, _, h, w = d.shape
    return color, d.reshape(2 * k, h, w)


def unpack_reference_layout(color_khw4: np.ndarray, depth_2khw: np.ndarray,
                            device=None) -> VDI:
    """Inverse of `pack_reference_layout`, on ``device`` (default CUDA).
    A slot with zero alpha and no depth extent is empty (depth +inf)."""
    dev = resolve_device(device)
    color = np.moveaxis(np.asarray(color_khw4, np.float32), -1, 1)
    k2, h, w = depth_2khw.shape
    d = np.asarray(depth_2khw, np.float32).reshape(k2 // 2, 2, h, w)
    empty = (np.asarray(color_khw4)[..., 3] <= 0.0) & (d[:, 1] <= d[:, 0])
    d = np.where(empty[:, None], np.inf, d).astype(np.float32)
    return VDI(torch.as_tensor(np.ascontiguousarray(color), device=dev),
               torch.as_tensor(d, device=dev))


def pack_3layer(vdi: VDI) -> np.ndarray:
    """VDI -> one rgba32f texture ``[3K, H, W, 4]``: supersegment k takes
    layers ``3k`` (colour RGBA), ``3k+1`` (start depth in .r) and
    ``3k+2`` (end depth in .r); empty slots zero-filled."""
    color = np.moveaxis(_host(vdi.color), 1, -1)           # [K, H, W, 4]
    depth = _host(vdi.depth)                               # [K, 2, H, W]
    live = np.isfinite(depth[:, 0])
    k, h, w = live.shape
    out = np.zeros((3 * k, h, w, 4), np.float32)
    out[0::3] = np.where(live[..., None], color, 0.0)
    out[1::3, :, :, 0] = np.where(live, depth[:, 0], 0.0)
    out[2::3, :, :, 0] = np.where(live, depth[:, 1], 0.0)
    return out


def unpack_3layer(packed: np.ndarray, device=None) -> VDI:
    """Inverse of `pack_3layer`, on ``device`` (default CUDA); zero-alpha
    slots without depth extent are empty."""
    dev = resolve_device(device)
    color = np.moveaxis(np.asarray(packed[0::3], np.float32), -1, 1)
    start = np.asarray(packed[1::3, :, :, 0], np.float32)
    end = np.asarray(packed[2::3, :, :, 0], np.float32)
    empty = (packed[0::3, :, :, 3] <= 0.0) & (end <= start)
    d = np.stack([start, end], axis=1)
    d = np.where(empty[:, None], np.inf, d).astype(np.float32)
    return VDI(torch.as_tensor(np.ascontiguousarray(color), device=dev),
               torch.as_tensor(d, device=dev))


def render_packed_vdi(packed: np.ndarray,
                      background=(0.0, 0.0, 0.0, 0.0),
                      device=None) -> torch.Tensor:
    """Decode and same-view render of a 3-layer texture: alpha-under of
    its supersegments, on ``device`` (default CUDA)."""
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view

    return render_vdi_same_view(unpack_3layer(packed, device=device),
                                background=background)


# --------------------------------------------------------------- validation


def validate_vdi(vdi: VDI, ndc: bool = False,
                 gap_eps: float = 1e-4) -> Dict[str, int]:
    """Host-side structural checks: each live slot's end >= start,
    consecutive live slots sorted and not overlapping, alpha in [0, 1],
    no empty slot before a live one, and (``ndc``) depths within [-1, 1].
    Returns violation counts (all zero: valid) and ``live_slots``."""
    color = _host(vdi.color)
    depth = _host(vdi.depth)
    start, end = depth[:, 0], depth[:, 1]
    live = np.isfinite(start)
    a = color[:, 3]

    rep: Dict[str, int] = {}
    rep["inverted_extent"] = int(np.sum(live & (end < start)))
    overlap = 0
    unsorted = 0
    for s in range(color.shape[0] - 1):
        both = live[s] & live[s + 1]
        overlap += int(np.sum(both & (start[s + 1] < end[s] - gap_eps)))
        unsorted += int(np.sum(both & (start[s + 1] < start[s])))
    rep["overlapping"] = overlap
    rep["unsorted"] = unsorted
    rep["alpha_out_of_range"] = int(np.sum((a < -1e-6) | (a > 1.0 + 1e-6)))
    rep["dead_slot_after_live"] = int(np.sum(~live[:-1] & live[1:]))
    if ndc:
        rep["ndc_out_of_range"] = int(np.sum(
            live & ((start < -1.0 - 1e-4) | (end > 1.0 + 1e-4))))
    rep["live_slots"] = int(np.sum(live))
    return rep


# -------------------------------------------- the Vulkan reference frame


def vulkan_projection_fix() -> np.ndarray:
    """The GL -> Vulkan clip-space correction: Vulkan's NDC y points down
    and its depth range is [0, 1] where GL's is [-1, 1]. ``P_vk = fix @
    P_gl``: y' = -y, z' = (z + w) / 2."""
    return np.array([[1.0, 0.0, 0.0, 0.0],
                     [0.0, -1.0, 0.0, 0.0],
                     [0.0, 0.0, 0.5, 0.5],
                     [0.0, 0.0, 0.0, 1.0]], np.float32)


def projection_gl_to_vulkan(proj: torch.Tensor) -> torch.Tensor:
    """A GL-convention projection (what `core/camera` builds and every
    VDI's metadata carries) -> the Vulkan-convention one."""
    return torch.as_tensor(vulkan_projection_fix(),
                           device=proj.device) @ proj


def projection_vulkan_to_gl(proj_vk: torch.Tensor) -> torch.Tensor:
    """Inverse of `projection_gl_to_vulkan`, for matrices read from
    Vulkan-convention dumps."""
    return torch.as_tensor(np.linalg.inv(vulkan_projection_fix()),
                           device=proj_vk.device) @ proj_vk


def gamma_encode(image: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Write-time gamma on rgb (``v^(1/gamma)``); alpha stays linear.
    Channel-first ``[..., 4, H, W]``."""
    rgb = torch.pow(torch.clamp(image[..., :3, :, :], 0.0, 1.0),
                    1.0 / gamma)
    return torch.cat([rgb, image[..., 3:4, :, :]], dim=-3)


def gamma_decode(image: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Inverse of `gamma_encode`."""
    rgb = torch.pow(torch.clamp(image[..., :3, :, :], 0.0, 1.0), gamma)
    return torch.cat([rgb, image[..., 3:4, :, :]], dim=-3)


def flip_y(image: torch.Tensor) -> torch.Tensor:
    """Row flip between top-down pixel rows and a bottom-up
    framebuffer."""
    return torch.flip(image, dims=(-2,))


def to_reference_frame(image: torch.Tensor, gamma: float = 2.2,
                       flip: bool = True) -> torch.Tensor:
    """Linear premultiplied ``[4, H, W]`` (row 0 at the top) -> the frame
    of a Vulkan screenshot: gamma-encoded rgb, bottom-up rows."""
    out = gamma_encode(image, gamma)
    return flip_y(out) if flip else out
