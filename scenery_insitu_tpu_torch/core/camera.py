"""Camera model: right-handed OpenGL camera (looks down -z in eye space),
NDC z in [-1, 1], image row 0 at the top. Depths are the world-space ray
parameter ``t``, not NDC z."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scenery_insitu_tpu_torch.device import resolve_device


class Camera(NamedTuple):
    """Pinhole camera; every field is an f32 tensor on one device."""

    eye: torch.Tensor       # f32[3] world-space position
    target: torch.Tensor    # f32[3] look-at point
    up: torch.Tensor        # f32[3]
    fov_y: torch.Tensor     # f32[] vertical field of view, radians
    near: torch.Tensor      # f32[]
    far: torch.Tensor       # f32[]

    @classmethod
    def create(cls, eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
               fov_y_deg: float = 50.0, near: float = 0.1,
               far: float = 1000.0, device=None) -> "Camera":
        """A tensor ``eye`` keeps its device unless ``device`` is given."""
        if isinstance(eye, torch.Tensor) and device is None:
            dev = eye.device
        else:
            dev = resolve_device(device)

        def f32(v):
            if isinstance(v, torch.Tensor):
                return v.to(dev, torch.float32)
            return torch.as_tensor(np.asarray(v, np.float32), device=dev)

        return cls(f32(eye), f32(target), f32(up),
                   torch.deg2rad(f32(fov_y_deg)), f32(near), f32(far))


def _normalize(v: torch.Tensor, dim: int = -1,
               eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=dim, keepdim=True),
                           min=eps)


def look_at(eye: torch.Tensor, target: torch.Tensor,
            up: torch.Tensor) -> torch.Tensor:
    """World -> eye 4x4 view matrix (OpenGL convention)."""
    fwd = _normalize(target - eye)
    right = _normalize(torch.linalg.cross(fwd, up))
    true_up = torch.linalg.cross(right, fwd)
    rot = torch.stack([right, true_up, -fwd])             # rows
    trans = -rot @ eye
    view = torch.eye(4, dtype=torch.float32, device=eye.device)
    view[:3, :3] = rot
    view[:3, 3] = trans
    return view


def perspective(fov_y: torch.Tensor, aspect: float, near,
                far) -> torch.Tensor:
    """OpenGL perspective projection, NDC z in [-1, 1]."""
    f = 1.0 / torch.tan(fov_y / 2.0)
    near = torch.as_tensor(near, dtype=torch.float32, device=fov_y.device)
    far = torch.as_tensor(far, dtype=torch.float32, device=fov_y.device)
    proj = torch.zeros((4, 4), dtype=torch.float32, device=fov_y.device)
    proj[0, 0] = f / aspect
    proj[1, 1] = f
    proj[2, 2] = (far + near) / (near - far)
    proj[2, 3] = 2.0 * far * near / (near - far)
    proj[3, 2] = -1.0
    return proj


def frustum(l, r, b, t, n, f) -> torch.Tensor:
    """Off-axis (glFrustum-style) projection from the near-plane window
    [l, r] x [b, t]; NDC z in [-1, 1]. Arguments are f32 scalar tensors."""
    zero = torch.zeros_like(n)
    row0 = torch.stack([2 * n / (r - l), zero, (r + l) / (r - l), zero])
    row1 = torch.stack([zero, 2 * n / (t - b), (t + b) / (t - b), zero])
    row2 = torch.stack([zero, zero, (f + n) / (n - f), 2 * f * n / (n - f)])
    row3 = torch.stack([zero, zero, -torch.ones_like(n), zero])
    return torch.stack([row0, row1, row2, row3])


def view_matrix(cam: Camera) -> torch.Tensor:
    return look_at(cam.eye, cam.target, cam.up)


def projection_matrix(cam: Camera, width: int, height: int) -> torch.Tensor:
    return perspective(cam.fov_y, width / height, cam.near, cam.far)


def orbit(cam: Camera, yaw, pitch=0.0) -> Camera:
    """Rotate the eye around the target."""
    dev = cam.eye.device
    yaw = torch.as_tensor(yaw, dtype=torch.float32, device=dev)
    pitch = torch.as_tensor(pitch, dtype=torch.float32, device=dev)
    rel = cam.eye - cam.target
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    rel = torch.stack([cy * rel[0] + sy * rel[2], rel[1],
                       -sy * rel[0] + cy * rel[2]])
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    rel = torch.stack([rel[0], cp * rel[1] - sp * rel[2],
                       sp * rel[1] + cp * rel[2]])
    return cam._replace(eye=cam.target + rel)
