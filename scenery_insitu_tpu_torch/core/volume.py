"""Volume data model: a scalar field ``f32[D, H, W]`` (indexed
``[z, y, x]``) placed in world space by ``origin`` (the grid's min corner)
and per-axis ``spacing`` (world size of one voxel), both in (x, y, z)
order. Values are normalized to [0, 1]."""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch.device import resolve_device


def _field(data, device) -> torch.Tensor:
    """Tensor on the target device; bf16 is kept (the render copy of the
    memory plan), everything else becomes f32."""
    if isinstance(data, torch.Tensor):
        dev = data.device if device is None else resolve_device(device)
        dtype = torch.bfloat16 if data.dtype == torch.bfloat16 \
            else torch.float32
        return data.to(dev, dtype)
    return torch.as_tensor(np.asarray(data, np.float32),
                           device=resolve_device(device))


class Volume(NamedTuple):
    data: torch.Tensor      # f32[D, H, W]
    origin: torch.Tensor    # f32[3] world position of min corner (x, y, z)
    spacing: torch.Tensor   # f32[3] world size of a voxel (x, y, z)

    @classmethod
    def create(cls, data, origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0),
               device=None) -> "Volume":
        data = _field(data, device)

        def f32(v):
            if isinstance(v, torch.Tensor):
                return v.to(data.device, torch.float32)
            return torch.as_tensor(np.asarray(v, np.float32),
                                   device=data.device)

        return cls(data, f32(origin), f32(spacing))

    @classmethod
    def centered(cls, data, extent: float = 2.0, device=None) -> "Volume":
        """Centered at the world origin with the largest side spanning
        ``extent`` world units. A tensor stays on its own device unless
        ``device`` is given."""
        data = _field(data, device)
        d, h, w = data.shape
        vox = extent / max(d, h, w)
        size = torch.tensor([w * vox, h * vox, d * vox], dtype=torch.float32,
                            device=data.device)
        return cls(data, -size / 2.0,
                   torch.full((3,), vox, dtype=torch.float32,
                              device=data.device))

    @property
    def dims_xyz(self) -> Tuple[int, int, int]:
        d, h, w = self.data.shape[-3:]
        return (w, h, d)

    @property
    def world_min(self) -> torch.Tensor:
        return self.origin

    @property
    def world_max(self) -> torch.Tensor:
        d, h, w = self.data.shape[-3:]
        return self.origin + torch.tensor(
            [w, h, d], dtype=torch.float32,
            device=self.origin.device) * self.spacing

    def world_to_voxel(self, p: torch.Tensor) -> torch.Tensor:
        """World position [..., 3] (x, y, z) -> continuous voxel coords
        [..., 3] (x, y, z), voxel centres at integer + 0.5."""
        return (p - self.origin) / self.spacing


def load_raw(path: str, dims_xyz: Tuple[int, int, int],
             is16bit: bool = False, extent: float = 2.0,
             device=None) -> Volume:
    """Load a raw binary volume file (x fastest, 8- or 16-bit unsigned),
    normalized to [0, 1] and centred as `Volume.centered` places it."""
    dev = resolve_device(device)
    w, h, d = dims_xyz
    dtype = np.uint16 if is16bit else np.uint8
    raw = np.fromfile(path, dtype=dtype, count=w * h * d).reshape(d, h, w)
    data = raw.astype(np.float32) / float(np.iinfo(dtype).max)
    return Volume.centered(data, extent, device=dev)


# Dimensions (x, y, z) of the named datasets, so raw files load by name.
DATASET_DIMS_XYZ = {
    "kingsnake": (1024, 1024, 795),
    "beechnut": (1024, 1024, 1546),
    "simulation": (2048, 2048, 1920),
    "rayleigh_taylor": (1024, 1024, 1024),
    "microscopy": (1024, 1024, 1040),
    "rotstrat": (4096, 4096, 4096),
}


def load_dataset(name: str, data_dir: str, extent: float = 2.0,
                 device=None) -> Volume:
    """A named dataset's 16-bit raw file ``<data_dir>/<name>.raw``."""
    dims = DATASET_DIMS_XYZ[name.lower()]
    path = os.path.join(data_dir, f"{name}.raw")
    return load_raw(path, dims, is16bit=True, extent=extent, device=device)


def procedural_volume(size: int = 128, seed: int = 0, kind: str = "blobs",
                      device=None) -> Volume:
    """Procedural test volume, built with numpy exactly as the reference
    builds it (same seed, same field)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.linspace(-1, 1, size, dtype=np.float32),) * 3,
                          indexing="ij")
    if kind == "blobs":
        field = np.zeros_like(x)
        for _ in range(6):
            c = rng.uniform(-0.6, 0.6, 3).astype(np.float32)
            r = rng.uniform(0.15, 0.4)
            field += np.exp(-(((x - c[0]) ** 2 + (y - c[1]) ** 2
                               + (z - c[2]) ** 2) / (r * r)))
        field /= field.max()
    elif kind == "shell":
        r = np.sqrt(x * x + y * y + z * z)
        field = np.exp(-((r - 0.6) ** 2) / 0.01).astype(np.float32)
    elif kind == "gradient":
        field = (x + 1) / 2
    else:
        raise ValueError(f"unknown procedural volume kind {kind!r}")
    return Volume.centered(field.astype(np.float32), device=device)
