"""Distributed particle rendering: sort-first compositing over the mesh.

The reference's particle mode shards particles by rank, renders each
rank's spheres locally and depth-min composites the full images (on a
head node; here every rank's image and depth on the in-process mesh,
``parallel/mesh.py``). A sharded particle array is rank-stacked,
``[n, N/n, ...]`` (`shard_particles`).

Colouring uses the speed statistics summed over every rank, so the
distributed render matches a single-device render of the full particle
set (the reference's psum'd count, sum and sum of squares become sums
over the ranks in rank order).
"""

from __future__ import annotations

from typing import Optional

import torch

from scenery_insitu_tpu_torch.core.camera import Camera
from scenery_insitu_tpu_torch.ops.composite import composite_depth_min
from scenery_insitu_tpu_torch.ops.splat import (SplatOutput, speed_colors,
                                                splat_particles)
from scenery_insitu_tpu_torch.parallel.mesh import Mesh


def shard_particles(arr: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Place a particle array ``[N, ...]`` on the mesh, sharded over N:
    ``[n, N/n, ...]`` on the mesh's device, rank r holding rows r*N/n
    onward."""
    n = arr.shape[0]
    if n % mesh.n:
        raise ValueError(f"particle count {n} not divisible by mesh size "
                         f"{mesh.n}")
    arr = torch.as_tensor(arr, device=mesh.device)
    return arr.reshape((mesh.n, n // mesh.n) + tuple(arr.shape[1:])) \
        .contiguous()


def _rank_sum(xs):
    """Sum over the ranks in rank order."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


def sort_first_splat(pos: torch.Tensor, vel: torch.Tensor, width: int,
                     height: int, radius, stamp: int = 9,
                     colormap: str = "jet", cam: Optional[Camera] = None,
                     view=None, proj=None) -> SplatOutput:
    """Sort-first particle rendering of the rank-stacked ``pos``, ``vel``
    (``[n, N/n, 3]``): speed colours against the statistics of every
    rank, every rank's splat, then the per-pixel depth-min of the ranks'
    images. Shared by the particle and hybrid steps."""
    speed = [torch.sqrt(torch.sum(v * v, dim=-1)) for v in vel]
    cnt = _rank_sum([torch.tensor(float(s.shape[0]), dtype=torch.float32,
                                  device=s.device) for s in speed])
    s1 = _rank_sum([torch.sum(s) for s in speed])
    s2 = _rank_sum([torch.sum(s * s) for s in speed])
    mean = s1 / cnt
    std = torch.sqrt(torch.clamp(s2 / cnt - mean * mean, min=0.0))
    outs = [splat_particles(p, speed_colors(v, colormap, mean=mean, std=std),
                            radius, cam, width, height, stamp, view=view,
                            proj=proj)
            for p, v in zip(pos, vel)]
    img, dep = composite_depth_min(torch.stack([o.image for o in outs]),
                                   torch.stack([o.depth for o in outs]))
    return SplatOutput(img, dep)


def _check_particles(arr: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if arr.dim() != 3 or arr.shape[0] != mesh.n:
        raise ValueError(f"expected the {mesh.n} rank shards [n, N/n, 3] of "
                         f"shard_particles, got {tuple(arr.shape)}")
    return arr


def distributed_particle_step(mesh: Mesh, width: int, height: int,
                              radius: float = 0.01, stamp: int = 9,
                              colormap: str = "jet"):
    """The distributed particle render step: ``f(pos, vel, cam) ->
    SplatOutput`` (the full-frame image ``[4, H, W]`` and depth ``[H,
    W]``), ``pos`` and ``vel`` the rank shards of `shard_particles`. N
    must divide by the mesh size."""

    def step(pos, vel, cam: Camera) -> SplatOutput:
        return sort_first_splat(_check_particles(pos, mesh),
                                _check_particles(vel, mesh), width, height,
                                radius, stamp, colormap, cam=cam)

    return step
