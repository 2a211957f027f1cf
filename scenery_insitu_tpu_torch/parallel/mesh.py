"""The rank mesh of the distributed frame, and the halo exchange.

The reference runs the distributed frame under ``shard_map`` over a
device mesh. This port runs it on an in-process N-rank mesh on one
device, the twin of the virtual CPU mesh the reference's tests use: a
"sharded" volume is a rank-stacked tensor ``f32[n, D/n, H, W]`` (rank r
holds z-slab r), a collective is a tensor operation across the rank
axis, and every rank's work runs in turn on the mesh's device. A mesh
spread over several cards, one process a card, is ROADMAP A8b item 9.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from scenery_insitu_tpu_torch.device import resolve_device

DEFAULT_AXIS = "ranks"


class Mesh(NamedTuple):
    """An in-process mesh of ``n`` ranks on one device."""

    n: int
    device: torch.device
    axis_names: Tuple[str, ...] = (DEFAULT_AXIS,)


def make_mesh(n: int = 1, device=None,
              axis_name: str = DEFAULT_AXIS) -> Mesh:
    """1-D mesh of ``n`` ranks over the compositing axis ``axis_name``.
    Its ranks run in-process on ``device`` (None means CUDA and raises
    without a card); the default of one rank is the reference's default
    mesh on a one-card host."""
    if n < 1:
        raise ValueError(f"a mesh holds at least one rank, got n={n}")
    return Mesh(int(n), resolve_device(device), (axis_name,))


def shard_volume(data: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Place a global volume ``f32[D, H, W]`` on the mesh, z-sharded:
    ``f32[n, D/n, H, W]`` on the mesh's device, rank r holding slab r."""
    d = data.shape[0]
    if d % mesh.n:
        raise ValueError(f"volume depth {d} not divisible by mesh size "
                         f"{mesh.n}")
    data = torch.as_tensor(data, device=mesh.device)
    return data.reshape((mesh.n, d // mesh.n) + tuple(data.shape[1:])) \
        .contiguous()


def halo_exchange_z(slabs: torch.Tensor, h: int = 1) -> torch.Tensor:
    """Pad every rank's z-slab with ``h`` neighbour slices on each side:
    ``f32[n, Dn, H, W] -> f32[n, Dn+2h, H, W]``.

    The edge ranks receive clamped copies of their own boundary slice,
    matching single-device clamp-to-edge sampling, so distributed
    trilinear interpolation is seam-exact. ``h`` may not exceed the slab
    depth: a deeper halo would need slices from beyond the neighbour."""
    dn = slabs.shape[1]
    if h > dn:
        raise ValueError(
            f"halo depth {h} exceeds the {dn}-slice slab — a neighbor "
            "holds fewer slices than the halo needs (use fewer ranks or a "
            "deeper slab)")
    reps = (1, h) + (1,) * (slabs.dim() - 2)
    bottom = torch.cat([slabs[:1, :1].repeat(reps), slabs[:-1, -h:]])
    top = torch.cat([slabs[1:, :h], slabs[-1:, -1:].repeat(reps)])
    return torch.cat([bottom, slabs, top], dim=1)
