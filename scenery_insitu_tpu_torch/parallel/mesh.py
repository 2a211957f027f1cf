"""The rank mesh of the distributed frame, and the halo exchange.

The reference runs the distributed frame under ``shard_map`` over a
device mesh. This port runs it on an in-process N-rank mesh on one
device, the twin of the virtual CPU mesh the reference's tests use: a
"sharded" volume is a rank-stacked tensor ``f32[n, D/n, H, W]`` (rank r
holds z-slab r), a collective is a tensor operation across the rank
axis, and every rank's work runs in turn on the mesh's device.

A process mesh (``parallel/multihost.global_mesh``) spreads the same n
ranks over a fleet of processes, ``n_local`` consecutive ranks a
process: this process holds ranks ``[first_rank, first_rank + n_local)``
as ``f32[n_local, D/n, H, W]`` and its collectives cross processes
through ``torch.distributed``. The in-process mesh is the case of one
process holding every rank.

A mesh is flat (one ``ranks`` axis) or two-level, ``(hosts, ranks)``:
``num_hosts`` domains of ``domain_size`` ranks each
(``parallel/topology.make_topology_mesh``), the emulated hierarchy of
the reference's 2-D mesh. ``n`` is the total rank count either way, and
flat rank ``h * domain_size + d`` (host h, domain position d) holds
z-slab ``h * domain_size + d``, so every volume layout stays
``[n, D/n, H, W]``; only the sort-last composite reads the split
(``parallel/hier.py``).

The render decomposition may differ from the sim's even slabs: a
planned contiguous band a rank (`reslab_z`), a set of equal bricks a
rank (`reslab_bricks`), or the same bricks pooled 2^level-fold
(`reslab_bricks_lod`). Each assembles its rows from the even slabs
through one ladder of global source rows a rank (`_reslab_rows`); on one
device that is one row gather from the global view, where ranks on
several cards would send the rows point to point.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch.device import resolve_device

DEFAULT_AXIS = "ranks"


class Mesh(NamedTuple):
    """A mesh of ``n`` ranks: in-process on one device, flat (one axis
    name), or ``num_hosts`` domains of ``n / num_hosts`` ranks with the
    axis names ``(hosts, ranks)``; or a flat process mesh, this
    process's ``local_ranks`` ranks from global rank ``first_rank`` on
    ``device``, over the process group ``group`` (None: the default
    group)."""

    n: int
    device: torch.device
    axis_names: Tuple[str, ...] = (DEFAULT_AXIS,)
    num_hosts: int = 1
    group: Any = None
    first_rank: int = 0
    local_ranks: int = 0           # 0: every rank, in this process

    @property
    def n_local(self) -> int:
        """The ranks this process holds."""
        return self.local_ranks or self.n

    @property
    def spans_processes(self) -> bool:
        """Whether the ranks are spread over several processes."""
        return self.n_local < self.n

    @property
    def hosts_axis(self) -> Optional[str]:
        """The inter-domain axis of a two-level mesh; None when flat."""
        return self.axis_names[0] if len(self.axis_names) == 2 else None

    @property
    def ranks_axis(self) -> str:
        """The intra-domain (flat: the only) axis."""
        return self.axis_names[-1]

    @property
    def domain_size(self) -> int:
        """Ranks a domain (the whole mesh when flat)."""
        return self.n // self.num_hosts


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
    if mesh.spans_processes:
        raise ValueError("a process mesh takes each process's own slabs "
                         "(multihost.shard_global), not the global volume")
    d = data.shape[0]
    if d % mesh.n:
        raise ValueError(f"volume depth {d} not divisible by mesh size "
                         f"{mesh.n}")
    data = torch.as_tensor(data, device=mesh.device)
    return data.reshape((mesh.n, d // mesh.n) + tuple(data.shape[1:])) \
        .contiguous()


def halo_exchange_z(slabs: torch.Tensor, h: int = 1,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Pad every rank's z-slab with ``h`` neighbour slices on each side:
    ``f32[n, Dn, H, W] -> f32[n, Dn+2h, H, W]``.

    The edge ranks receive clamped copies of their own boundary slice,
    matching single-device clamp-to-edge sampling, so distributed
    trilinear interpolation is seam-exact. ``h`` may not exceed the slab
    depth: a deeper halo would need slices from beyond the neighbour.
    On a process mesh (``mesh``) ``slabs`` is this process's
    ``[n_local, Dn, H, W]``: the seam rows at a process boundary come
    from the neighbouring process (one exchange each way), and the
    clamped copies stay at the global edges."""
    dn = slabs.shape[1]
    if h > dn:
        raise ValueError(
            f"halo depth {h} exceeds the {dn}-slice slab — a neighbor "
            "holds fewer slices than the halo needs (use fewer ranks or a "
            "deeper slab)")
    reps = (1, h) + (1,) * (slabs.dim() - 2)
    lo = slabs[:1, :1].repeat(reps)
    hi = slabs[-1:, -1:].repeat(reps)
    if mesh is not None and mesh.spans_processes:
        from scenery_insitu_tpu_torch.parallel.multihost import (
            neighbour_slices)

        prev, nxt = neighbour_slices(slabs[0, :h], slabs[-1, -h:],
                                     mesh.group)
        lo = lo if prev is None else prev[None]
        hi = hi if nxt is None else nxt[None]
    bottom = torch.cat([lo, slabs[:-1, -h:]])
    top = torch.cat([slabs[1:, :h], hi])
    return torch.cat([bottom, slabs, top], dim=1)


def validate_plan(plan, n: int, h: int = 1,
                  knob: str = "composite.rebalance_min_depth") -> tuple:
    """Static validation of a render z-plan (one band depth per rank).

    The min-slab constraint of a planned decomposition is ``min(plan)``,
    not ``D // n``: the shallowest band must still hold the deepest halo
    any consumer needs. The message names the offending rank and the
    knob that fixes it."""
    plan = tuple(int(p) for p in plan)
    if len(plan) != n:
        raise ValueError(f"render plan has {len(plan)} bands for {n} "
                         f"ranks")
    if min(plan) < max(h, 1):
        r = min(range(n), key=lambda i: plan[i])
        raise ValueError(
            f"render plan band of rank {r} is {plan[r]} slice(s) deep — "
            f"below the {h}-slice halo this step needs (min-slab "
            f"constraint is min(plan), not D//n; raise {knob} to >= {h} "
            f"or use fewer ranks)")
    return plan


def _reslab_rows(slabs: torch.Tensor, g_all, live_all) -> torch.Tensor:
    """Every rank's row set from the even slabs ``[n, Dn, H, W]`` — the
    shared core of `reslab_z` and `reslab_bricks`.

    ``g_all`` int[n, R]: each rank's clamped global source row per
    output row; ``live_all`` bool[n, R]: the rows to fill (dead rows
    stay zero). Both are static numpy, the build's geometry. Returns
    ``[n, R, H, W]`` in the slabs' dtype: one row gather from the global
    ``[n*Dn, H, W]`` view, the dead rows zeroed."""
    n, dn = slabs.shape[:2]
    flat = slabs.reshape((n * dn,) + tuple(slabs.shape[2:]))
    g = torch.as_tensor(np.asarray(g_all, np.int64), device=slabs.device)
    live = torch.as_tensor(np.array(live_all, bool), device=slabs.device)
    out = flat.index_select(0, g.reshape(-1)).reshape(
        tuple(g.shape) + tuple(flat.shape[1:]))
    if not bool(np.asarray(live_all, bool).all()):
        out.masked_fill_(~live.reshape(tuple(live.shape)
                                       + (1,) * (flat.dim() - 1)), 0)
    return out


def reslab_z(slabs: torch.Tensor, plan, h: int = 1) -> torch.Tensor:
    """Every rank's planned render band from the even slabs ``[n, Dn, H,
    W]``: rank r's contiguous global rows ``[start_r - h, start_r +
    plan[r] + h)`` with ``start_r = sum(plan[:r])``, with
    `halo_exchange_z`'s boundary contract (edge halos are clamped copies
    of the global boundary slice).

    Every band pads to ``max(plan) + 2h`` rows, so the chunk layout, the
    occupancy gate and the threshold maps have one shape a rank; rows
    past a rank's own ``plan[r] + 2h`` are zero (the march masks them by
    its ownership bounds, and the gate skips them as dead). Returns
    ``[n, max(plan) + 2h, H, W]``; an even plan reproduces
    ``halo_exchange_z(slabs, h)`` row for row."""
    n, dn = slabs.shape[:2]
    plan = validate_plan(plan, n, h=h)
    d = dn * n
    if sum(plan) != d:
        raise ValueError(f"render plan {plan} covers {sum(plan)} slices "
                         f"but the volume has {d}")
    starts = np.concatenate([[0], np.cumsum(plan)])[:n]
    out_depth = max(plan) + 2 * h
    # clamped global row ladder of every rank's output buffer
    lo = starts - h                                       # may be negative
    g_all = np.clip(lo[:, None] + np.arange(out_depth)[None, :], 0, d - 1)
    live_all = (np.arange(out_depth)[None, :]
                < (np.asarray(plan)[:, None] + 2 * h))    # trailing pad dead
    return _reslab_rows(slabs, g_all, live_all)


def _check_bricks(slabs: torch.Tensor, bmap) -> int:
    """The global depth of ``slabs``, once ``bmap`` fits the mesh and
    the volume."""
    n, dn = slabs.shape[:2]
    if bmap.n_ranks != n:
        raise ValueError(f"brick map built for {bmap.n_ranks} ranks on a "
                         f"{n}-rank mesh")
    d = dn * n
    if bmap.depth != d:
        raise ValueError(f"brick map covers depth {bmap.depth} but the "
                         f"volume has {d} slices")
    return d


def _brick_rows(slabs: torch.Tensor, table: np.ndarray, rows: int,
                halo: int, d: int) -> torch.Tensor:
    """The rows ``[start - halo, start - halo + rows)`` of every slot of
    a start table ``[n, slots]`` (-1 = absent, all zero): ``[n, slots,
    rows, H, W]``."""
    n, slots = table.shape
    ladder = np.arange(rows)[None, None, :] - halo
    g_all = np.clip(table[:, :, None] + ladder, 0, d - 1)
    live_all = np.broadcast_to((table >= 0)[:, :, None], g_all.shape)
    out = _reslab_rows(slabs, g_all.reshape(n, -1), live_all.reshape(n, -1))
    return out.reshape((n, slots, rows) + tuple(slabs.shape[2:]))


def reslab_bricks(slabs: torch.Tensor, bmap, h: int = 1) -> torch.Tensor:
    """Every rank's brick set from the even slabs ``[n, Dn, H, W]``:
    ``bmap`` is a `parallel.bricks.BrickMap`; each of a rank's
    ``bmap.slots`` slots holds one brick's global rows ``[start - h,
    start + bz + h)`` with `halo_exchange_z`'s boundary contract (rows
    clamp only at the global edges; interior brick faces take their true
    neighbours, whichever rank owns them). Absent slots (a rank owning
    fewer bricks than the busiest) are all zero. Returns ``[n, slots, bz
    + 2h, H, W]``."""
    d = _check_bricks(slabs, bmap)
    return _brick_rows(slabs, bmap.start_table(), bmap.brick_depth + 2 * h,
                       h, d)


def reslab_bricks_lod(slabs: torch.Tensor, bmap, h: int = 1) -> dict:
    """The level-aware twin of `reslab_bricks`: ``{level: [n,
    slots_at(level), bz/f + 2h, H/f, W/f]}`` for every level present in
    the map (f = 2^level), pooled after the fine rows are gathered.

    Per level, each slot gathers the fine global rows ``[start - h*f,
    start + bz + h*f)`` (the halo deepens with the level so the pooled
    copy still carries ``h`` coarse halo rows, clamped at the global
    edges as `halo_exchange_z` clamps) and average-pools by ``f`` in all
    three dims in f32, cast back to the input dtype, so a bf16 march
    copy pools without compounding rounding. A coarse voxel tiles
    ``f^3`` fine voxels: the pooled volume keeps the band's corner
    origin with ``spacing * f``. The in-plane extents must divide by
    ``f``; level 0 is `reslab_bricks`' rows bit for bit."""
    d = _check_bricks(slabs, bmap)
    n = slabs.shape[0]
    bz = bmap.brick_depth
    hh, ww = slabs.shape[2], slabs.shape[3]
    out = {}
    for lvl in bmap.levels_present():
        f = 1 << lvl
        if hh % f or ww % f:
            raise ValueError(
                f"brick level {lvl} pools by {f} but the in-plane "
                f"extents ({hh}, {ww}) do not divide — cap "
                f"lod.max_level so 2^level tiles every axis")
        rows_f = bz + 2 * h * f
        fine = _brick_rows(slabs, bmap.start_table_at(lvl), rows_f, h * f,
                           d)
        if f == 1:
            out[lvl] = fine
            continue
        slots = fine.shape[1]
        x = fine.reshape(n, slots, rows_f // f, f, hh // f, f, ww // f, f)
        x = torch.mean(x.to(torch.float32), dim=(3, 5, 7))
        out[lvl] = x.to(slabs.dtype)
    return out
