"""The distributed sort-last VDI frame on the slice march.

Each rank of a mesh (``parallel/mesh.py``) holds one even z-slab of the
volume. A frame runs the reference's chain:

    generate    every rank marches its own slab onto the global
                intermediate grid (one slice ladder and one virtual
                camera for all ranks; halo rows and half-open ownership
                make the march seam-exact when z is an in-plane axis)
      -> exchange   the column all_to_all: rank j receives the j-th
                    column block of every rank's VDI fragment
      -> composite  every rank sorts and resegments its column block
                    (``ops/composite.composite_vdis``, kernel K4 on a
                    card)
      -> the column blocks side by side: the global VDI
         ``[K_out, 4, nj, ni]``, what the reference leaves W-sharded.

On the in-process mesh the ranks run in turn on one device and the
all_to_all is one block transpose of the rank-stacked fragments. The
exchange is ``all_to_all``, the wire ``f32`` and the schedule ``frame``;
the ring exchange, the lossy wires, tile waves, render rebalancing,
bricks, K budgets and fragment reuse are ROADMAP A8b.
"""

from __future__ import annotations

from typing import Optional

import torch

from scenery_insitu_tpu_torch.config import CompositeConfig, VDIConfig
from scenery_insitu_tpu_torch.core.camera import Camera
from scenery_insitu_tpu_torch.core.transfer import TransferFunction
from scenery_insitu_tpu_torch.core.vdi import VDI
from scenery_insitu_tpu_torch.core.volume import Volume
from scenery_insitu_tpu_torch.ops import slicer
from scenery_insitu_tpu_torch.ops import supersegments as ss
from scenery_insitu_tpu_torch.ops.composite import composite_vdis
from scenery_insitu_tpu_torch.parallel.mesh import Mesh, halo_exchange_z
from scenery_insitu_tpu_torch.parallel.topology import resolve_mesh_topology


def _check_sharded(data: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A step's volume argument: the mesh's rank slabs ``[n, Dn, H, W]``
    (`shard_volume`)."""
    if data.dim() != 4 or data.shape[0] != mesh.n:
        raise ValueError(f"expected the {mesh.n} rank slabs [n, D/n, H, W] "
                         f"of shard_volume, got {tuple(data.shape)}")
    return data


def _rank_slab(slabs: torch.Tensor, halo: Optional[torch.Tensor], r: int,
               origin: torch.Tensor, spacing: torch.Tensor,
               spec: slicer.AxisSpec):
    """Rank r's march volume, the global box's max corner, its ownership
    bounds on the in-plane v axis and the global dims (x, y, z).

    A z march (``spec.axis == 2``) marches the rank's own slices: no
    halo, no bounds. An x or y march has z as its v axis: the slab with
    its halo rows (``halo``, from `halo_exchange_z`) for seam-exact
    bilinear, and half-open ownership so every sample belongs to exactly
    one rank; the last rank's bound reaches one slice past the global
    top, which the volume-extent mask still caps."""
    n, dn, h, w = slabs.shape
    dz = spacing[2]
    dims = (w, h, dn * n)
    gmax = origin + torch.tensor(dims, dtype=torch.float32,
                                 device=origin.device) * spacing
    shift = torch.zeros(3, dtype=torch.float32, device=origin.device)
    if spec.axis == 2:
        shift[2] = r * dn * dz
        return Volume(slabs[r], origin + shift, spacing), gmax, None, dims
    shift[2] = (r * dn - 1) * dz
    vol = Volume(halo[r], origin + shift, spacing)
    z_lo = origin[2] + r * dn * dz
    z_hi = origin[2] + (r + 1) * dn * dz
    return vol, gmax, (z_lo, z_hi + dz if r == n - 1 else z_hi), dims


def _exchange_columns(x: torch.Tensor, n: int) -> torch.Tensor:
    """The column all_to_all of rank-stacked fragments ``[n, ..., W]``:
    rank j receives the j-th of n column blocks from every rank. Returns
    ``[n_dst, n_src, ..., W/n]``."""
    w = x.shape[-1]
    parts = x.reshape(x.shape[:-1] + (n, w // n))
    return parts.movedim(-2, 0).contiguous()


def _exchange_vdi_columns(color: torch.Tensor, depth: torch.Tensor,
                          n: int):
    """Column exchange of the rank-stacked VDI fragments ``color [n, K,
    4, H, W]``, ``depth [n, K, 2, H, W]`` on the ``f32`` wire (the only
    one `CompositeConfig` accepts). Returns ``([n_dst, n_src, K, 4, H,
    W/n], [n_dst, n_src, K, 2, H, W/n])``."""
    return _exchange_columns(color, n), _exchange_columns(depth, n)


def _rank_thr(thr: ss.ThresholdState, r: int, nj: int) -> ss.ThresholdState:
    return ss.ThresholdState(*(x[r * nj:(r + 1) * nj] for x in thr))


def _mxu_rank_generate(slabs, halo, r, origin, spacing, cam, spec, tf,
                       vdi_cfg, threshold=None):
    """Rank r's slice-march VDI of its slab. Returns (vdi, meta,
    next_threshold); the last is None unless a threshold state was
    passed (temporal mode). The metadata describes the global volume."""
    vol, gmax, v_bounds, dims = _rank_slab(slabs, halo, r, origin, spacing,
                                           spec)
    if threshold is None:
        vdi, meta, _ = slicer.generate_vdi_mxu(
            vol, tf, cam, spec, vdi_cfg, box_min=origin, box_max=gmax,
            v_bounds=v_bounds)
        thr2 = None
    else:
        vdi, meta, _, thr2 = slicer.generate_vdi_mxu_temporal(
            vol, tf, cam, spec, threshold, vdi_cfg, box_min=origin,
            box_max=gmax, v_bounds=v_bounds)
    meta = meta._replace(volume_dims=torch.tensor(
        dims, dtype=torch.float32, device=origin.device))
    return vdi, meta, thr2


def _halo_for(slabs: torch.Tensor, spec: slicer.AxisSpec):
    """The halo-padded slabs an x or y march reads; None for a z march,
    which needs none."""
    return None if spec.axis == 2 else halo_exchange_z(slabs)


def distributed_vdi_step_mxu(mesh: Mesh, tf: TransferFunction,
                             spec: slicer.AxisSpec,
                             vdi_cfg: Optional[VDIConfig] = None,
                             comp_cfg: Optional[CompositeConfig] = None,
                             topology=None):
    """Distributed sort-last VDI step on the slice march. Returns
    ``f(vol_data, origin, spacing, cam) -> (VDI, meta)``.

    ``vol_data`` is the z-sharded volume (`shard_volume`). ``spec`` is the
    static `slicer.AxisSpec` of the camera regime (``make_spec(...,
    multiple_of=n)``). The VDI is the global ``[K_out, 4|2, nj, ni]``
    on the virtual axis camera's grid; ``meta`` is rank 0's metadata
    with the global volume dims."""
    return _build_mxu_step(mesh, tf, spec, vdi_cfg, comp_cfg,
                           temporal=False, topology=topology)


def distributed_vdi_step_mxu_temporal(mesh: Mesh, tf: TransferFunction,
                                      spec: slicer.AxisSpec,
                                      vdi_cfg: Optional[VDIConfig] = None,
                                      comp_cfg: Optional[CompositeConfig]
                                      = None,
                                      topology=None):
    """`distributed_vdi_step_mxu` with the carried per-rank temporal
    threshold state (``adaptive_mode="temporal"``: one march per rank
    per frame). Returns ``f(vol_data, origin, spacing, cam, thr) ->
    ((VDI, meta), thr')`` where ``thr`` is the rank-stacked
    ``ThresholdState`` (``[n*nj, ni]`` maps) of
    `distributed_initial_threshold_mxu`."""
    return _build_mxu_step(mesh, tf, spec, vdi_cfg, comp_cfg,
                           temporal=True, topology=topology)


def _build_mxu_step(mesh, tf, spec, vdi_cfg, comp_cfg, temporal: bool,
                    topology=None):
    """Shared builder of the step: generate on every rank, column
    exchange, composite of every rank's block, with or without the
    temporal threshold state carried through."""
    vdi_cfg = vdi_cfg or VDIConfig()
    comp_cfg = comp_cfg or CompositeConfig()
    _, n, _ = resolve_mesh_topology(mesh, topology)
    if spec.ni % n:
        raise ValueError(f"intermediate width {spec.ni} not divisible by "
                         f"mesh size {n}")

    def body(data, origin, spacing, cam, thr):
        slabs = _check_sharded(data, mesh)
        halo = _halo_for(slabs, spec)
        ranks = [_mxu_rank_generate(
            slabs, halo, r, origin, spacing, cam, spec, tf, vdi_cfg,
            None if thr is None else _rank_thr(thr, r, spec.nj))
            for r in range(n)]
        colors, depths = _exchange_vdi_columns(
            torch.stack([vdi.color for vdi, _, _ in ranks]),
            torch.stack([vdi.depth for vdi, _, _ in ranks]), n)
        meta = ranks[0][1]
        thr2 = None if thr is None else ss.ThresholdState(
            *(torch.cat(parts) for parts in zip(*(t for _, _, t in ranks))))
        del ranks
        # every rank composites the column block it received
        blocks = [composite_vdis(colors[j], depths[j], comp_cfg)
                  for j in range(n)]
        return VDI(torch.cat([b.color for b in blocks], dim=-1),
                   torch.cat([b.depth for b in blocks], dim=-1)), meta, thr2

    if temporal:
        def step(vol_data, origin, spacing, cam: Camera,
                 thr: ss.ThresholdState):
            out, meta, thr2 = body(vol_data, origin, spacing, cam, thr)
            return (out, meta), thr2
    else:
        def step(vol_data, origin, spacing, cam: Camera):
            out, meta, _ = body(vol_data, origin, spacing, cam, None)
            return out, meta
    return step


def distributed_initial_threshold_mxu(mesh: Mesh, tf: TransferFunction,
                                      spec: slicer.AxisSpec,
                                      vdi_cfg: Optional[VDIConfig] = None):
    """Seeder of `distributed_vdi_step_mxu_temporal`: one histogram
    counting march per rank on its own slab. Returns ``f(vol_data,
    origin, spacing, cam) -> ThresholdState`` with rank-stacked
    ``[n*nj, ni]`` maps."""
    vdi_cfg = vdi_cfg or VDIConfig()
    _, n, _ = resolve_mesh_topology(mesh)

    def seed(vol_data, origin, spacing, cam: Camera) -> ss.ThresholdState:
        slabs = _check_sharded(vol_data, mesh)
        halo = _halo_for(slabs, spec)
        states = []
        for r in range(n):
            vol, gmax, v_bounds, _ = _rank_slab(slabs, halo, r, origin,
                                                spacing, spec)
            states.append(slicer.initial_threshold(
                vol, tf, cam, spec, vdi_cfg, box_min=origin, box_max=gmax,
                v_bounds=v_bounds))
        return ss.ThresholdState(*(torch.cat(parts)
                                   for parts in zip(*states)))

    return seed
