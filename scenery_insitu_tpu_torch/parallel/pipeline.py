"""The distributed sort-last VDI frame on the slice march.

Each rank of a mesh (``parallel/mesh.py``) holds one even z-slab of the
volume. A frame runs the reference's chain:

    generate    every rank marches its own slab onto the global
                intermediate grid (one slice ladder and one virtual
                camera for all ranks; halo rows and half-open ownership
                make the march seam-exact when z is an in-plane axis)
      -> exchange   rank j receives the j-th column block of every
                    rank's VDI fragment
      -> composite  every rank folds its column block into K_out
                    supersegments (``ops/composite.resegment_stream``,
                    kernel K4 on a card)
      -> the column blocks side by side: the global VDI
         ``[K_out, 4, nj, ni]``, what the reference leaves W-sharded.

Three settings of ``CompositeConfig`` shape the exchange, as in the
reference:

``exchange``  ``"all_to_all"``: every rank receives all n column blocks
              at once and sorts the N·K slots of a pixel
              (``composite_vdis``). ``"ring"``: every rank sorts its own
              K-fragment, keeps its own block, and at hop s = 1..n-1
              rank r merges rank (r+s)'s block into a sorted accumulator
              (``merge_vdis_pairwise``, ties to the accumulator), capped
              at ``ring_slots`` when that is set; one resegment of the
              accumulator follows. One rank takes the all_to_all path.
``wire``      the encoding the exchange ships (``ops/wire.py``): ``f32``,
              ``bf16`` or ``qpack8``. A fragment is encoded once, each
              block decoded against its sender's scale; in the ring the
              own block goes through the codec too.
``schedule``  ``"frame"``: one march, one exchange and one composite.
              ``"waves"``: the column block is the unit: every rank
              marches one wave of ``wave_tiles`` column tiles at a time
              (``slicer.wave_camera``; the frame's permuted copy and
              occupancy gate are shared by its waves), and every wave is
              exchanged and composited as above. The temporal threshold
              maps are sliced to each wave and scattered back. One rank
              degrades to ``"frame"`` on the ledger.

On the in-process mesh the ranks run in turn on one device: the
all_to_all is one block transpose of the rank-stacked fragments, the
ring's hops run one after another with each rank merging in the
reference's order, and the waves run in turn in the order of the
reference's pipelined scan (march wave 0; then composite wave w-1 and
march wave w; then composite the last wave), without its overlap. The
render rebalancing, bricks and LOD (A8b item 4), the two-level topology
(item 5) and K budgets and fragment reuse (item 6) are still to come.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from scenery_insitu_tpu_torch import obs as _obs
from scenery_insitu_tpu_torch.config import CompositeConfig, VDIConfig
from scenery_insitu_tpu_torch.core.camera import Camera
from scenery_insitu_tpu_torch.core.transfer import TransferFunction
from scenery_insitu_tpu_torch.core.vdi import VDI
from scenery_insitu_tpu_torch.core.volume import Volume
from scenery_insitu_tpu_torch.ops import slicer
from scenery_insitu_tpu_torch.ops import supersegments as ss
from scenery_insitu_tpu_torch.ops import wire as _wire
from scenery_insitu_tpu_torch.ops.composite import (
    composite_vdis, merge_vdis_pairwise, modeled_exchange_traffic,
    resegment_stream, sort_stream)
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


# -------------------------------------------------------------- exchange


def _column_blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    """One rank's fragment ``[..., W]`` split into its n column blocks:
    ``[n, ..., W/n]``, block j the columns rank j composites."""
    w = x.shape[-1]
    return x.reshape(x.shape[:-1] + (n, w // n)).movedim(-2, 0)


def _exchange_columns(x: torch.Tensor, n: int) -> torch.Tensor:
    """The column all_to_all of rank-stacked fragments ``[n, ..., W]``:
    rank j receives the j-th of n column blocks from every rank. Returns
    ``[n_dst, n_src, ..., W/n]``."""
    w = x.shape[-1]
    parts = x.reshape(x.shape[:-1] + (n, w // n))
    return parts.movedim(-2, 0).contiguous()


def _encode_ranks(color: torch.Tensor, depth: torch.Tensor, wire: str):
    """Every rank's fragment of the rank-stacked ``color [n, K, 4, H,
    W]``, ``depth [n, K, 2, H, W]`` encoded for ``wire``, each against
    its own scale. Returns (color_enc [n, ...], depth_enc [n, ...],
    scales f32[n, 2] or None)."""
    enc = [_wire.encode_fragment(c, d, wire) for c, d in zip(color, depth)]
    scales = None if enc[0][2] is None else \
        torch.stack([e[2] for e in enc])
    return (torch.stack([e[0] for e in enc]),
            torch.stack([e[1] for e in enc]), scales)


def _exchange_vdi_columns(color: torch.Tensor, depth: torch.Tensor,
                          n: int, wire: str = "f32"):
    """Column all_to_all of the rank-stacked VDI fragments ``color [n, K,
    4, H, W]``, ``depth [n, K, 2, H, W]`` on ``wire``: every fragment is
    encoded, the encoded blocks exchanged, and each received block
    decoded against its sender's scale. ``f32`` is the plain exchange.
    Returns f32 ``([n_dst, n_src, K, 4, H, W/n], [n_dst, n_src, K, 2, H,
    W/n])``."""
    if wire == "f32":
        return _exchange_columns(color, n), _exchange_columns(depth, n)
    ec, ed, scales = _encode_ranks(color, depth, wire)
    rc, rd = _exchange_columns(ec, n), _exchange_columns(ed, n)
    # every destination decodes source s against scales[s]
    return _wire.decode_fragment(rc, rd, None if scales is None
                                 else scales[None], wire)


def _ring_cap(cfg: CompositeConfig, k: int) -> Optional[int]:
    """Validated accumulator cap of a ring merge (None = lossless):
    ring_slots must at least hold one incoming fragment."""
    cap = int(cfg.ring_slots) or None
    if cap is not None and cap < k:
        raise ValueError(
            f"ring_slots={cap} is below the per-rank fragment size K={k} "
            f"— the accumulator could not even hold one incoming fragment "
            f"(use 0 for lossless, or >= K, e.g. 2*K)")
    return cap


def _ring_blocks(color: torch.Tensor, depth: torch.Tensor, n: int,
                 wire: str):
    """The ring's send side: every rank sorts its own K-fragment (the
    merge's sorted-input precondition), encodes it once for ``wire`` and
    splits it into its n column blocks. Returns per rank (color blocks
    [n, K, ...], depth blocks, scale or None)."""
    out = []
    for c, d in zip(color, depth):
        c, d = sort_stream(c, d)
        ec, ed, scale = _wire.encode_fragment(c, d, wire)
        out.append((_column_blocks(ec, n), _column_blocks(ed, n), scale))
    return out


def _ring_accumulate(blocks, r: int, wire: str, cap: Optional[int]):
    """Rank r's ring: its own block through the codec, then at hop
    s = 1..n-1 the block of rank (r+s) mod n decoded and merged into the
    sorted accumulator (arrival order r, r+1, ... with wrap-around; ties
    go to the accumulator). Returns the accumulator (color [M, 4, H,
    W/n], depth [M, 2, H, W/n]), not yet resegmented."""
    n = len(blocks)
    bc, bd, scale = blocks[r]
    acc_c, acc_d = _wire.decode_fragment(bc[r], bd[r], scale, wire)
    for s in range(1, n):
        bc, bd, scale = blocks[(r + s) % n]
        mc, md = _wire.decode_fragment(bc[r], bd[r], scale, wire)
        acc_c, acc_d = merge_vdis_pairwise(acc_c, acc_d, mc, md, k_cap=cap)
    return acc_c, acc_d


def _ring_exchange_composite(color: torch.Tensor, depth: torch.Tensor,
                             n: int, cfg: CompositeConfig,
                             gap_eps: float = 1e-4) -> List[VDI]:
    """The ring exchange and composite of the rank-stacked fragments:
    every rank's accumulator resegmented once by the all_to_all path's
    fold, so the lossless ring equals the all_to_all composite (up to
    the order of bit-identical start depths, which follows arrival
    order)."""
    cap = _ring_cap(cfg, color.shape[1])
    blocks = _ring_blocks(color, depth, n, cfg.wire)
    return [resegment_stream(*_ring_accumulate(blocks, r, cfg.wire, cap),
                             cfg, gap_eps) for r in range(n)]


def _composite_exchanged(color: torch.Tensor, depth: torch.Tensor, n: int,
                         cfg: CompositeConfig) -> List[VDI]:
    """Exchange and composite of the rank-stacked fragments under
    ``cfg.exchange`` and ``cfg.wire``: every rank's composited column
    block, in rank order. One rank takes the all_to_all path."""
    if cfg.exchange == "ring" and n > 1:
        return _ring_exchange_composite(color, depth, n, cfg)
    rc, rd = _exchange_vdi_columns(color, depth, n, cfg.wire)
    return [composite_vdis(rc[j], rd[j], cfg) for j in range(n)]


# -------------------------------------------------------- build markers


def _ring_build_marker(n: int, k: int, h: int, w: int,
                       cfg: CompositeConfig) -> None:
    """One ring exchange built: the counters and events of the
    reference's build, with the modeled traffic of a fragment ``[K, .,
    h, w]`` and one event a hop."""
    rec = _obs.get_recorder()
    cap = _ring_cap(cfg, k)
    rec.count("ring_exchange_builds")
    rec.event("ring_exchange_build", ranks=n, k=k, slots=(cap or n * k),
              wire=cfg.wire,
              traffic=modeled_exchange_traffic(
                  n, k, h, w, k_out=cfg.max_output_supersegments,
                  mode="ring", ring_slots=cfg.ring_slots, wire=cfg.wire))
    cb, db = _wire.wire_slot_bytes(cfg.wire)
    frag_bytes = k * h * (w // n) * (cb + db)
    for s in range(1, n):
        rec.count("ring_steps_built")
        rec.event("ring_step", step=s, hops=s, frag_bytes=frag_bytes,
                  wire=cfg.wire)


def _wire_build_marker(wire: str) -> None:
    """One wire encode built (a lossy wire only)."""
    cb, db = _wire.wire_slot_bytes(wire)
    rec = _obs.get_recorder()
    rec.count("wire_encode_builds")
    rec.event("wire_encode", wire=wire, bytes_per_slot=cb + db)


def _wave_build_marker(n: int, t: int, k: int, h: int, w: int,
                       cfg: CompositeConfig) -> None:
    """One wave schedule built: its counters (the build and its T waves)
    and one event with the modeled overlap accounting."""
    rec = _obs.get_recorder()
    rec.count("wave_schedule_builds")
    rec.count("wave_steps_built", t)
    rec.event("wave_schedule_build", ranks=n, tiles=t, k=k,
              wave_cols=w // t, tile_cols=w // (n * t), march_per_wave=True,
              traffic=modeled_exchange_traffic(
                  n, k, h, w, k_out=cfg.max_output_supersegments,
                  mode=cfg.exchange, ring_slots=cfg.ring_slots,
                  wire=cfg.wire, schedule="waves", wave_tiles=t))


def _resolve_waves(cfg: CompositeConfig, n: int, width: int) -> bool:
    """Build-time resolution of ``cfg.schedule``: True runs tile waves
    (the width must split into n * wave_tiles blocks), False the frame
    schedule. A waves request on one rank goes on the ledger."""
    if cfg.schedule != "waves":
        return False
    if n == 1:
        _obs.degrade("composite.schedule", "waves", "frame",
                     "single-rank mesh has no exchange to pipeline",
                     warn=False)
        return False
    slicer.wave_block(width, n, cfg.wave_tiles)
    return True


# ------------------------------------------------------------ generation


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


class _RankFrame:
    """Rank r's per-frame state shared by its tile waves: its volume,
    ownership bounds, the virtual camera, the one permuted copy and the
    one occupancy gate."""

    def __init__(self, slabs, halo, r, origin, spacing, cam, spec, tf):
        self.vol, gmax, self.v_bounds, self.dims = _rank_slab(
            slabs, halo, r, origin, spacing, spec)
        self.axcam = slicer.make_axis_camera(self.vol, cam, spec,
                                             box_min=origin, box_max=gmax)
        self.volp = slicer.permute_volume(self.vol, spec)
        self.occ = slicer.occupancy_for(self.vol, tf, spec, volp=self.volp)


def _march_wave(frames, w: int, n: int, t: int, cam, spec, tf, vdi_cfg,
                thr_full):
    """Every rank's march of tile wave ``w`` on its shared frame state.
    ``thr_full`` (temporal mode; else None) holds each rank's full-frame
    threshold maps: the wave's columns are sliced out and the
    controller's update scattered back in place of the list entry.
    Returns the rank-stacked wave fragments (color, depth)."""
    colors, depths = [], []
    for r, fr in enumerate(frames):
        axcam_w, spec_w = slicer.wave_camera(fr.axcam, spec, n, t, w)
        kw = dict(v_bounds=fr.v_bounds, occupancy=fr.occ, axcam=axcam_w,
                  volp=fr.volp)
        if thr_full is None:
            vdi, _, _ = slicer.generate_vdi_mxu(fr.vol, tf, cam, spec_w,
                                                vdi_cfg, **kw)
        else:
            thr_w = ss.ThresholdState(*(slicer.wave_cols(m, n, t, w)
                                        for m in thr_full[r]))
            vdi, _, _, thr2w = slicer.generate_vdi_mxu_temporal(
                fr.vol, tf, cam, spec_w, thr_w, vdi_cfg, **kw)
            thr_full[r] = ss.ThresholdState(*(
                slicer.wave_update_cols(m, mw, n, t, w)
                for m, mw in zip(thr_full[r], thr2w)))
        colors.append(vdi.color)
        depths.append(vdi.depth)
    return torch.stack(colors), torch.stack(depths)


def _waves_frame(slabs, halo, origin, spacing, cam, spec, tf, vdi_cfg,
                 comp_cfg, n, thr):
    """The tile-wave frame: per rank one shared frame state, then the
    reference's pipeline order (march wave 0; composite wave w-1, march
    wave w; composite the last wave), each wave's fragments exchanged
    and composited by `_composite_exchanged`. Returns (VDI, meta,
    thr')."""
    t = comp_cfg.wave_tiles
    frames = [_RankFrame(slabs, halo, r, origin, spacing, cam, spec, tf)
              for r in range(n)]
    thr_full = None if thr is None else \
        [_rank_thr(thr, r, spec.nj) for r in range(n)]
    outs = []                       # per wave: every rank's block
    frag = _march_wave(frames, 0, n, t, cam, spec, tf, vdi_cfg, thr_full)
    for w in range(1, t):
        outs.append(_composite_exchanged(*frag, n, comp_cfg))
        frag = _march_wave(frames, w, n, t, cam, spec, tf, vdi_cfg,
                           thr_full)
    outs.append(_composite_exchanged(*frag, n, comp_cfg))
    del frag
    # rank j's contiguous block is its wave tiles side by side
    color = torch.cat([o[j].color for j in range(n) for o in outs], dim=-1)
    depth = torch.cat([o[j].depth for j in range(n) for o in outs], dim=-1)
    fr0 = frames[0]
    meta = slicer._vdi_meta(fr0.vol, fr0.axcam, spec.ni, spec.nj)._replace(
        volume_dims=torch.tensor(fr0.dims, dtype=torch.float32,
                                 device=origin.device))
    thr2 = None if thr is None else ss.ThresholdState(
        *(torch.cat(parts) for parts in zip(*thr_full)))
    return VDI(color, depth), meta, thr2


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
    with the global volume dims. ``comp_cfg`` picks the exchange, the
    wire and the schedule (see the module docstring)."""
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
    """The step both entries build: generate on every rank, exchange and
    composite under ``comp_cfg``, with or without the temporal threshold
    state carried through. The build's counters and events (ring, wire,
    waves) are recorded here, once a step as the reference records them
    once a compile."""
    vdi_cfg = vdi_cfg or VDIConfig()
    comp_cfg = comp_cfg or CompositeConfig()
    _, n, _ = resolve_mesh_topology(mesh, topology)
    if spec.ni % n:
        raise ValueError(f"intermediate width {spec.ni} not divisible by "
                         f"mesh size {n}")
    waves = _resolve_waves(comp_cfg, n, spec.ni)
    k = vdi_cfg.max_supersegments
    if waves:
        _wave_build_marker(n, comp_cfg.wave_tiles, k, spec.nj, spec.ni,
                           comp_cfg)
    if comp_cfg.exchange == "ring" and n > 1:
        _ring_build_marker(n, k, spec.nj,
                           spec.ni // (comp_cfg.wave_tiles if waves else 1),
                           comp_cfg)
    if comp_cfg.wire != "f32":
        _wire_build_marker(comp_cfg.wire)

    def body(data, origin, spacing, cam, thr):
        slabs = _check_sharded(data, mesh)
        halo = _halo_for(slabs, spec)
        if waves:
            return _waves_frame(slabs, halo, origin, spacing, cam, spec, tf,
                                vdi_cfg, comp_cfg, n, thr)
        ranks = [_mxu_rank_generate(
            slabs, halo, r, origin, spacing, cam, spec, tf, vdi_cfg,
            None if thr is None else _rank_thr(thr, r, spec.nj))
            for r in range(n)]
        color = torch.stack([vdi.color for vdi, _, _ in ranks])
        depth = torch.stack([vdi.depth for vdi, _, _ in ranks])
        meta = ranks[0][1]
        thr2 = None if thr is None else ss.ThresholdState(
            *(torch.cat(parts) for parts in zip(*(t for _, _, t in ranks))))
        del ranks
        blocks = _composite_exchanged(color, depth, n, comp_cfg)
        del color, depth
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
    counting march per rank on its own slab (the whole frame, whatever
    the schedule). Returns ``f(vol_data, origin, spacing, cam) ->
    ThresholdState`` with rank-stacked ``[n*nj, ni]`` maps."""
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
