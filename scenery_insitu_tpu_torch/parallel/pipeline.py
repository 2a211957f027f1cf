"""The distributed sort-last VDI frame on the slice march.

Each rank of a mesh (``parallel/mesh.py``) holds one even z-slab of the
volume. A frame runs the reference's chain:

    generate    every rank marches its render decomposition onto the global
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
march wave w; then composite the last wave), without its overlap.

The render decomposition need not be the sim's even slab
(``CompositeConfig.rebalance``; the step builders take ``plan=`` or
``bricks=``):

``"occupancy"``  a render plan (one band depth a rank,
                 ``ops/occupancy.slice_plan``): rank r marches the
                 contiguous band ``mesh.reslab_z`` assembles, padded to
                 ``max(plan)`` and owned through ``w_bounds`` (z march)
                 or ``v_bounds`` (x/y march).
``"bricks"``     a ``parallel/bricks.BrickMap``: rank r marches each of
                 its brick slots (``mesh.reslab_bricks``) as a unit of
                 its own and concatenates the K-slot fragments into one
                 ``[slots*K]`` stream before the exchange; absent slots
                 own an empty interval and come out all ``+inf``. With
                 levels (the LOD march), a level-l unit is the brick
                 pooled 2^l-fold (``mesh.reslab_bricks_lod``), marched
                 on the shared fine camera with ``dwm * 2^l`` and
                 ``step_scale = 2^-l``.

An even plan, an even-convex map, and one rank with an all-fine map take
the slab path unchanged. The temporal threshold maps of a brick step
stack a rank's slots by rows (``[slots*nj, ni]``) and the ranks on top.
On a two-level ``(hosts, ranks)`` mesh (``parallel/topology.py``) the
march is the flat mesh's, rank by flat rank, and the exchange and
composite split into a level inside each domain and a level across
domains, resegmented once at the top (``parallel/hier.py``); the blocks
come back in the ranks-major order ``Topology.out_axis``, which is the
frame's natural column order.

Two knobs of ``CompositeConfig`` act on the march, as in the reference
(slab and plan decompositions; a brick map ledgers both inert):

``k_budget="occupancy"``  every rank's adaptive threshold picks (or, in
                temporal mode, bisects) toward its share of the ``n *
                K`` budget (``ops/occupancy.k_budget_target``), by its
                pyramid's live fraction over the sum of all ranks' (the
                reference's psum, here a sum over the in-process
                ranks). Output shapes stay at K.
``temporal_reuse="ranges"``  the step carries each rank's last marched
                fragment (``ops/delta.ReuseState``); a rank whose
                pyramid ranges and camera did not move (within
                ``reuse_tol``) marches nothing and feeds the carried
                fragment to the exchange, its threshold maps held.

The hybrid frame (`distributed_hybrid_step_mxu`) runs the VDI half of
these steps, then splats the rank-sharded tracers sort-first
(``parallel/particles.sort_first_splat``) on the shared virtual camera
and inserts the particle layer into every rank's composited column block
(``ops/hybrid.py``).

A frame therefore runs in two passes: every rank's frame state (one
pyramid a rank, built when the spec skips empty space or a knob needs
it), the targets and the dirty bits (one copy to the host a frame),
then the marches of the dirty ranks (the reference's ``lax.cond``
becomes a Python branch a rank; a clean rank launches no march kernel).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch import obs as _obs
from scenery_insitu_tpu_torch.config import (CompositeConfig, RenderConfig,
                                             VDIConfig)
from scenery_insitu_tpu_torch.core.camera import Camera
from scenery_insitu_tpu_torch.core.transfer import TransferFunction
from scenery_insitu_tpu_torch.core.vdi import VDI
from scenery_insitu_tpu_torch.core.volume import Volume
from scenery_insitu_tpu_torch.obs.profiler import phase as _phase
from scenery_insitu_tpu_torch.ops import ao as _ao
from scenery_insitu_tpu_torch.ops import slicer
from scenery_insitu_tpu_torch.ops import supersegments as ss
from scenery_insitu_tpu_torch.ops import wire as _wire
from scenery_insitu_tpu_torch.ops.composite import (
    composite_plain, composite_vdis, merge_vdis_pairwise,
    modeled_exchange_traffic, resegment_stream, sort_stream)
from scenery_insitu_tpu_torch.ops.raycast import raycast
from scenery_insitu_tpu_torch.ops.vdi_gen import generate_vdi
from scenery_insitu_tpu_torch.parallel.bricks import BrickMap
from scenery_insitu_tpu_torch.parallel.mesh import (Mesh, halo_exchange_z,
                                                    reslab_bricks,
                                                    reslab_bricks_lod,
                                                    reslab_z, validate_plan)
from scenery_insitu_tpu_torch.parallel.topology import resolve_mesh_topology


def _check_sharded(data: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A step's volume argument: the mesh's rank slabs ``[n, Dn, H, W]``
    (`shard_volume`), on a process mesh this process's ``[n_local, Dn,
    H, W]`` (`multihost.shard_global`)."""
    nl = mesh.n_local
    if data.dim() != 4 or data.shape[0] != nl:
        raise ValueError(f"expected the {nl} rank slabs [n, D/n, H, W] "
                         f"of shard_volume, got {tuple(data.shape)}")
    return data


_PROCESS_SCOPE = ("on a process mesh the distributed steps run the frame "
                  "schedule's all_to_all on the f32 wire over a flat mesh "
                  "with even slabs; {what} across processes is ROADMAP A8b "
                  "item 9, the rest")


def _process_scope(mesh: Mesh, comp_cfg=None, plan=None, bricks=None,
                   topology=None, builder: Optional[str] = None) -> None:
    """Raise `NotImplementedError` for what a process mesh does not run
    yet: any knob of ``comp_cfg`` off the reference smoke's path, a plan,
    a brick map, a topology, or the ``builder`` named."""
    if not mesh.spans_processes:
        return
    bad = [builder] if builder else []
    if comp_cfg is not None:
        for knob, want in (("exchange", "all_to_all"), ("wire", "f32"),
                           ("schedule", "frame"), ("rebalance", "even"),
                           ("k_budget", "static"), ("temporal_reuse", "off")):
            got = getattr(comp_cfg, knob)
            if got != want:
                bad.append(f"{knob}={got!r}")
    for name, knob in (("plan", plan), ("bricks", bricks),
                       ("topology", topology)):
        if knob is not None:
            bad.append(name)
    if mesh.num_hosts > 1:
        bad.append("a two-level mesh")
    if bad:
        raise NotImplementedError(_PROCESS_SCOPE.format(
            what=", ".join(bad)))


class _Unit(NamedTuple):
    """One march unit of a rank: a volume, its ownership bounds on the
    in-plane v axis (x/y march) and on the march axis (planned bands and
    bricks of a z march), and its downsample factor (2^level)."""

    vol: Volume
    v_bounds: Optional[tuple]
    w_bounds: Optional[tuple]
    f: int = 1


class _Decomp(NamedTuple):
    """Rank r's render decomposition of a frame: its march units, the
    fine-pitch volume the shared camera and the metadata are built on,
    the global box's max corner and the global dims (x, y, z)."""

    units: List[_Unit]
    ref: Volume
    gmax: torch.Tensor
    dims: Tuple[int, int, int]


def _shifted(origin: torch.Tensor, dz_offset) -> torch.Tensor:
    """``origin`` with ``dz_offset`` added to its z component."""
    shift = torch.zeros(3, dtype=torch.float32, device=origin.device)
    shift[2] = dz_offset
    return origin + shift


def _frame_rows(slabs: torch.Tensor, spec: slicer.AxisSpec, plan=None,
                bricks: Optional[BrickMap] = None, mesh: Mesh = None):
    """The rows a frame's ranks march, assembled once a frame from the
    even slabs ``[n, Dn, H, W]`` (this process's on a process ``mesh``):
    None (an even z march marches its own
    slab), the halo-padded slabs (an even x/y march), the planned bands
    (`reslab_z`), or the brick sets by level ``{level: [n, slots, rows,
    H, W]}`` (`reslab_bricks`, `reslab_bricks_lod`). A z march needs no
    halo rows. A brick set of a bf16 march is gathered from the bf16
    copy of the slabs, so pooled levels pool the values the march
    reads."""
    h = 0 if spec.axis == 2 else 1
    if bricks is not None:
        with _phase("halo"):
            if spec.render_dtype == "bf16" and slabs.dtype == torch.float32:
                slabs = slabs.to(torch.bfloat16)
            if bricks.max_level == 0:
                return {0: reslab_bricks(slabs, bricks, h=h)}
            return reslab_bricks_lod(slabs, bricks, h=h)
    if plan is not None:
        with _phase("halo"):
            return reslab_z(slabs, plan, h=h)
    return _halo_for(slabs, spec, mesh)


def _rank_units(slabs: torch.Tensor, rows, r: int, origin: torch.Tensor,
                spacing: torch.Tensor, spec: slicer.AxisSpec, plan=None,
                bricks: Optional[BrickMap] = None, first: int = 0,
                n_total: Optional[int] = None) -> _Decomp:
    """Rank r's march units of the frame whose rows `_frame_rows`
    assembled.

    Even slab: a z march (``spec.axis == 2``) marches the rank's own
    slices (``rows[r]`` when given: its `_shaded_rows` slab), no
    bounds; an x or y march has z as its v axis: the slab with its halo
    rows for seam-exact bilinear, and half-open ownership so every
    sample belongs to exactly one rank; the last rank's bound
    reaches one slice past the global top, which the volume-extent mask
    still caps. A planned band is owned the same way, through
    ``w_bounds`` on a z march (its pad slices shade nothing). Bricks:
    one unit a slot, each owning its brick's world interval (the brick
    at the global top keeps the +dz slack on an x/y march, scaled by the
    level's pitch); absent slots own an empty interval. ``r`` is the
    global rank; ``slabs`` and ``rows`` hold ranks ``first ..`` of
    ``n_total`` (a process mesh's share; default: every rank)."""
    _, dn, h, w = slabs.shape
    n = n_total or slabs.shape[0]
    loc = r - first
    dz = spacing[2]
    d = dn * n
    dims = (w, h, d)
    gmax = origin + torch.tensor(dims, dtype=torch.float32,
                                 device=origin.device) * spacing
    z_march = spec.axis == 2
    if bricks is not None:
        return _brick_units(rows, r, origin, spacing, z_march, bricks,
                            gmax, dims)
    if plan is not None:
        g0, p_r = sum(plan[:r]), plan[r]
        z_lo = origin[2] + float(g0) * dz
        z_hi = origin[2] + float(g0 + p_r) * dz
        if z_march:
            vol = Volume(rows[loc], _shifted(origin, float(g0) * dz),
                         spacing)
            unit = _Unit(vol, None, (z_lo, z_hi))
        else:
            vol = Volume(rows[loc], _shifted(origin, float(g0 - 1) * dz),
                         spacing)
            unit = _Unit(vol, (z_lo, z_hi + dz if r == n - 1 else z_hi),
                         None)
        return _Decomp([unit], unit.vol, gmax, dims)
    if z_march:
        own = slabs[loc] if rows is None else rows[loc]
        vol = Volume(own, _shifted(origin, r * dn * dz), spacing)
        unit = _Unit(vol, None, None)
    else:
        vol = Volume(rows[loc], _shifted(origin, (r * dn - 1) * dz),
                     spacing)
        z_lo = origin[2] + r * dn * dz
        z_hi = origin[2] + (r + 1) * dn * dz
        unit = _Unit(vol, (z_lo, z_hi + dz if r == n - 1 else z_hi), None)
    return _Decomp([unit], vol, gmax, dims)


def _brick_units(rows: dict, r: int, origin: torch.Tensor,
                 spacing: torch.Tensor, z_march: bool, bmap: BrickMap,
                 gmax: torch.Tensor, dims) -> _Decomp:
    """Rank r's brick units, grouped by level in ascending order (level
    0 alone on a map without levels). A level-l unit is the pooled brick
    at ``spacing * 2^l`` with the same corner origin; its bounds stay
    the fine brick's world interval. ``ref``: the first unit's volume
    on a map without levels, else a ``(1, 1, 1)`` zero volume at the
    global origin and pitch."""
    dz = spacing[2]
    d = dims[2]
    bz = bmap.brick_depth
    halo = 0 if z_march else 1
    levels = bmap.levels_present() if bmap.max_level else (0,)
    units = []
    for lvl in levels:
        f = 1 << lvl
        table = bmap.start_table_at(lvl)
        arr = rows[lvl][r]
        for s in range(table.shape[1]):
            start = int(table[r, s])                       # -1 = absent
            present = start >= 0
            z_lo = origin[2] + float(start) * dz
            z_hi = origin[2] + float(start + bz) * dz
            vol = Volume(arr[s], _shifted(origin, float(start - halo * f)
                                          * dz), spacing * float(f)
                         if f > 1 else spacing)
            if z_march:
                wb = (z_lo, z_hi) if present else (math.inf, -math.inf)
                units.append(_Unit(vol, None, wb, f))
            else:
                hi = z_hi + float(f) * dz if start + bz == d else z_hi
                vb = (z_lo, hi) if present else (math.inf, -math.inf)
                units.append(_Unit(vol, vb, None, f))
    if bmap.max_level == 0:
        ref = units[0].vol
    else:
        ref = Volume(torch.zeros((1, 1, 1), dtype=rows[levels[0]].dtype,
                                 device=origin.device), origin, spacing)
    return _Decomp(units, ref, gmax, dims)


# -------------------------------------------------------------- exchange


def _column_blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    """One rank's fragment ``[..., W]`` split into its n column blocks:
    ``[n, ..., W/n]``, block j the columns rank j composites."""
    w = x.shape[-1]
    return x.reshape(x.shape[:-1] + (n, w // n)).movedim(-2, 0)


def _exchange_columns(x: torch.Tensor, n: int,
                      hop_scope: str = "exchange") -> torch.Tensor:
    """The column all_to_all of rank-stacked fragments ``[n, ..., W]``:
    rank j receives the j-th of n column blocks from every rank. Returns
    ``[n_dst, n_src, ..., W/n]``. ``hop_scope`` names its phase
    (``dcn_hop`` across the domains of a two-level composite)."""
    w = x.shape[-1]
    parts = x.reshape(x.shape[:-1] + (n, w // n))
    with _phase(hop_scope):
        return parts.movedim(-2, 0).contiguous()


def _encode_ranks(color: torch.Tensor, depth: torch.Tensor, wire: str):
    """Every rank's fragment of the rank-stacked ``color [n, K, 4, H,
    W]``, ``depth [n, K, 2, H, W]`` encoded for ``wire``, each against
    its own scale. Returns (color_enc [n, ...], depth_enc [n, ...],
    scales f32[n, 2] or None)."""
    with _phase("wire_encode"):
        enc = [_wire.encode_fragment(c, d, wire)
               for c, d in zip(color, depth)]
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
    with _phase("wire_encode"):
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
        with _phase("merge"):
            c, d = sort_stream(c, d)
        with _phase("wire_encode"):
            ec, ed, scale = _wire.encode_fragment(c, d, wire)
        out.append((_column_blocks(ec, n), _column_blocks(ed, n), scale))
    return out


def _ring_accumulate(blocks, r: int, wire: str, cap: Optional[int],
                     hop_scope: str = "exchange"):
    """Rank r's ring: its own block through the codec, then at hop
    s = 1..n-1 the block of rank (r+s) mod n decoded and merged into the
    sorted accumulator (arrival order r, r+1, ... with wrap-around; ties
    go to the accumulator). Returns the accumulator (color [M, 4, H,
    W/n], depth [M, 2, H, W/n]), not yet resegmented. The same core
    serves the single-level ring and both rings of the two-level
    composite (``parallel/hier.py``); the build markers count its hops
    (`ring_hop_markers`) under each ring's names. ``hop_scope`` names a
    hop's phase (``dcn_hop`` in the two-level composite's level 2); an
    in-process hop hands the block over by reference, so its scope holds
    no device work."""
    n = len(blocks)
    bc, bd, scale = blocks[r]
    with _phase("wire_encode"):
        acc_c, acc_d = _wire.decode_fragment(bc[r], bd[r], scale, wire)
    for s in range(1, n):
        with _phase(hop_scope):
            bc, bd, scale = blocks[(r + s) % n]
            bc, bd = bc[r], bd[r]
        with _phase("wire_encode"):
            mc, md = _wire.decode_fragment(bc, bd, scale, wire)
        with _phase("merge"):
            acc_c, acc_d = merge_vdis_pairwise(acc_c, acc_d, mc, md,
                                               k_cap=cap)
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
    out = []
    for r in range(n):
        acc = _ring_accumulate(blocks, r, cfg.wire, cap)
        with _phase("resegment"):
            out.append(resegment_stream(*acc, cfg, gap_eps))
    return out


def _composite_exchanged(color: torch.Tensor, depth: torch.Tensor, n: int,
                         cfg: CompositeConfig, topo=None,
                         mesh: Optional[Mesh] = None) -> List[VDI]:
    """Exchange and composite of the rank-stacked fragments under
    ``cfg.exchange`` and ``cfg.wire``: every rank's composited column
    block, in column order. One rank takes the all_to_all path. A
    ``topo`` (a two-level `parallel.topology.Topology`) runs the
    two-level composite (``parallel/hier.py``). On a process ``mesh``
    the fragments are this process's ranks' and so are the blocks
    returned (`_composite_exchanged_procs`)."""
    if mesh is not None and mesh.spans_processes:
        return _composite_exchanged_procs(color, depth, mesh, cfg)
    if topo is not None:
        from scenery_insitu_tpu_torch.parallel.hier import hier_composite_vdi

        return hier_composite_vdi(color, depth, topo, cfg)
    if cfg.exchange == "ring" and n > 1:
        return _ring_exchange_composite(color, depth, n, cfg)
    rc, rd = _exchange_vdi_columns(color, depth, n, cfg.wire)
    return [composite_vdis(rc[j], rd[j], cfg) for j in range(n)]


def _composite_exchanged_procs(color: torch.Tensor, depth: torch.Tensor,
                               mesh: Mesh, cfg: CompositeConfig
                               ) -> List[VDI]:
    """The all_to_all exchange and composite on a process mesh: this
    process's ``n_local`` fragments (``color [n_local, K, 4, H, W]``,
    ``depth [n_local, K, 2, H, W]``), colour and depth side by side in
    one buffer, split into the n column blocks and sent in ONE
    ``all_to_all_single`` (process q receives the blocks of its ranks
    from every process, in source-rank order); each of this process's
    ranks then composites its N·K-slot block (K4 on a card), as
    `_exchange_vdi_columns` and `composite_vdis` do on one process.
    Returns this process's ranks' blocks in column order."""
    from scenery_insitu_tpu_torch.parallel.multihost import all_to_all

    nl, k = color.shape[:2]
    frag = torch.cat([color, depth], dim=2)             # [nl, K, 6, H, W]
    parts = _exchange_columns(frag, mesh.n)       # [n_dst, nl_src, ...]
    parts = parts.reshape((mesh.n // nl, nl) + tuple(parts.shape[1:]))
    with _phase("exchange"):
        got = all_to_all(parts, mesh.group)  # [P_src, nl_dst, nl_src, ...]
    out = []
    for j in range(nl):
        blk = got[:, j].reshape((mesh.n,) + tuple(got.shape[3:]))
        out.append(composite_vdis(blk[:, :, :4], blk[:, :, 4:], cfg))
    return out


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
    ring_hop_markers(n, k, h, w // n, cfg.wire)


def ring_hop_markers(n: int, k: int, h: int, wb: int, wire: str,
                     dcn: bool = False) -> None:
    """The n - 1 hops of one ring built, each a counter and an event
    with the bytes of the ``[K, ., h, wb]`` block it ships on ``wire``:
    ``ring_steps_built``/``ring_step``, or ``dcn_hops_built``/``dcn_hop``
    for the two-level composite's DCN ring (``dcn``), the reference's
    hop names."""
    rec = _obs.get_recorder()
    cb, db = _wire.wire_slot_bytes(wire)
    frag_bytes = k * h * wb * (cb + db)
    for s in range(1, n):
        attrs = dict(step=s, hops=s, frag_bytes=frag_bytes, wire=wire)
        if dcn:
            rec.count("dcn_hops_built")
            rec.event("dcn_hop", **attrs)
        else:
            rec.count("ring_steps_built")
            rec.event("ring_step", **attrs)


def _wire_build_marker(wire: str) -> None:
    """One wire encode built (a lossy wire only)."""
    cb, db = _wire.wire_slot_bytes(wire)
    rec = _obs.get_recorder()
    rec.count("wire_encode_builds")
    rec.event("wire_encode", wire=wire, bytes_per_slot=cb + db)


def _wave_build_marker(n: int, t: int, k: int, h: int, w: int,
                       cfg: CompositeConfig, marched: bool = True) -> None:
    """One wave schedule built: its counters (the build and its T waves)
    and one event with the modeled overlap accounting. ``marched=False``
    tags the gather engine's schedule, whose march is one for the frame
    and whose waves only exchange and composite."""
    rec = _obs.get_recorder()
    rec.count("wave_schedule_builds")
    rec.count("wave_steps_built", t)
    rec.event("wave_schedule_build", ranks=n, tiles=t, k=k,
              wave_cols=w // t, tile_cols=w // (n * t),
              march_per_wave=marched,
              traffic=modeled_exchange_traffic(
                  n, k, h, w, k_out=cfg.max_output_supersegments,
                  mode=cfg.exchange, ring_slots=cfg.ring_slots,
                  wire=cfg.wire, schedule="waves", wave_tiles=t))


def _exchange_build_markers(n: int, k: int, h: int, w: int,
                            comp_cfg: CompositeConfig, topo, waves: bool,
                            marched: bool = True) -> None:
    """The build markers of a VDI step's exchange and composite on a
    ``[K, ., h, w]`` fragment: the wave schedule, the two-level
    composite or the ring (on a wave's width under waves), and a lossy
    wire's encode."""
    if waves:
        _wave_build_marker(n, comp_cfg.wave_tiles, k, h, w, comp_cfg,
                           marched)
    w_step = w // (comp_cfg.wave_tiles if waves else 1)
    if topo is not None:
        from scenery_insitu_tpu_torch.parallel.hier import _hier_build_marker

        _hier_build_marker(topo, k, h, w_step, comp_cfg)
        if topo.dcn_wire != "f32":
            _wire_build_marker(topo.dcn_wire)
    elif comp_cfg.exchange == "ring" and n > 1:
        _ring_build_marker(n, k, h, w_step, comp_cfg)
    if comp_cfg.wire != "f32":
        _wire_build_marker(comp_cfg.wire)


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


def _rebalance_build_marker(plan, n: int) -> None:
    """One rebalanced step built: counts the build and records the
    plan's shape, with the pad overhead every rank pays for one band
    shape (max(plan)/mean(plan) - 1)."""
    rec = _obs.get_recorder()
    rec.count("rebalance_steps_built")
    rec.event("rebalance_build", ranks=n, plan=list(plan),
              max_depth=int(max(plan)), min_depth=int(min(plan)),
              pad_overhead=round(
                  int(max(plan)) * n / float(sum(plan)) - 1.0, 4))


def _rebalance_mode(comp_cfg) -> str:
    if comp_cfg is None:
        return "even"
    return comp_cfg if isinstance(comp_cfg, str) else comp_cfg.rebalance


def _resolve_plan(comp_cfg, n: int, plan, min_halo: int = 1):
    """Build-time resolution of a render z-plan. Returns the validated
    plan tuple, or None for the even slab path: ``plan=None``, one rank,
    or an even plan. A plan without ``rebalance="occupancy"`` raises."""
    if plan is None:
        return None
    rebalance = _rebalance_mode(comp_cfg)
    if rebalance != "occupancy":
        raise ValueError(
            f"a render plan was passed but rebalance={rebalance!r} — "
            f"plans are the mechanism of rebalance='occupancy'")
    plan = validate_plan(plan, n, h=min_halo)
    if n == 1 or all(p == plan[0] for p in plan):
        return None
    _rebalance_build_marker(plan, n)
    return plan


def _bricks_build_marker(bmap: BrickMap, n: int) -> None:
    """One brick-partitioned step built: the brick grid, the padded slot
    count every rank marches and the ownership histogram."""
    counts = [len(bmap.rank_bricks(r)) for r in range(n)]
    rec = _obs.get_recorder()
    rec.count("bricks_steps_built")
    rec.event("bricks_build", ranks=n, nbricks=bmap.nbricks,
              brick_depth=bmap.brick_depth, slots=bmap.slots,
              owner=list(bmap.owner), bricks_per_rank=counts,
              level=list(bmap.level), max_level=bmap.max_level,
              total_slots=bmap.total_slots)


def _resolve_bricks(comp_cfg, n: int, bricks):
    """Build-time resolution of a brick-to-rank render partition.
    Returns the `BrickMap`, or None for the slab path: no map, one rank
    with every brick at level 0, or the even-convex map (bit for bit the
    slab step). A map without ``rebalance="bricks"``, or one built for
    another rank count, raises."""
    if bricks is None:
        return None
    if not isinstance(bricks, BrickMap):
        raise TypeError(f"bricks= takes a parallel.bricks.BrickMap, got "
                        f"{type(bricks).__name__}")
    rebalance = _rebalance_mode(comp_cfg)
    if rebalance != "bricks":
        raise ValueError(
            f"a brick map was passed but rebalance={rebalance!r} — brick "
            f"partitions are the mechanism of rebalance='bricks'")
    if bricks.n_ranks != n:
        raise ValueError(f"brick map built for {bricks.n_ranks} ranks on "
                         f"a {n}-rank mesh")
    # one rank short-circuits only when every brick is level 0: a coarse
    # level still changes what is marched
    if (n == 1 and bricks.max_level == 0) or bricks.is_even_convex():
        return None
    _bricks_build_marker(bricks, n)
    return bricks


# ------------------------------------------------------------ generation


def _rank_thr(thr: ss.ThresholdState, r: int, nj: int) -> ss.ThresholdState:
    """Rank r's maps of the rank-stacked state; ``nj`` is a rank's row
    count (``slots * nj`` under a brick map)."""
    return ss.ThresholdState(*(x[r * nj:(r + 1) * nj] for x in thr))


def _thr_slot(thr: ss.ThresholdState, s: int, nj: int) -> ss.ThresholdState:
    """Slot ``s``'s ``[nj, ni]`` maps of a rank's row-stacked state."""
    return ss.ThresholdState(*(x[s * nj:(s + 1) * nj] for x in thr))


def _stack_thr(states) -> ss.ThresholdState:
    """Row-stack threshold states (slots of a rank, or ranks)."""
    if len(states) == 1:
        return states[0]
    return ss.ThresholdState(*(torch.cat(parts) for parts in zip(*states)))


def _cat_slots(xs: List[torch.Tensor]) -> torch.Tensor:
    """A rank's slot fragments as one ``[slots*K, ...]`` stream."""
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim=0)


def _unit_camera(axcam: slicer.AxisCamera, f: int) -> slicer.AxisCamera:
    """The shared fine camera, stepping 2^level fine slices a slice."""
    return axcam if f == 1 else axcam._replace(dwm=axcam.dwm * f)


def _global_meta(dec: _Decomp, axcam, spec, origin):
    return slicer._vdi_meta(dec.ref, axcam, spec.ni, spec.nj)._replace(
        volume_dims=torch.tensor(dec.dims, dtype=torch.float32,
                                 device=origin.device))


def _shaded_rows(slabs: torch.Tensor, spec: slicer.AxisSpec, origin,
                 spacing, shade: Callable, shade_halo: int, plan=None):
    """`_frame_rows` with a per-rank volume shader: every rank's slab (or
    ``plan`` band) is extended by ``shade_halo + 1`` neighbour slices a
    side, shaded, and trimmed to the rows its march reads (the bare slab
    on a z march, the band padded to ``max(plan)`` on a planned one, one
    halo slice a side on an x/y march). A shader whose neighbourhood is
    at most ``shade_halo`` slices deep (the AO blur of that radius) so
    sees real neighbour slices and matches the single-device shading
    seam for seam. The shader may add a leading channel dim (scalar ->
    pre-shaded RGBA). Returns the rank-stacked rows ``[n, (ch,) rows, H,
    W]``, which `_rank_units` places as it places `_frame_rows`'."""
    n, dn = slabs.shape[:2]
    dz = spacing[2]
    hr = shade_halo + 1
    with _phase("halo"):
        if plan is None:
            ext = halo_exchange_z(slabs, h=hr)
            starts, depth = [r * dn for r in range(n)], dn
        else:
            ext = reslab_z(slabs, plan, h=hr)
            starts = [sum(plan[:r]) for r in range(n)]
            depth = max(plan)
    lo, hi = (hr, hr + depth) if spec.axis == 2 else (hr - 1,
                                                      hr + depth + 1)
    out = []
    for r in range(n):
        data = shade(Volume(ext[r], _shifted(origin, (starts[r] - hr) * dz),
                            spacing)).data
        out.append(data[..., lo:hi, :, :])
    return torch.stack(out)


def _halo_for(slabs: torch.Tensor, spec: slicer.AxisSpec,
              mesh: Optional[Mesh] = None):
    """The halo-padded slabs an x or y march reads; None for a z march,
    which needs none."""
    if spec.axis == 2:
        return None
    with _phase("halo"):
        return halo_exchange_z(slabs, mesh=mesh)


class _RankFrame:
    """Rank r's state of one frame, built before any rank marches and
    shared by every march of the frame (the frame schedule's one, or the
    tile waves'): its march units, the virtual camera, and a unit's one
    permuted copy and one occupancy pyramid
    (``ops/occupancy.pyramid_from_volume``). The pyramid is built when
    the spec skips empty space (its gate feeds the march) or when
    ``pyramid`` asks for it: the K budget reads its live fraction, fragment
    reuse its ranges."""

    def __init__(self, slabs, halo, r, origin, spacing, cam, spec, tf,
                 plan=None, bricks=None, pyramid: bool = False,
                 first: int = 0, n_total: Optional[int] = None):
        from scenery_insitu_tpu_torch.ops import occupancy as _occ

        with _phase("march"):
            self.dec = _rank_units(slabs, halo, r, origin, spacing, spec,
                                   plan, bricks, first, n_total)
            self.axcam = slicer.make_axis_camera(self.dec.ref, cam, spec,
                                                 box_min=origin,
                                                 box_max=self.dec.gmax)
            self.volps = [slicer.permute_volume(u.vol, spec)
                          for u in self.dec.units]
            build = spec.skip_empty or pyramid
            self.pyrs = [_occ.pyramid_from_volume(u.vol, tf, spec, volp=vp)
                         if build else None
                         for u, vp in zip(self.dec.units, self.volps)]


def _march_units(fr: _RankFrame, cam, spec, axcam, tf, vdi_cfg,
                 slot_thr=None, k_target=None):
    """A rank's march of every unit of its frame state on ``axcam`` and
    ``spec`` (the frame's, or a tile wave's `slicer.wave_camera`), the
    slot fragments concatenated into one ``[slots*K]`` stream (the
    exchange and composite sort every pixel's stream, so interleaved
    depth ranges need no merge here). ``slot_thr``: in temporal mode
    each unit's threshold maps, else None; ``k_target``: the rank's K
    budget target, else None. Returns (color, depth, each unit's next
    maps or None)."""
    colors, depths, thr2s = [], [], []
    with _phase("march"):
        for s, u in enumerate(fr.dec.units):
            kw = dict(v_bounds=u.v_bounds, w_bounds=u.w_bounds,
                      occupancy=fr.pyrs[s], axcam=_unit_camera(axcam, u.f),
                      volp=fr.volps[s], step_scale=1.0 / u.f,
                      k_target=k_target)
            if slot_thr is None:
                vdi, _, _ = slicer.generate_vdi_mxu(u.vol, tf, cam, spec,
                                                    vdi_cfg, **kw)
            else:
                vdi, _, _, t2 = slicer.generate_vdi_mxu_temporal(
                    u.vol, tf, cam, spec, slot_thr[s], vdi_cfg, **kw)
                thr2s.append(t2)
            colors.append(vdi.color)
            depths.append(vdi.depth)
        return (_cat_slots(colors), _cat_slots(depths),
                thr2s if slot_thr is not None else None)


def _slot_maps(thr: Optional[ss.ThresholdState], fr: _RankFrame,
               nj: int):
    """A rank's row-stacked maps split into its units' ``[nj, ni]``
    sets (None stays None)."""
    if thr is None:
        return None
    return [_thr_slot(thr, s, nj) for s in range(len(fr.dec.units))]


def _mxu_rank_generate(slabs, halo, r, origin, spacing, cam, spec, tf,
                       vdi_cfg, threshold=None, plan=None, bricks=None,
                       k_target=None):
    """Rank r's VDI of the frame whose rows `_frame_rows` assembled
    (``halo``): its frame state and its march. Returns (vdi, meta,
    next_threshold); the metadata describes the global volume."""
    fr = _RankFrame(slabs, halo, r, origin, spacing, cam, spec, tf, plan,
                    bricks)
    c, d, thr2 = _march_units(fr, cam, spec, fr.axcam, tf, vdi_cfg,
                              _slot_maps(threshold, fr, spec.nj), k_target)
    return (VDI(c, d), _global_meta(fr.dec, fr.axcam, spec, origin),
            None if thr2 is None else _stack_thr(thr2))


# ------------------------------------- K budgets and fragment reuse


def _resolve_budget(comp_cfg: CompositeConfig, vdi_cfg: VDIConfig, n: int,
                    bricks) -> bool:
    """Build-time resolution of ``comp_cfg.k_budget``: True re-targets
    every rank's adaptive threshold at its share of the ``n * K`` budget
    (`_k_targets`). A brick map, or a fixed threshold, has no budget to
    apply and goes on the ledger, as the reference's step and frame
    state record them."""
    if comp_cfg.k_budget != "occupancy":
        return False
    if bricks is not None:
        _obs.degrade("occupancy.k_budget", "occupancy", "static",
                     "brick-partitioned MXU steps derive no per-rank "
                     "budget sum (slab decompositions only)", warn=False)
        return False
    if not vdi_cfg.adaptive:
        _obs.degrade("occupancy.k_budget", "occupancy", "static",
                     "k budgets re-target the ADAPTIVE threshold; "
                     "vdi.adaptive=False ignores them", warn=False)
        return False
    rec = _obs.get_recorder()
    rec.count("occupancy_kbudget_builds")
    rec.event("occupancy_kbudget_build", ranks=n,
              k=vdi_cfg.max_supersegments, k_min=comp_cfg.k_budget_min)
    return True


def _resolve_reuse(comp_cfg: CompositeConfig, supported: bool = True,
                   where: str = "") -> bool:
    """Build-time resolution of ``comp_cfg.temporal_reuse``: True threads
    the carried `ops.delta.ReuseState` through the step. A step with
    no marched fragment to carry (``supported=False``: a brick map) puts
    the inert knob on the ledger instead."""
    if comp_cfg.temporal_reuse != "ranges":
        return False
    if not supported:
        _obs.degrade("delta.reuse", "ranges", "off",
                     f"{where} carries no reusable VDI fragment "
                     "(temporal_reuse is an MXU VDI step feature)",
                     warn=False)
        return False
    _obs.get_recorder().count("reuse_steps_built")
    return True


def _k_targets(frames: List[_RankFrame], n: int, vdi_cfg: VDIConfig,
               comp_cfg: CompositeConfig) -> List[torch.Tensor]:
    """Every rank's K budget target (``ops/occupancy.k_budget_target``)
    from the live fractions of the ranks' pyramids, summed over all n
    ranks in rank order (the reference's sum over the mesh); f32
    0-dim tensors on the device, never read by the host."""
    from scenery_insitu_tpu_torch.ops import occupancy as _occ

    live = [fr.pyrs[0].live_fraction() for fr in frames]
    total = live[0]
    for x in live[1:]:
        total = total + x
    return [_occ.k_budget_target(x, total, n, vdi_cfg.max_supersegments,
                                 comp_cfg.k_budget_min) for x in live]


class _Reuse(NamedTuple):
    """One frame's reuse decision: every rank's signature, the host's
    dirty bits, the incoming carry's fragments viewed by rank (color
    [n, K, 4, nj, ni], depth [n, K, 2, nj, ni]) and its signatures."""

    sigs: List[torch.Tensor]
    dirty: np.ndarray               # bool[n]
    color: torch.Tensor
    depth: torch.Tensor
    prev_sig: torch.Tensor          # f32[n*S]


def _reuse_decide(frames: List[_RankFrame], cam, ru, tol: float,
                  k: int) -> _Reuse:
    """Every rank's signature against its carried one, decided with ONE
    copy of the ranks' moved bits to the host (none while the carry is
    the seed, where every rank marches)."""
    from scenery_insitu_tpu_torch.ops import delta as _delta

    n = len(frames)
    sigs = [_delta.reuse_signature(fr.pyrs[0], cam) for fr in frames]
    s = sigs[0].numel()
    if ru.sig.numel() != n * s:
        raise ValueError(f"reuse carry holds {ru.sig.numel()} signature "
                         f"values; this frame's {n} ranks need {n * s} "
                         f"(seed it with distributed_initial_reuse_mxu "
                         f"for this step)")
    invalid = ru.valid.cpu().numpy() == 0
    if invalid.all():
        dirty = np.ones(n, bool)
    else:
        nr = 2 * frames[0].pyrs[0].lo.numel()
        moved = torch.stack([_delta.reuse_moved(
            sg, ru.sig[r * s:(r + 1) * s], tol, nr)
            for r, sg in enumerate(sigs)])
        dirty = moved.cpu().numpy() | invalid
    return _Reuse(sigs, dirty,
                  ru.color.reshape((n, k) + tuple(ru.color.shape[1:])),
                  ru.depth.reshape((n, k) + tuple(ru.depth.shape[1:])),
                  ru.sig)


def _reuse_carry(dec: _Reuse, color: torch.Tensor,
                 depth: torch.Tensor):
    """The outgoing carry: a marched rank's signature and fragment, a
    clean rank's carried ones (its signature stays the last MARCHED
    frame's, so drift under a tolerance accumulates), from the
    rank-stacked fragments ``color [n, K, ...]`` of this frame."""
    from scenery_insitu_tpu_torch.ops import delta as _delta

    n = len(dec.sigs)
    s = dec.sigs[0].numel()
    sig = torch.cat([sg if dec.dirty[r] else dec.prev_sig[r * s:(r + 1) * s]
                     for r, sg in enumerate(dec.sigs)])
    return _delta.ReuseState(
        sig=sig, color=color.reshape((-1,) + tuple(color.shape[2:])),
        depth=depth.reshape((-1,) + tuple(depth.shape[2:])),
        valid=torch.ones(n, dtype=torch.int32),
        dirty=torch.as_tensor(dec.dirty.astype(np.int32)))


# ---------------------------------------------------------- schedules


def _frame_schedule(frames, cam, spec, tf, vdi_cfg, thr, rows_a_rank,
                    kts, dec: Optional[_Reuse]):
    """The frame schedule's generation: every dirty rank marches its
    frame state once (every rank without reuse); a clean rank's
    fragment is the carried one and its threshold maps hold. Returns
    the rank-stacked fragments (color [n, K, ...], depth) and the
    rank-stacked next thresholds (None without temporal state)."""
    if dec is not None and not dec.dirty.any():
        # nothing marches: the carry IS this frame's fragments
        return dec.color, dec.depth, thr
    colors, depths, thr2s = [], [], []
    for r, fr in enumerate(frames):
        thr_r = None if thr is None else _rank_thr(thr, r, rows_a_rank)
        if dec is None or dec.dirty[r]:
            c, d, t2 = _march_units(fr, cam, spec, fr.axcam, tf, vdi_cfg,
                                    _slot_maps(thr_r, fr, spec.nj),
                                    None if kts is None else kts[r])
            t2 = None if t2 is None else _stack_thr(t2)
        else:
            c, d, t2 = dec.color[r], dec.depth[r], thr_r
        colors.append(c)
        depths.append(d)
        thr2s.append(t2)
    thr2 = None if thr is None else _stack_thr(thr2s)
    return torch.stack(colors), torch.stack(depths), thr2


def _march_wave(frames, w: int, n: int, t: int, cam, spec, tf, vdi_cfg,
                thr_full, kts=None, dec: Optional[_Reuse] = None):
    """Every rank's march of tile wave ``w`` on its shared frame state,
    every slot of a rank concatenated into one stream. ``thr_full``
    (temporal mode; else None) holds each rank's full-frame threshold
    maps: each slot's wave columns are sliced out and the controller's
    update scattered back in place of the list entry. ``kts``: each
    rank's K budget target. ``dec``: a reuse decision: a clean rank
    marches nothing, its wave is the carried fragment's wave columns and
    its maps hold. Returns the rank-stacked wave fragments (color,
    depth)."""
    nj = spec.nj
    colors, depths = [], []
    for r, fr in enumerate(frames):
        if dec is not None and not dec.dirty[r]:
            colors.append(slicer.wave_cols(dec.color[r], n, t, w))
            depths.append(slicer.wave_cols(dec.depth[r], n, t, w))
            continue
        axcam_w, spec_w = slicer.wave_camera(fr.axcam, spec, n, t, w)
        parts = _slot_maps(None if thr_full is None else thr_full[r], fr,
                           nj)
        thr_w = None if parts is None else [ss.ThresholdState(*(
            slicer.wave_cols(m, n, t, w) for m in p)) for p in parts]
        c, d, thr2w = _march_units(fr, cam, spec_w, axcam_w, tf, vdi_cfg,
                                   thr_w, None if kts is None else kts[r])
        if parts is not None:
            thr_full[r] = _stack_thr([ss.ThresholdState(*(
                slicer.wave_update_cols(m, mw, n, t, w)
                for m, mw in zip(p, p2))) for p, p2 in zip(parts, thr2w)])
        colors.append(c)
        depths.append(d)
    return torch.stack(colors), torch.stack(depths)


def _waves_frame(frames, origin, cam, spec, tf, vdi_cfg, comp_cfg, n,
                 thr, topo=None, kts=None, dec: Optional[_Reuse] = None):
    """The tile-wave frame on the ranks' shared frame states, in the
    reference's pipeline order (march wave 0; composite wave w-1, march
    wave w; composite the last wave), each wave's fragments exchanged
    and composited by `_composite_exchanged` (two-level under ``topo``).
    Under reuse the marched ranks' waves fill the outgoing fragment
    column by column. Returns (VDI, meta, thr', fragments or None)."""
    t = comp_cfg.wave_tiles
    rows = spec.nj * len(frames[0].dec.units)
    thr_full = None if thr is None else \
        [_rank_thr(thr, r, rows) for r in range(n)]
    acc = None
    if dec is not None:
        if dec.dirty.any():
            acc = (torch.empty_like(dec.color), torch.empty_like(dec.depth))
            for r in range(n):
                if not dec.dirty[r]:
                    acc[0][r].copy_(dec.color[r])
                    acc[1][r].copy_(dec.depth[r])
        else:
            acc = (dec.color, dec.depth)

    def march(w):
        frag = _march_wave(frames, w, n, t, cam, spec, tf, vdi_cfg,
                           thr_full, kts, dec)
        if dec is not None and dec.dirty.any():
            for r in range(n):
                if dec.dirty[r]:
                    for a, x in zip(acc, frag):
                        _wave_put(a[r], x[r], n, t, w)
        return frag

    outs = []                       # per wave: every rank's block
    with _phase("wave"):
        frag = march(0)
        for w in range(1, t):
            outs.append(_composite_exchanged(*frag, n, comp_cfg, topo))
            frag = march(w)
        outs.append(_composite_exchanged(*frag, n, comp_cfg, topo))
        del frag
        color = _assemble_waves(outs, n, "color")
        depth = _assemble_waves(outs, n, "depth")
    fr0 = frames[0]
    meta = _global_meta(fr0.dec, fr0.axcam, spec, origin)
    thr2 = None if thr is None else _stack_thr(thr_full)
    return VDI(color, depth), meta, thr2, acc


def _wave_put(x: torch.Tensor, xw: torch.Tensor, n: int, t: int,
              w: int) -> None:
    """Write wave ``w``'s columns ``xw [..., n * wb]`` into the
    contiguous ``x [..., ni]`` in place (`slicer.wave_update_cols`
    without the copy)."""
    wb = slicer.wave_block(x.shape[-1], n, t)
    x.view(x.shape[:-1] + (n, t, wb))[..., w, :] = \
        xw.reshape(xw.shape[:-1] + (n, wb))


def distributed_vdi_step_mxu(mesh: Mesh, tf: TransferFunction,
                             spec: slicer.AxisSpec,
                             vdi_cfg: Optional[VDIConfig] = None,
                             comp_cfg: Optional[CompositeConfig] = None,
                             topology=None, plan=None, bricks=None,
                             reuse_tol: float = 0.0):
    """Distributed sort-last VDI step on the slice march. Returns
    ``f(vol_data, origin, spacing, cam) -> (VDI, meta)``.

    ``vol_data`` is the z-sharded volume (`shard_volume`). ``spec`` is the
    static `slicer.AxisSpec` of the camera regime (``make_spec(...,
    multiple_of=n)``). The VDI is the global ``[K_out, 4|2, nj, ni]``
    on the virtual axis camera's grid; ``meta`` is rank 0's metadata
    with the global volume dims. ``comp_cfg`` picks the exchange, the
    wire, the schedule, the render decomposition, the K budget and
    fragment reuse; ``plan`` (a tuple of band depths,
    ``rebalance="occupancy"``) or ``bricks`` (a `parallel.bricks.
    BrickMap`, ``rebalance="bricks"``) is the decomposition itself (see
    the module docstring). On a two-level mesh
    (``topology.make_topology_mesh``) the composite runs in two levels;
    ``topology``, a ``TopologyConfig``, is checked against the mesh and
    brings the DCN wire.

    ``comp_cfg.temporal_reuse == "ranges"`` makes the step ``f(vol_data,
    origin, spacing, cam, reuse) -> ((VDI, meta), reuse')``: seed
    ``reuse`` with `distributed_initial_reuse_mxu`; ``reuse_tol`` is the
    dirty tolerance (``FrameworkConfig.delta.range_tol``)."""
    return _build_mxu_step(mesh, tf, spec, vdi_cfg, comp_cfg,
                           temporal=False, topology=topology, plan=plan,
                           bricks=bricks, reuse_tol=reuse_tol)


def distributed_vdi_step_mxu_temporal(mesh: Mesh, tf: TransferFunction,
                                      spec: slicer.AxisSpec,
                                      vdi_cfg: Optional[VDIConfig] = None,
                                      comp_cfg: Optional[CompositeConfig]
                                      = None,
                                      topology=None, plan=None,
                                      bricks=None, reuse_tol: float = 0.0):
    """`distributed_vdi_step_mxu` with the carried per-rank temporal
    threshold state (``adaptive_mode="temporal"``: one march per rank
    per frame). Returns ``f(vol_data, origin, spacing, cam, thr) ->
    ((VDI, meta), thr')`` where ``thr`` is the rank-stacked
    ``ThresholdState`` of `distributed_initial_threshold_mxu` with the
    same ``plan`` or ``bricks`` (``[n*nj, ni]`` maps; ``[n*slots*nj,
    ni]`` under a brick map). With ``temporal_reuse="ranges"``:
    ``f(vol_data, origin, spacing, cam, thr, reuse) -> ((VDI, meta),
    thr', reuse')``; a clean rank's maps hold, since nothing was
    marched."""
    return _build_mxu_step(mesh, tf, spec, vdi_cfg, comp_cfg,
                           temporal=True, topology=topology, plan=plan,
                           bricks=bricks, reuse_tol=reuse_tol)


def _build_mxu_step(mesh, tf, spec, vdi_cfg, comp_cfg, temporal: bool,
                    topology=None, plan=None, bricks=None,
                    reuse_tol: float = 0.0):
    """The step both entries build: generate on every rank, exchange and
    composite under ``comp_cfg``, with or without the temporal threshold
    state and the reuse carry threaded through. The build's counters and
    events (ring, wire, waves, plans, bricks, the two-level composite,
    the K budget, reuse) are recorded here, once a step as the reference
    records them once a compile.

    A frame runs in two passes. Pass 1 builds every rank's frame state
    (`_RankFrame`: units, camera, permuted copy, pyramid), then the K
    budget's targets (the live fractions summed over all ranks) and the
    reuse decision (one copy of the dirty bits to the host). Pass 2
    marches the dirty ranks only, on the frame schedule or in tile
    waves; a clean rank launches no march kernel. The exchange and
    composite run as without reuse.

    On a process mesh (``multihost.global_mesh``) the step takes this
    process's slabs, marches its ranks only, exchanges the column
    blocks with one all_to_all across processes and returns this
    process's contiguous column block, the meta of its first rank (rank
    0's on process 0) and its ranks' rows of the threshold maps; only
    the reference smoke's configuration runs there (`_process_scope`)."""
    vdi_cfg = vdi_cfg or VDIConfig()
    comp_cfg = comp_cfg or CompositeConfig()
    _process_scope(mesh, comp_cfg, plan, bricks, topology)
    _, n, topo = resolve_mesh_topology(mesh, topology)
    if spec.ni % n:
        raise ValueError(f"intermediate width {spec.ni} not divisible by "
                         f"mesh size {n}")
    waves = _resolve_waves(comp_cfg, n, spec.ni)
    plan = _resolve_plan(comp_cfg, n, plan)
    bricks = _resolve_bricks(comp_cfg, n, bricks)
    budget = _resolve_budget(comp_cfg, vdi_cfg, n, bricks)
    reuse = _resolve_reuse(comp_cfg, supported=bricks is None,
                           where="the brick-partitioned MXU step")
    # a rank's fragment: K slots, or K a brick slot
    k = vdi_cfg.max_supersegments * (bricks.total_slots if bricks else 1)
    _exchange_build_markers(n, k, spec.nj, spec.ni, comp_cfg, topo, waves)
    rows_a_rank = spec.nj * (bricks.total_slots if bricks else 1)
    first, nl = mesh.first_rank, mesh.n_local

    def body(data, origin, spacing, cam, thr, ru):
        slabs = _check_sharded(data, mesh)
        rows = _frame_rows(slabs, spec, plan, bricks, mesh)
        # pass 1: every rank's frame state, targets and dirty bits (this
        # process's ranks on a process mesh)
        frames = [_RankFrame(slabs, rows, r, origin, spacing, cam, spec, tf,
                             plan, bricks, pyramid=budget or reuse,
                             first=first, n_total=n)
                  for r in range(first, first + nl)]
        del rows
        kts = _k_targets(frames, n, vdi_cfg, comp_cfg) if budget else None
        dec = None if ru is None else _reuse_decide(frames, cam, ru,
                                                    reuse_tol, k)
        # pass 2: the dirty ranks' marches, the exchange and composite
        if waves:
            out, meta, thr2, acc = _waves_frame(
                frames, origin, cam, spec, tf, vdi_cfg, comp_cfg, n, thr,
                topo, kts, dec)
            return out, meta, thr2, (None if dec is None
                                     else _reuse_carry(dec, *acc))
        color, depth, thr2 = _frame_schedule(frames, cam, spec, tf, vdi_cfg,
                                             thr, rows_a_rank, kts, dec)
        meta = _global_meta(frames[0].dec, frames[0].axcam, spec, origin)
        del frames
        ru2 = None if dec is None else _reuse_carry(dec, color, depth)
        blocks = _composite_exchanged(color, depth, n, comp_cfg, topo, mesh)
        del color, depth
        return VDI(torch.cat([b.color for b in blocks], dim=-1),
                   torch.cat([b.depth for b in blocks], dim=-1)), meta, \
            thr2, ru2

    if temporal and reuse:
        def step(vol_data, origin, spacing, cam: Camera,
                 thr: ss.ThresholdState, ru):
            out, meta, thr2, ru2 = body(vol_data, origin, spacing, cam, thr,
                                        ru)
            return (out, meta), thr2, ru2
    elif temporal:
        def step(vol_data, origin, spacing, cam: Camera,
                 thr: ss.ThresholdState):
            out, meta, thr2, _ = body(vol_data, origin, spacing, cam, thr,
                                      None)
            return (out, meta), thr2
    elif reuse:
        def step(vol_data, origin, spacing, cam: Camera, ru):
            out, meta, _, ru2 = body(vol_data, origin, spacing, cam, None,
                                     ru)
            return (out, meta), ru2
    else:
        def step(vol_data, origin, spacing, cam: Camera):
            out, meta, _, _ = body(vol_data, origin, spacing, cam, None,
                                   None)
            return out, meta
    return step


def distributed_initial_threshold_mxu(mesh: Mesh, tf: TransferFunction,
                                      spec: slicer.AxisSpec,
                                      vdi_cfg: Optional[VDIConfig] = None,
                                      plan=None, bricks=None):
    """Seeder of `distributed_vdi_step_mxu_temporal`: one histogram
    counting march per march unit of every rank (the whole frame,
    whatever the schedule), on the decomposition its step marches
    (``plan`` or ``bricks``; the mode is implied by which is given).
    Returns ``f(vol_data, origin, spacing, cam) -> ThresholdState`` with
    rank-stacked ``[n*nj, ni]`` maps (``[n*slots*nj, ni]`` under a brick
    map: one map set a slot, row-stacked). Generation is
    topology-agnostic: on a two-level mesh the maps stack in flat rank
    order, as the step carries them. The seed builds no K budget: it
    picks against K, as the reference's does. On a process mesh each
    process seeds its own ranks and keeps their maps: the thresholds are
    rank-local, no collective."""
    vdi_cfg = vdi_cfg or VDIConfig()
    _process_scope(mesh, plan=plan, bricks=bricks)
    _, n, _ = resolve_mesh_topology(mesh)
    plan = _resolve_plan("occupancy", n, plan)
    bricks = _resolve_bricks("bricks", n, bricks)
    first, nl = mesh.first_rank, mesh.n_local

    def seed(vol_data, origin, spacing, cam: Camera) -> ss.ThresholdState:
        slabs = _check_sharded(vol_data, mesh)
        rows = _frame_rows(slabs, spec, plan, bricks, mesh)
        states = []
        # the seed is one counting march a unit (K2 on a card)
        with _phase("march"):
            for r in range(first, first + nl):
                dec = _rank_units(slabs, rows, r, origin, spacing, spec,
                                  plan, bricks, first, n)
                axcam = slicer.make_axis_camera(dec.ref, cam, spec,
                                                box_min=origin,
                                                box_max=dec.gmax)
                states += [slicer.initial_threshold(
                    u.vol, tf, cam, spec, vdi_cfg, v_bounds=u.v_bounds,
                    w_bounds=u.w_bounds, axcam=_unit_camera(axcam, u.f),
                    step_scale=1.0 / u.f) for u in dec.units]
            return ss.ThresholdState(*(torch.cat(parts)
                                       for parts in zip(*states)))

    return seed


def distributed_initial_reuse_mxu(mesh: Mesh, tf: TransferFunction,
                                  spec: slicer.AxisSpec,
                                  vdi_cfg: Optional[VDIConfig] = None,
                                  comp_cfg: Optional[CompositeConfig] = None,
                                  plan=None):
    """Seeder of a ``temporal_reuse="ranges"`` step: ``f(vol_data,
    origin, spacing, cam) -> ReuseState`` with ``valid = 0`` for every
    rank, so the first frame marches every rank and fills the carry.
    The signature's length comes from the frame state the step builds
    (one pyramid a rank, on its slab or its ``plan`` band), so the
    shapes agree; the seed builds no K budget. On a two-level mesh the
    carry is seeded over the flat rank view: it is per-rank state the
    composite levels never see."""
    from scenery_insitu_tpu_torch.ops import delta as _delta
    from scenery_insitu_tpu_torch.ops import occupancy as _occ

    vdi_cfg = vdi_cfg or VDIConfig()
    comp_cfg = comp_cfg or CompositeConfig()
    _process_scope(mesh, builder="distributed_initial_reuse_mxu")
    _, n, _ = resolve_mesh_topology(mesh)
    plan = _resolve_plan(comp_cfg, n, plan)

    def seed(vol_data, origin, spacing, cam: Camera):
        slabs = _check_sharded(vol_data, mesh)
        rows = _frame_rows(slabs, spec, plan)
        dec = _rank_units(slabs, rows, 0, origin, spacing, spec, plan)
        pyr = _occ.pyramid_from_volume(dec.units[0].vol, tf, spec)
        sig = _delta.reuse_signature(pyr, cam)
        return _delta.init_reuse_like(sig, vdi_cfg.max_supersegments,
                                      spec.nj, spec.ni, n=n)

    return seed



# ------------------------------------------------------ the hybrid frame


def distributed_hybrid_step_mxu(mesh: Mesh, tf: TransferFunction,
                                spec: slicer.AxisSpec,
                                vdi_cfg: Optional[VDIConfig] = None,
                                comp_cfg: Optional[CompositeConfig] = None,
                                radius: float = 0.02, stamp: int = 5,
                                colormap: str = "jet",
                                temporal: bool = False, plan=None,
                                bricks=None, topology=None):
    """Distributed hybrid volume + particle frame (the reference's
    BASELINE Config 5): the z-sharded volume through the sort-last slice
    march VDI chain, the N-sharded tracers through the sort-first splat
    (`parallel.particles.sort_first_splat` on the virtual camera's
    rays), and the particle layer depth-inserted into every rank's
    composited column block (``ops/hybrid.py``).

    Returns ``f(vol_data, origin, spacing, tracer_world, tracer_vel, cam)
    -> (image f32[4, nj, ni], meta)``: the image on the intermediate grid
    (every rank's block side by side; warp it to the display camera with
    ``slicer.warp_to_camera``), ``vol_data`` the slabs of `shard_volume`
    and the tracers the rank shards of
    ``parallel.particles.shard_particles``. ``temporal=True`` threads the
    carried per-rank threshold maps as `distributed_vdi_step_mxu_temporal`
    does (seed with `distributed_initial_threshold_mxu`): ``f(..., cam,
    thr) -> ((image, meta), thr')``.

    ``comp_cfg`` takes every exchange, wire and schedule of the VDI
    steps (under ``schedule="waves"`` the VDI half runs in tile waves and
    the particles insert into the assembled blocks), ``plan`` a render
    plan, ``topology`` the two-level composite (rank r's block is
    `_out_block_index`'s). A brick map and fragment reuse go on the
    ledger inert: the hybrid frame re-splats its particles every frame."""
    from scenery_insitu_tpu_torch.ops.hybrid import (
        composite_vdi_with_particles)
    from scenery_insitu_tpu_torch.ops.splat import SplatOutput
    from scenery_insitu_tpu_torch.parallel.particles import (
        _check_particles, sort_first_splat)

    vdi_cfg = vdi_cfg or VDIConfig()
    comp_cfg = comp_cfg or CompositeConfig()
    _process_scope(mesh, builder="distributed_hybrid_step_mxu")
    _, n, topo = resolve_mesh_topology(mesh, topology)
    if spec.ni % n:
        raise ValueError(f"intermediate width {spec.ni} not divisible by "
                         f"mesh size {n}")
    waves = _resolve_waves(comp_cfg, n, spec.ni)
    plan = _resolve_plan(comp_cfg, n, plan)
    _bricks_inert(bricks, "the hybrid step")
    _resolve_reuse(comp_cfg, supported=False, where="the hybrid step")
    _exchange_build_markers(n, vdi_cfg.max_supersegments, spec.nj, spec.ni,
                            comp_cfg, topo, waves)
    wb = spec.ni // n

    def body(data, origin, spacing, tr_pos, tr_vel, cam, thr):
        slabs = _check_sharded(data, mesh)
        rows = _frame_rows(slabs, spec, plan)
        frames = [_RankFrame(slabs, rows, r, origin, spacing, cam, spec, tf,
                             plan) for r in range(n)]
        del rows
        if waves:
            vdi, meta, thr2, _ = _waves_frame(frames, origin, cam, spec, tf,
                                              vdi_cfg, comp_cfg, n, thr,
                                              topo)
            blocks = [VDI(vdi.color[..., j * wb:(j + 1) * wb],
                          vdi.depth[..., j * wb:(j + 1) * wb])
                      for j in range(n)]
        else:
            color, depth, thr2 = _frame_schedule(frames, cam, spec, tf,
                                                 vdi_cfg, thr, spec.nj,
                                                 None, None)
            meta = _global_meta(frames[0].dec, frames[0].axcam, spec,
                                origin)
            blocks = _composite_exchanged(color, depth, n, comp_cfg, topo)
            del color, depth
        # the sort-first particle pass on the shared virtual camera's rays
        axcam = frames[0].axcam
        with _phase("march"):
            sp = sort_first_splat(_check_particles(tr_pos, mesh),
                                  _check_particles(tr_vel, mesh), spec.ni,
                                  spec.nj, radius, stamp, colormap,
                                  view=axcam.view, proj=axcam.proj)
        out = [None] * n
        with _phase("merge"):
            for r in range(n):
                # rank r's column block of the particle layer
                b = _out_block_index(topo, r)
                cols = slice(b * wb, (b + 1) * wb)
                out[b] = composite_vdi_with_particles(
                    blocks[b], SplatOutput(sp.image[..., cols],
                                           sp.depth[..., cols]))
        return torch.cat(out, dim=-1), meta, thr2

    if temporal:
        def step(vol_data, origin, spacing, tr_pos, tr_vel, cam: Camera,
                 thr: ss.ThresholdState):
            img, meta, thr2 = body(vol_data, origin, spacing, tr_pos,
                                   tr_vel, cam, thr)
            return (img, meta), thr2
    else:
        def step(vol_data, origin, spacing, tr_pos, tr_vel, cam: Camera):
            img, meta, _ = body(vol_data, origin, spacing, tr_pos, tr_vel,
                                cam, None)
            return img, meta
    return step


# ------------------------------------------------------ the gather engine


def _bricks_inert(bricks, where: str) -> None:
    """A builder with no brick march says a configured brick partition
    is inert (on the ledger) and renders the even decomposition."""
    if bricks is not None:
        _obs.degrade("bricks.partition", "bricks", "slabs",
                     f"{where} has no brick march (gather/MXU VDI steps "
                     "only); the even z-slab decomposition renders",
                     warn=False)


def _local_volume_and_clip(slabs: torch.Tensor, rows: torch.Tensor, r: int,
                           origin: torch.Tensor, spacing: torch.Tensor,
                           plan=None, first: int = 0,
                           n_total: Optional[int] = None):
    """Rank r's halo-padded Volume for the gather engine, its own clip
    box and the GLOBAL sample box: ``(vol, clip_min, clip_max,
    sample_min, sample_max)``. ``rows`` holds every rank's rows with one
    halo slice a side (`halo_exchange_z`, or the ``plan``'s bands from
    `reslab_z`, padded to ``max(plan)``: the clip box keeps the pad
    unsampled). The clip boxes tile the global volume (rank r's top
    face and rank r+1's bottom face are the same f32 expression) and
    every rank ladders its samples on the global box, so the composite
    equals the single-device frame whatever the decomposition. ``r`` is
    the global rank; ``slabs`` and ``rows`` hold ranks ``first ..`` of
    ``n_total`` (a process mesh's, or a host's in the two-level host
    path; default: every rank)."""
    _, dn, h, w = slabs.shape
    n = n_total or slabs.shape[0]
    dz = spacing[2]
    g0, depth = (r * dn, dn) if plan is None else (sum(plan[:r]), plan[r])
    vol = Volume(rows[r - first], _shifted(origin, float(g0 - 1) * dz),
                 spacing)
    gmax = origin + torch.tensor([w, h, dn * n], dtype=torch.float32,
                                 device=origin.device) * spacing
    z_lo = origin[2] + float(g0) * dz
    z_hi = origin[2] + float(g0 + depth) * dz
    return (vol, torch.stack([origin[0], origin[1], z_lo]),
            torch.stack([gmax[0], gmax[1], z_hi]), origin, gmax)


def _brick_clip_units(slabs: torch.Tensor, bands: torch.Tensor, r: int,
                      origin: torch.Tensor, spacing: torch.Tensor,
                      bmap: BrickMap):
    """`_local_volume_and_clip`'s brick twin: rank r's ``(volume,
    clip_min, clip_max)`` a brick slot from ``bands`` (`reslab_bricks`
    with one halo slice), None for an absent slot, and the global box's
    max corner. The clip boxes tile the global volume as the slabs' do
    and the samples ladder on the global box, so the frame does not
    depend on which rank owns a brick. Every brick samples at level 0:
    the gather engine has no coarse march."""
    n, dn, h, w = slabs.shape
    dz = spacing[2]
    gmax = origin + torch.tensor([w, h, dn * n], dtype=torch.float32,
                                 device=origin.device) * spacing
    bz = bmap.brick_depth
    units = []
    for s, start in enumerate(bmap.start_table()[r]):
        start = int(start)                                 # -1 = absent
        if start < 0:
            units.append(None)
            continue
        vol = Volume(bands[r, s], _shifted(origin, float(start - 1) * dz),
                     spacing)
        z_lo = origin[2] + float(start) * dz
        z_hi = origin[2] + float(start + bz) * dz
        units.append((vol, torch.stack([origin[0], origin[1], z_lo]),
                      torch.stack([gmax[0], gmax[1], z_hi])))
    return units, gmax


def _assemble_waves(outs, n: int, field: str = None) -> torch.Tensor:
    """Every wave's per-rank blocks -> the frame: column block j is its
    wave tiles side by side, the blocks in column order. ``outs[w][j]``
    is a tensor, or a VDI whose ``field`` is taken."""
    pick = (lambda x: x) if field is None else \
        (lambda x: getattr(x, field))
    return torch.cat([pick(o[j]) for j in range(n) for o in outs], dim=-1)


def _composite_exchanged_waves(color: torch.Tensor, depth: torch.Tensor,
                               n: int, comp_cfg: CompositeConfig,
                               topo=None) -> VDI:
    """Tile-wave exchange and composite of full-frame fragments (the
    gather engine marches the frame once): every wave's column blocks of
    the rank-stacked fragments through `_composite_exchanged`, in wave
    order, reassembled; per pixel the frame schedule's result."""
    t = comp_cfg.wave_tiles
    with _phase("wave"):
        outs = [_composite_exchanged(slicer.wave_cols(color, n, t, w),
                                     slicer.wave_cols(depth, n, t, w), n,
                                     comp_cfg, topo) for w in range(t)]
        return VDI(_assemble_waves(outs, n, "color"),
                   _assemble_waves(outs, n, "depth"))


def distributed_vdi_step(mesh: Mesh, tf: TransferFunction, width: int,
                         height: int, vdi_cfg: Optional[VDIConfig] = None,
                         comp_cfg: Optional[CompositeConfig] = None,
                         max_steps: int = 256, plan=None, bricks=None,
                         topology=None):
    """Distributed sort-last VDI step on the gather engine. Returns
    ``f(vol_data, origin, spacing, cam) -> VDI`` with the global
    ``[K_out, 4|2, height, width]``.

    Every rank marches ``max_steps`` samples a ray over the GLOBAL box
    (`ops/vdi_gen.generate_vdi`), owning the samples inside its clip box
    (`_local_volume_and_clip`; a ``plan``'s band, or one clip box a
    brick slot of ``bricks``, `_brick_clip_units`), and the fragments go
    through the exchange and composite of ``comp_cfg``: all_to_all or
    ring, f32, bf16 or qpack8 wires, frame or tile waves (which only
    exchange and composite wave by wave: the march is one for the
    frame), flat or two-level (``topology``, see
    `distributed_vdi_step_mxu`). The K budget and fragment reuse need
    the slice march's pyramid and carry: configured here they go on the
    ledger inert, as the reference records them. On a process mesh
    (``multihost.global_mesh``) each process marches its own ranks, the
    seam rows cross process boundaries, and the step returns this
    process's contiguous column block (`_process_scope` says what runs
    there)."""
    vdi_cfg = vdi_cfg or VDIConfig()
    comp_cfg = comp_cfg or CompositeConfig()
    _process_scope(mesh, comp_cfg, plan, bricks, topology)
    _, n, topo = resolve_mesh_topology(mesh, topology)
    first, nl = mesh.first_rank, mesh.n_local
    if width % n:
        raise ValueError(f"width {width} not divisible by mesh size {n}")
    waves = _resolve_waves(comp_cfg, n, width)
    if comp_cfg.k_budget == "occupancy":
        _obs.degrade("occupancy.k_budget", "occupancy", "static",
                     "gather-engine distributed step has no occupancy "
                     "pyramid (mxu builders only)", warn=False)
    _resolve_reuse(comp_cfg, supported=False,
                   where="the gather-engine distributed step")
    plan = _resolve_plan(comp_cfg, n, plan)
    bricks = _resolve_bricks(comp_cfg, n, bricks)
    if bricks is not None and bricks.max_level:
        _obs.degrade("lod.engine", "lod", "fine",
                     "the gather engine has no LOD march (MXU builders "
                     "only); every brick samples at level 0", warn=False)
    k_seg = vdi_cfg.max_supersegments
    k = k_seg * (bricks.slots if bricks else 1)
    _exchange_build_markers(n, k, height, width, comp_cfg, topo, waves,
                            marched=False)

    def step(vol_data, origin, spacing, cam: Camera) -> VDI:
        slabs = _check_sharded(vol_data, mesh)
        with _phase("halo"):
            if bricks is not None:
                bands = reslab_bricks(slabs, bricks, h=1)
            else:
                rows = (halo_exchange_z(slabs, mesh=mesh) if plan is None
                        else reslab_z(slabs, plan, h=1))
        colors, depths = [], []
        for r in range(first, first + nl):
            if bricks is not None:
                units, gmax = _brick_clip_units(slabs, bands, r, origin,
                                                spacing, bricks)
            else:
                vol, cmin, cmax, _, gmax = _local_volume_and_clip(
                    slabs, rows, r, origin, spacing, plan, first, n)
                units = [(vol, cmin, cmax)]
            cs, ds = [], []
            for unit in units:
                if unit is None:
                    # an absent slot owns no sample: its fragment is
                    # empty, whatever the transfer function gives 0
                    cs.append(torch.zeros((k_seg, 4, height, width),
                                          device=origin.device))
                    ds.append(torch.full((k_seg, 2, height, width),
                                         torch.inf, device=origin.device))
                    continue
                vol, cmin, cmax = unit
                with _phase("march"):
                    vdi, _ = generate_vdi(vol, tf, cam, width, height,
                                          vdi_cfg, max_steps=max_steps,
                                          clip_min=cmin, clip_max=cmax,
                                          sample_min=origin,
                                          sample_max=gmax)
                cs.append(vdi.color)
                ds.append(vdi.depth)
            colors.append(_cat_slots(cs))
            depths.append(_cat_slots(ds))
        color, depth = torch.stack(colors), torch.stack(depths)
        del colors, depths
        if waves:
            return _composite_exchanged_waves(color, depth, n, comp_cfg,
                                              topo)
        blocks = _composite_exchanged(color, depth, n, comp_cfg, topo, mesh)
        return VDI(torch.cat([b.color for b in blocks], dim=-1),
                   torch.cat([b.depth for b in blocks], dim=-1))

    return step


# -------------------------------------------------------- plain images


def _out_block_index(topo, r: int) -> int:
    """The output column block of flat rank r: r itself on a flat mesh;
    on a two-level mesh the composite hands rank (h, d) = (r // D, r %
    D) block ``d * H + h`` (``Topology.out_axis``)."""
    if topo is None:
        return r
    h, d = divmod(r, topo.domain_size)
    return d * topo.num_hosts + h


def _exchange_plain_columns(images: torch.Tensor, depths: torch.Tensor,
                            n: int, wire: str = "f32",
                            hop_scope: str = "exchange"):
    """Column all_to_all of the rank-stacked plain fragments (``images
    [n, 4, H, W]``, ``depths [n, H, W]``) on ``wire``: each fragment is
    encoded once against its own scale, every received block decoded
    against its sender's. Returns f32 ``([n_dst, n_src, 4, H, W/n],
    [n_dst, n_src, H, W/n])``. ``hop_scope`` names the exchange's
    phase."""
    if wire == "f32":
        return (_exchange_columns(images, n, hop_scope),
                _exchange_columns(depths, n, hop_scope))
    with _phase("wire_encode"):
        enc = [_wire.encode_plain(i, d, wire)
               for i, d in zip(images, depths)]
        ei = torch.stack([e[0] for e in enc])
        ed = torch.stack([e[1] for e in enc])
    ri = _exchange_columns(ei, n, hop_scope)
    rd = _exchange_columns(ed, n, hop_scope)
    scales = None if enc[0][2] is None else \
        torch.stack([e[2] for e in enc])[None]
    with _phase("wire_encode"):
        return _wire.decode_plain(ri, rd, scales, wire)


def _composite_plain_exchanged(images: torch.Tensor, depths: torch.Tensor,
                               n: int, background, wire: str = "f32",
                               topo=None) -> List[torch.Tensor]:
    """Exchange on ``wire`` and nearest-first composite
    (`composite_plain`, the background blended once) of the rank-stacked
    plain fragments. Returns every rank's composited column block ``[4,
    H, W/n]`` in column order. The ring delivers the all_to_all's
    blocks bit for bit (every fragment is encoded once, against its own
    scale, and a plain fragment has no working set to cap), so both
    schedules run this one exchange; the ring shows in the build
    markers. ``topo`` runs the two-level composite
    (``parallel/hier.py``)."""
    if topo is not None:
        from scenery_insitu_tpu_torch.parallel.hier import (
            hier_composite_plain)

        return hier_composite_plain(images, depths, topo, background, wire)
    ri, rd = _exchange_plain_columns(images, depths, n, wire)
    with _phase("merge"):
        return [composite_plain(ri[j], rd[j], background)
                for j in range(n)]


def _composite_plain_waves(images: torch.Tensor, depths: torch.Tensor,
                           n: int, background, wire: str,
                           wave_tiles: int, march_wave=None,
                           topo=None) -> torch.Tensor:
    """The tile-wave plain frame: wave by wave, the rank-stacked wave
    fragments exchanged and composited (`_composite_plain_exchanged`),
    then reassembled into the frame schedule's layout. ``march_wave(w)
    -> (images_w, depths_w)`` renders each wave (the slice march's
    wave cameras); None slices the full-frame ``images``/``depths`` the
    gather engine rendered once."""
    t = wave_tiles
    if march_wave is None:
        def march_wave(w):
            return (slicer.wave_cols(images, n, t, w),
                    slicer.wave_cols(depths, n, t, w))
    with _phase("wave"):
        outs = [_composite_plain_exchanged(*march_wave(w), n, background,
                                           wire, topo)
                for w in range(t)]
        return _assemble_waves(outs, n)


def _plain_build_markers(n: int, h: int, w: int, knobs: CompositeConfig,
                         topo, waves: bool, marched: bool) -> None:
    """The build markers of a plain step's exchange: the wave schedule
    (one slot a pixel, one output slot), the ring's hops, the two-level
    levels and a lossy wire's encode."""
    rec = _obs.get_recorder()
    if waves:
        _wave_build_marker(n, knobs.wave_tiles, 1, h, w, dataclasses.replace(
            knobs, max_output_supersegments=1), marched)
    w_step = w // (knobs.wave_tiles if waves else 1)
    ring_n = n if topo is None else topo.domain_size
    if knobs.exchange == "ring" and ring_n > 1:
        rec.count("ring_exchange_builds")
        ring_hop_markers(ring_n, 1, h, w_step // ring_n, knobs.wire)
    if topo is not None:
        rec.count("hier_composite_builds")
        rec.count("hier_plain_levels")
        ring_hop_markers(topo.num_hosts, 1, h, w_step // topo.n_ranks,
                         topo.dcn_wire, dcn=True)
        if topo.dcn_wire != "f32":
            _wire_build_marker(topo.dcn_wire)
    if knobs.wire != "f32":
        _wire_build_marker(knobs.wire)


def distributed_plain_step_mxu(mesh: Mesh, tf: TransferFunction,
                               spec: slicer.AxisSpec,
                               cfg: Optional[RenderConfig] = None,
                               comp_cfg: Optional[CompositeConfig] = None,
                               plan=None, bricks=None, topology=None):
    """Distributed plain image on the slice march (the reference's
    non-VDI mode). Returns ``f(vol_data, origin, spacing, cam) ->
    (image f32[4, nj, ni], axcam)``: every rank's `slicer.render_slices`
    of its slab (or ``plan`` band) on the shared virtual camera, the
    column exchange and the nearest-first composite, background-free on
    the intermediate grid; ``axcam`` (every rank's, the same) warps it
    to the display camera, which blends the background once:
    ``slicer.warp_to_camera(image, axcam, spec, cam, width, height,
    background)``.

    ``comp_cfg`` carries the exchange (``exchange`` "all_to_all" |
    "ring", ``wire`` "f32" | "bf16" | "qpack8"), the schedule (under
    ``schedule="waves"`` every rank renders one column-block wave of
    ``wave_tiles`` at a time on its wave camera, one permuted copy and
    one occupancy gate a frame, and each wave is exchanged and
    composited) and ``rebalance`` with ``plan``; ``topology`` runs the
    two-level composite: as on the VDI steps. ``bricks`` and
    ``comp_cfg.temporal_reuse`` go on the ledger inert.

    ``cfg.ao_strength > 0``: every rank pre-shades its slab (or band)
    with the TF and the occlusion (``ops/ao.shade_volume_ao``) on a halo
    ``ao_radius + 1`` slices deep (`_shaded_rows`), and marches the
    pre-shaded volume without a TF: seam-exact against the single-device
    pre-shaded render. A plan's bands must then be at least
    ``ao_radius + 1`` slices deep."""
    cfg = cfg or RenderConfig()
    comp_cfg = comp_cfg or CompositeConfig()
    _process_scope(mesh, builder="distributed_plain_step_mxu")
    _, n, topo = resolve_mesh_topology(mesh, topology)
    if spec.ni % n:
        raise ValueError(f"intermediate width {spec.ni} not divisible by "
                         f"mesh size {n}")
    ao_on = cfg.ao_strength > 0.0
    waves = _resolve_waves(comp_cfg, n, spec.ni)
    plan = _resolve_plan(comp_cfg, n, plan,
                         min_halo=cfg.ao_radius + 1 if ao_on else 1)
    _bricks_inert(bricks, "the plain-image MXU step")
    _resolve_reuse(comp_cfg, supported=False, where="the plain-image MXU step")
    _plain_build_markers(n, spec.nj, spec.ni, comp_cfg, topo, waves,
                         marched=True)
    bg = (0.0, 0.0, 0.0, 0.0)
    # the ranks march the pre-shaded volume without a TF
    tf_r = None if ao_on else tf
    if ao_on:
        shade = lambda v: _ao.shade_volume_ao(v, tf, cfg.ao_radius,
                                              cfg.ao_strength)

    def step(vol_data, origin, spacing, cam: Camera):
        slabs = _check_sharded(vol_data, mesh)
        if ao_on:
            rows = _shaded_rows(slabs, spec, origin, spacing, shade,
                                cfg.ao_radius, plan)
        else:
            rows = _frame_rows(slabs, spec, plan)
        units, axcams = [], []
        for r in range(n):
            dec = _rank_units(slabs, rows, r, origin, spacing, spec, plan)
            units.append(dec.units[0])
            axcams.append(slicer.make_axis_camera(dec.ref, cam, spec,
                                                  box_min=origin,
                                                  box_max=dec.gmax))
        del rows

        def render(u, axcam, spec_u, **kw):
            with _phase("march"):
                return slicer.render_slices(
                    u.vol, tf_r, axcam, spec_u, cfg.early_exit_alpha,
                    v_bounds=u.v_bounds, step_scale=cfg.step_scale,
                    w_bounds=u.w_bounds, **kw)

        if waves:
            with _phase("march"):
                volps = [slicer.permute_volume(u.vol, spec) for u in units]
                occs = [slicer.occupancy_for(u.vol, tf_r, spec, volp=vp)
                        for u, vp in zip(units, volps)]

            def march_wave(w):
                outs = []
                for u, axcam, vp, occ in zip(units, axcams, volps, occs):
                    axcam_w, spec_w = slicer.wave_camera(
                        axcam, spec, n, comp_cfg.wave_tiles, w)
                    outs.append(render(u, axcam_w, spec_w, occupancy=occ,
                                       volp=vp))
                return (torch.stack([o.image for o in outs]),
                        torch.stack([o.depth for o in outs]))

            img = _composite_plain_waves(None, None, n, bg, comp_cfg.wire,
                                         comp_cfg.wave_tiles, march_wave, topo)
            return img, axcams[0]
        outs = [render(u, axcam, spec) for u, axcam in zip(units, axcams)]
        images = torch.stack([o.image for o in outs])
        depths = torch.stack([o.depth for o in outs])
        del outs
        return torch.cat(_composite_plain_exchanged(
            images, depths, n, bg, comp_cfg.wire, topo), dim=-1), axcams[0]

    return step


def distributed_plain_step(mesh: Mesh, tf: TransferFunction, width: int,
                           height: int, cfg: Optional[RenderConfig] = None,
                           comp_cfg: Optional[CompositeConfig] = None,
                           plan=None, bricks=None, topology=None):
    """Distributed plain image on the gather engine (the reference's
    non-VDI mode: raycast and plain-image composite). Returns
    ``f(vol_data, origin, spacing, cam) -> image f32[4, height,
    width]``: every rank raycasts its slab (or ``plan`` band) with the
    global sample ladder and its own clip box, background-free, and the
    fragments are exchanged and composited nearest-first with
    ``cfg.background`` blended once. ``comp_cfg``, ``plan``, ``bricks``
    and ``topology``: see `distributed_plain_step_mxu`
    (``schedule="waves"`` exchanges and
    composites wave by wave; the march is one for the frame). With
    ``cfg.ao_strength > 0`` each rank's occlusion field is blurred on a
    radius-deep halo (``ao_radius + 1`` slices a side) and trimmed to
    the one-slice halo the raycaster samples: seam-exact against the
    single-device AO render."""
    cfg = cfg or RenderConfig(width=width, height=height)
    comp_cfg = comp_cfg or CompositeConfig()
    _process_scope(mesh, builder="distributed_plain_step")
    _, n, topo = resolve_mesh_topology(mesh, topology)
    if width % n:
        raise ValueError(f"width {width} not divisible by mesh size {n}")
    ao_on = cfg.ao_strength > 0.0
    waves = _resolve_waves(comp_cfg, n, width)
    plan = _resolve_plan(comp_cfg, n, plan,
                         min_halo=cfg.ao_radius + 1 if ao_on else 1)
    _bricks_inert(bricks, "the plain-image gather step")
    _resolve_reuse(comp_cfg, supported=False,
                   where="the plain-image gather step")
    _plain_build_markers(n, height, width, comp_cfg, topo, waves,
                         marched=False)
    # rank partials stay background-free (the composite blends it
    # once); the AO field is built here on the radius-deep halo
    rank_cfg = dataclasses.replace(cfg, background=(0.0, 0.0, 0.0, 0.0),
                                   ao_strength=0.0)
    hr = cfg.ao_radius + 1

    def step(vol_data, origin, spacing, cam: Camera) -> torch.Tensor:
        slabs = _check_sharded(vol_data, mesh)
        with _phase("halo"):
            if plan is None:
                rows = halo_exchange_z(slabs)
                ext = halo_exchange_z(slabs, h=hr) if ao_on else None
                n_keep = slabs.shape[1]
            else:
                rows = reslab_z(slabs, plan, h=1)
                ext = reslab_z(slabs, plan, h=hr) if ao_on else None
                n_keep = int(max(plan))
        images, depths = [], []
        for r in range(n):
            vol, cmin, cmax, smin, smax = _local_volume_and_clip(
                slabs, rows, r, origin, spacing, plan)
            ao_vol = None
            with _phase("march"):
                if ao_on:
                    occ = _ao.occlusion_field(
                        _ao.tf_alpha(Volume(ext[r], vol.origin, spacing),
                                     tf), cfg.ao_radius, cfg.ao_strength)
                    ao_vol = Volume(occ[hr - 1:hr + n_keep + 1], vol.origin,
                                    spacing)
                out = raycast(vol, tf, cam, width, height, rank_cfg,
                              clip_min=cmin, clip_max=cmax, ao_field=ao_vol,
                              sample_min=smin, sample_max=smax)
            images.append(out.image)
            depths.append(out.depth)
        images, depths = torch.stack(images), torch.stack(depths)
        if waves:
            return _composite_plain_waves(images, depths, n,
                                          cfg.background, comp_cfg.wire,
                                          comp_cfg.wave_tiles, topo=topo)
        return torch.cat(_composite_plain_exchanged(
            images, depths, n, cfg.background, comp_cfg.wire, topo), dim=-1)

    return step
