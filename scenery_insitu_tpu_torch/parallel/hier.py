"""The two-level sort-last VDI composite across domains (the device path
of the reference's ``parallel/hier.py``).

Past one fast domain the composite splits in two, as the reference
splits it over its ``(hosts, ranks)`` mesh:

level 1   inside each domain (ICI), the existing exchange over the
          domain's D ranks only (``exchange`` ``"all_to_all"`` or
          ``"ring"``, on ``CompositeConfig.wire``), stopped before the
          resegment: rank (h, d) holds column block d of its domain as a
          per-pixel sorted accumulator of D·K slots (the ring's capped at
          ``ring_slots``).
level 2   across domains (DCN), every accumulator is encoded once for
          ``TopologyConfig.dcn_wire`` against one scale spanning it (a
          merged D·K stream over the whole scene depth, not one slab's
          band) and cut into H column sub-blocks; rank (h, d) decodes
          sub-block h of every host's domain-d accumulator and merges
          them pairwise in ring arrival order h, h+1, ... with
          wrap-around, uncapped (ties go to the accumulator).
the top   one resegment (K4 on a card) a rank, of a stream of D·K·H =
          N·K slots, the flat composite's length.

The plain-image composite splits the same way
(`hier_composite_plain`): level 1 folds each domain's fragments into a
background-free partial with its nearest depth, level 2 exchanges the
partials across domains on the DCN wire and folds them with the
background.

Rank (h, d)'s block lands at flat position ``d * H + h``
(``Topology.out_axis``), so the blocks side by side in that order are
the frame's columns in natural order. With f32 wires every merge moves
payloads unchanged, so the merged stream is the flat composite's up to
the order of bit-identical start depths, which follows arrival order in
the reference too. On the in-process mesh the ranks run in turn and no
byte crosses a link; the traffic is modelled (`modeled_dcn_traffic`).
The K budget and fragment reuse (``CompositeConfig.k_budget``,
``temporal_reuse``) act on the march, which runs over the flat rank view
(``parallel/pipeline.py``): the budget sums the live fractions of all N
ranks, the reuse carry is seeded and stacked by flat rank, and a clean
rank's carried fragment enters level 1 as a marched one would; the
levels never see either.

The host path runs the same algebra across processes, for runtimes
whose DCN hop rides the delivery plane (the reference's CPU harness):
each host marches its slab block on its own in-process mesh and runs
level 1 there (`domain_partial_vdi_step`: the gather engine, then
`domain_accumulate`), with the cross-host halo rows handed in
(`host_block`); it ships the accumulator's column blocks to the head
as tile streams (`publish_partial_tiles`, ``VDIPublisher.publish_tile``
on the sequenced, CRC-checked substrate); the head merges each tile's
partials as they arrive and resegments once (`HierTileAssembler`,
`merge_partial_blocks`: K4 on a card), so a complete frame equals the
flat composite bit for bit. A lost host costs its slab's content, not
the frame: the head composes without it, degraded, and ledgers
``multihost.host_down``. `run_host_path` is one process's part of a
host-path frame in a fleet (``parallel/multihost.py``).
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch import obs as _obs
from scenery_insitu_tpu_torch.config import CompositeConfig, VDIConfig
from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata
from scenery_insitu_tpu_torch.device import resolve_device
from scenery_insitu_tpu_torch.obs.profiler import phase as _phase
from scenery_insitu_tpu_torch.ops import wire as _wire
from scenery_insitu_tpu_torch.ops.composite import (
    composite_plain, modeled_exchange_traffic, resegment_stream, sort_stream)
from scenery_insitu_tpu_torch.parallel.mesh import halo_exchange_z
from scenery_insitu_tpu_torch.parallel.pipeline import (
    _check_sharded, _column_blocks, _exchange_plain_columns,
    _exchange_vdi_columns, _local_volume_and_clip, _out_block_index,
    _ring_accumulate, _ring_blocks, _ring_cap, ring_hop_markers)
from scenery_insitu_tpu_torch.parallel.topology import Topology
from scenery_insitu_tpu_torch.runtime.streaming import _host

Stream = Tuple[torch.Tensor, torch.Tensor]

GAP_EPS = 1e-4


# ---------------------------------------------------------- traffic model


def modeled_dcn_traffic(num_hosts: int, domain_size: int, k: int,
                        height: int, width: int, dcn_wire: str = "f32",
                        ring_slots: int = 0) -> dict:
    """Modeled DCN bytes of one frame's inter-domain hop; the
    reference's model, key for key.

    What crosses DCN is the level-1 accumulator: ``D * K`` slots a pixel
    lossless, ``min(D*K, ring_slots)`` under a capped ring. Each rank
    ships its ``1/(D*H)`` column sub-block to the other ``H - 1``
    domains at the ``dcn_wire`` slot widths; a host sums its D ranks.
    Sent equals received. A model: on one card no byte crosses a
    link."""
    cb, db = _wire.wire_slot_bytes(dcn_wire)
    m = domain_size * k
    if ring_slots:
        m = min(int(ring_slots), m)
    sub = max(width // max(domain_size * num_hosts, 1), 1)
    per_rank = (num_hosts - 1) * m * height * sub * (cb + db)
    return {
        "hosts": num_hosts, "domain_size": domain_size, "k": k,
        "dcn_wire": dcn_wire, "slots_per_pixel": m,
        "dcn_bytes_sent_per_rank": per_rank,
        "dcn_bytes_sent_per_host": domain_size * per_rank,
        "dcn_bytes_received_per_host": domain_size * per_rank,
    }


def _hier_build_marker(topo: Topology, k: int, h: int, w: int,
                       comp_cfg: CompositeConfig) -> None:
    """One two-level composite built (a fragment ``[K, ., h, w]``): its
    counter, the event with the modeled intra-domain (ICI) and
    inter-domain (DCN) traffic, and one counter and event a hop of each
    ring: the level-1 ring's ``ring_steps_built``/``ring_step`` (under
    ``exchange="ring"``) and the DCN ring's ``dcn_hops_built``/
    ``dcn_hop``."""
    rec = _obs.get_recorder()
    d, hosts = topo.domain_size, topo.num_hosts
    rec.count("hier_composite_builds")
    rec.event(
        "hier_composite_build", hosts=hosts, domain_size=d, k=k,
        dcn_wire=topo.dcn_wire,
        ici=modeled_exchange_traffic(
            d, k, h, w, k_out=comp_cfg.max_output_supersegments,
            mode=comp_cfg.exchange, ring_slots=comp_cfg.ring_slots,
            wire=comp_cfg.wire),
        dcn=modeled_dcn_traffic(hosts, d, k, h, w, dcn_wire=topo.dcn_wire,
                                ring_slots=comp_cfg.ring_slots))
    if comp_cfg.exchange == "ring" and d > 1:
        ring_hop_markers(d, k, h, w // d, comp_cfg.wire)
    cap = _ring_cap(comp_cfg, k) if comp_cfg.exchange == "ring" else None
    m = min(cap, d * k) if cap else d * k
    ring_hop_markers(hosts, m, h, w // (d * hosts), topo.dcn_wire,
                     dcn=True)


# ------------------------------------------------------------- the levels


def domain_accumulate(color: torch.Tensor, depth: torch.Tensor,
                      comp_cfg: CompositeConfig) -> List[Stream]:
    """Level 1 of one domain: the rank-stacked fragments of its D ranks
    (``color [D, K, 4, H, W]``, ``depth [D, K, 2, H, W]``) exchanged
    under ``comp_cfg.exchange`` on ``comp_cfg.wire``, stopped before the
    resegment. Returns, for each domain position d, the sorted
    accumulator of column block d (``[M, 4|2, H, W/D]``; M = D·K, or
    the ring's ``ring_slots`` cap). The exchanged blocks die here."""
    d, k = color.shape[:2]
    if comp_cfg.exchange == "ring" and d > 1:
        cap = _ring_cap(comp_cfg, k)
        blocks = _ring_blocks(color, depth, d, comp_cfg.wire)
        return [_ring_accumulate(blocks, j, comp_cfg.wire, cap)
                for j in range(d)]
    rc, rd = _exchange_vdi_columns(color, depth, d, comp_cfg.wire)
    _, _, _, _, h, w = rc.shape
    with _phase("merge"):
        return [sort_stream(rc[j].reshape(d * k, 4, h, w),
                            rd[j].reshape(d * k, 2, h, w))
                for j in range(d)]


def dcn_accumulate(accs: List[List[Stream]], topo: Topology
                   ) -> List[Stream]:
    """Level 2: ``accs[h][d]`` is host h's domain-d accumulator (sorted,
    its empty slots' colours zeroed). Each is encoded once for the DCN
    wire against its own scale and cut into H column sub-blocks; rank
    (h, d) merges sub-block h of every host's domain-d accumulator in
    arrival order h, h+1, ... (wrap-around), uncapped. Returns the
    merged streams in output order (position ``d * H + h``)."""
    hosts, d, wire = topo.num_hosts, topo.domain_size, topo.dcn_wire
    out = []
    for j in range(d):
        blocks = []
        for h in range(hosts):
            with _phase("wire_encode"):
                ec, ed, scale = _wire.encode_fragment(*accs[h][j], wire)
            blocks.append((_column_blocks(ec, hosts),
                           _column_blocks(ed, hosts), scale))
        out += [_ring_accumulate(blocks, h, wire, None, hop_scope="dcn_hop")
                for h in range(hosts)]
    return out


def hier_accumulate(color: torch.Tensor, depth: torch.Tensor,
                    topo: Topology, comp_cfg: CompositeConfig
                    ) -> List[Stream]:
    """Both levels on the rank-stacked fragments ``[N, K, ...]`` (flat
    rank ``h * D + d``): every rank's merged N·K stream, not yet
    resegmented, in output order."""
    d = topo.domain_size
    accs = [domain_accumulate(color[h * d:(h + 1) * d],
                              depth[h * d:(h + 1) * d], comp_cfg)
            for h in range(topo.num_hosts)]
    return dcn_accumulate(accs, topo)


def hier_composite_vdi(color: torch.Tensor, depth: torch.Tensor,
                       topo: Topology, comp_cfg: CompositeConfig
                       ) -> List[VDI]:
    """The two-level composite of the rank-stacked fragments: both
    levels, then one resegment a rank at the top. Returns every rank's
    composited column block in output order, so the blocks side by side
    are the frame's columns."""
    out = []
    for sc, sd in hier_accumulate(color, depth, topo, comp_cfg):
        with _phase("resegment"):
            out.append(resegment_stream(sc, sd, comp_cfg))
    return out


def hier_composite_plain(images: torch.Tensor, depths: torch.Tensor,
                         topo: Topology, background,
                         wire: str) -> List[torch.Tensor]:
    """The two-level plain-image composite of the rank-stacked fragments
    (``images [N, 4, H, W]``, ``depths [N, H, W]``, flat rank ``h * D +
    d``). Level 1: each domain's D fragments exchanged on ``wire`` (the
    ring delivers the all_to_all's blocks bit for bit, so one exchange
    serves both schedules) and folded nearest-first into
    background-free domain partials, each with its nearest depth
    (alpha-under is associative over depth-ordered groups, and domains
    are disjoint z bands, so that depth orders level 2). Level 2: the
    partials' column sub-blocks exchanged across domains on
    ``topo.dcn_wire`` and folded with the background, once. Returns the column blocks in output order (`_out_block_index`),
    which side by side are the frame's columns."""
    d, hosts = topo.domain_size, topo.num_hosts
    clear = (0.0, 0.0, 0.0, 0.0)
    partials = []                          # [h][j]: (partial, depth)
    for h in range(hosts):
        ims, dps = images[h * d:(h + 1) * d], depths[h * d:(h + 1) * d]
        ri, rd = _exchange_plain_columns(ims, dps, d, wire)
        with _phase("merge"):
            partials.append([(composite_plain(ri[j], rd[j], clear),
                              torch.amin(rd[j], dim=0)) for j in range(d)])
    out = [None] * (hosts * d)
    for j in range(d):
        pi = torch.stack([partials[h][j][0] for h in range(hosts)])
        pd = torch.stack([partials[h][j][1] for h in range(hosts)])
        ri, rd = _exchange_plain_columns(pi, pd, hosts, topo.dcn_wire,
                                         hop_scope="dcn_hop")
        with _phase("merge"):
            for h in range(hosts):
                out[_out_block_index(topo, h * d + j)] = composite_plain(
                    ri[h], rd[h], background)
    return out


# -------------------------------------------------------------- host path


def host_block(field, process_id: int, d_local: int, n_total: int):
    """Host ``process_id``'s slab block of a global field ``f32[D, H,
    W]`` (an array or a memmap: only the block and its two halo rows are
    read) and its cross-host halo rows: ``(block [d_local * D/n, H, W],
    halo_lo [1, H, W], halo_hi [1, H, W])``. A halo row is the
    neighbouring host's boundary slice, or this host's own at a global
    edge (one device's clamp-to-edge)."""
    gz = field.shape[0]
    dn = gz // n_total
    lo, hi = process_id * d_local * dn, (process_id + 1) * d_local * dn
    rows = lambda a, b: np.ascontiguousarray(field[a:b], np.float32)
    return (rows(lo, hi), rows(lo - 1, lo) if lo > 0 else rows(0, 1),
            rows(hi, hi + 1) if hi < gz else rows(gz - 1, gz))


def _host_rows(slabs: torch.Tensor, halo_lo: torch.Tensor,
               halo_hi: torch.Tensor) -> torch.Tensor:
    """The local slabs ``[d, Dn, H, W]`` with one halo slice a side:
    `halo_exchange_z` inside the host, and the cross-host halo rows in
    place of its clamped copies at the host's edges. With
    `pipeline._local_volume_and_clip` placed at the host's first global
    rank, the twin of the reference's ``_offset_slab_and_clip``."""
    rows = halo_exchange_z(slabs)
    rows[0, :1] = halo_lo.to(rows.device, rows.dtype)
    rows[-1, -1:] = halo_hi.to(rows.device, rows.dtype)
    return rows


def domain_partial_vdi_step(mesh, tf, width: int, height: int,
                            vdi_cfg: Optional[VDIConfig] = None,
                            comp_cfg: Optional[CompositeConfig] = None,
                            max_steps: int = 256, rank_offset: int = 0,
                            n_total: Optional[int] = None):
    """This host's half of the two-level composite (host path): the
    gather-engine march of the host's share of the global z
    decomposition on its own flat in-process ``mesh``, then level 1
    (`domain_accumulate`) over the mesh's ranks, NOT resegmented; that
    happens once, on the head, after the DCN hop (`HierTileAssembler`).

    Returns ``f(local_slabs f32[d, D/n, H, W] (`mesh.shard_volume` of
    the host's block), origin f32[3] (GLOBAL), spacing f32[3], cam,
    halo_lo f32[1, H, W], halo_hi f32[1, H, W]) -> (acc_color [M, 4,
    height, width], acc_depth [M, 2, height, width])``: local rank j's
    sorted accumulator of column block j at columns ``[j * width/d, (j +
    1) * width/d)``, M = d * K. Host p of H hosts with d-rank domains
    passes ``rank_offset = p * d``, ``n_total = H * d``."""
    vdi_cfg = vdi_cfg or VDIConfig()
    comp_cfg = comp_cfg or CompositeConfig()
    if mesh.spans_processes or mesh.num_hosts > 1:
        raise ValueError("the host path runs each host's ranks as a flat "
                         "in-process mesh (parallel/mesh.make_mesh)")
    d = mesh.n
    nt = n_total or d
    if width % d:
        raise ValueError(f"width {width} not divisible by the local mesh "
                         f"size {d}")
    from scenery_insitu_tpu_torch.ops.vdi_gen import generate_vdi

    def step(local_data, origin, spacing, cam, halo_lo, halo_hi):
        slabs = _check_sharded(local_data, mesh)
        rows = _host_rows(slabs, halo_lo, halo_hi)
        colors, depths = [], []
        for r in range(rank_offset, rank_offset + d):
            vol, cmin, cmax, smin, smax = _local_volume_and_clip(
                slabs, rows, r, origin, spacing, first=rank_offset,
                n_total=nt)
            vdi, _ = generate_vdi(vol, tf, cam, width, height, vdi_cfg,
                                  max_steps=max_steps, clip_min=cmin,
                                  clip_max=cmax, sample_min=smin,
                                  sample_max=smax)
            colors.append(vdi.color)
            depths.append(vdi.depth)
        del rows
        accs = domain_accumulate(torch.stack(colors), torch.stack(depths),
                                 comp_cfg)
        del colors, depths
        return (torch.cat([c for c, _ in accs], dim=-1),
                torch.cat([z for _, z in accs], dim=-1))

    return step


def publish_partial_tiles(pub, acc_c, acc_d, meta, tiles: int) -> int:
    """Ship one host's domain-partial accumulator over DCN as the tile
    stream: ``tiles`` column blocks through ``VDIPublisher.publish_tile``
    (seq, epoch and CRC continuity, the optional qpack8 pre-codec, all
    from the substrate). Returns the wire bytes sent, counted on the
    ``dcn_bytes_sent`` obs counter, one ``dcn_send`` span a tile."""
    c = np.ascontiguousarray(_host(acc_c))
    d = np.ascontiguousarray(_host(acc_d))
    wb = c.shape[-1] // tiles
    frame = int(_host(meta.index))
    rec = _obs.get_recorder()
    sent = 0
    for t in range(tiles):
        with rec.span("dcn_send", frame=frame, tile=t):
            nb = pub.publish_tile(
                VDI(c[..., t * wb:(t + 1) * wb],
                    d[..., t * wb:(t + 1) * wb]),
                meta, tile=t, tiles=tiles, col0=t * wb)
        rec.count("dcn_bytes_sent", nb)
        sent += nb
    return sent


def merge_partial_blocks(parts: List[Tuple[np.ndarray, np.ndarray]],
                         comp_cfg: Optional[CompositeConfig] = None,
                         gap_eps: float = GAP_EPS, device=None) -> VDI:
    """The head's top of the two-level composite: the hosts' partial
    accumulators of the SAME columns (in host order) concatenated,
    sorted per pixel (stably, so ties keep host order, then slot order:
    the flat composite's rank order) and resegmented ONCE on ``device``
    (None means CUDA: K4), as the flat composite folds after its global
    sort; a complete merge equals the flat frame."""
    dev = resolve_device(device)
    comp_cfg = comp_cfg or CompositeConfig()
    with warnings.catch_warnings():
        # a received tile is a read-only view of its message; the
        # concatenation copies it and nothing writes through the view
        warnings.simplefilter("ignore", UserWarning)
        flat_c = torch.cat([torch.as_tensor(c, device=dev)
                            for c, _ in parts])
        flat_d = torch.cat([torch.as_tensor(z, device=dev)
                            for _, z in parts])
    with _phase("merge"):
        sc, sd = sort_stream(flat_c, flat_d)
    del flat_c, flat_d
    with _phase("resegment"):
        return resegment_stream(sc, sd, comp_cfg, gap_eps)


class HierTileAssembler:
    """Incremental head assembly of the hosts' domain-partial tile
    streams (``multihost.gather_vdi_tiles`` generalized from
    concatenation to a sort-last merge): feed each arriving ``(host,
    vdi, meta, tile)`` from a host's `VDISubscriber.receive_tile`; the
    moment a column block has all ``num_hosts`` partials it is merged on
    ``device`` (`merge_partial_blocks`) and emitted, so the head has the
    first columns while later tiles are still in flight.

    A host that stays silent follows the head node's semantics:
    `flush_incomplete` composes each pending block from the partials
    that DID arrive, stamps it degraded and ledgers
    ``multihost.host_down``; one lost host costs its slab's content, not
    the frame."""

    def __init__(self, num_hosts: int,
                 comp_cfg: Optional[CompositeConfig] = None,
                 gap_eps: float = GAP_EPS, device=None):
        self.num_hosts = num_hosts
        self.comp_cfg = comp_cfg or CompositeConfig()
        self.gap_eps = gap_eps
        self.device = resolve_device(device)
        # (frame, tile) -> {host: (color, depth, col0)}
        self._parts: Dict[Tuple[int, int], Dict[int, tuple]] = {}
        self.stats = {"tiles_in": 0, "blocks_out": 0, "degraded": 0,
                      "dcn_bytes_received": 0}

    def add(self, host: int, vdi, meta, tile: dict,
            nbytes: int = 0) -> List[tuple]:
        """Feed one received tile; returns the finished blocks it
        completes as ``[(frame, tile_idx, col0, VDI, degraded)]``."""
        frame = int(_host(meta.index))
        key = (frame, int(tile["tile"]))
        self.stats["tiles_in"] += 1
        if nbytes:
            self.stats["dcn_bytes_received"] += nbytes
            _obs.get_recorder().count("dcn_bytes_received", nbytes)
        slot = self._parts.setdefault(key, {})
        slot[int(host)] = (vdi.color, vdi.depth, int(tile["col0"]))
        if len(slot) < self.num_hosts:
            return []
        return [self._emit(key, degraded=False)]

    def _emit(self, key, degraded: bool) -> tuple:
        slot = self._parts.pop(key)
        col0 = next(iter(slot.values()))[2]
        with _obs.get_recorder().span("dcn_merge", frame=key[0],
                                      tile=key[1]):
            out = merge_partial_blocks(
                [slot[h][:2] for h in sorted(slot)], self.comp_cfg,
                self.gap_eps, self.device)
            if out.color.is_cuda:      # the span is the merge's time
                torch.cuda.synchronize(out.color.device)
        self.stats["blocks_out"] += 1
        if degraded:
            self.stats["degraded"] += 1
        return (key[0], key[1], col0, out, degraded)

    def flush_incomplete(self) -> List[tuple]:
        """Compose every pending block from the partials that arrived:
        emitted blocks carry ``degraded=True`` and each incomplete block
        lands on the ledger as ``multihost.host_down``."""
        out = []
        for key in sorted(self._parts):
            missing = self.num_hosts - len(self._parts[key])
            _obs.degrade(
                "multihost.host_down", f"{self.num_hosts} hosts",
                f"{self.num_hosts - missing} hosts",
                "a host's domain partial never arrived; the block "
                "composites without its slab content (degraded)",
                warn=False)
            out.append(self._emit(key, degraded=True))
        return out


def assemble_hier_frame(subs, num_hosts: int,
                        comp_cfg: Optional[CompositeConfig] = None,
                        tiles: Optional[int] = None,
                        timeout_ms: int = 10_000, gap_eps: float = GAP_EPS,
                        device=None):
    """The head's loop over per-host subscribers ``{host:
    VDISubscriber}``: drain ``tiles`` column blocks from every host's
    stream, merge incrementally on ``device`` (`HierTileAssembler`),
    and return the assembled frame ``(VDI of host arrays, degraded)`` in
    column order. Hosts still silent at ``timeout_ms`` degrade (their
    content is dropped, the frame still assembles) rather than stalling
    the fleet; ``(None, True)`` when nothing arrived."""
    asm = HierTileAssembler(num_hosts, comp_cfg, gap_eps, device)
    done: Dict[int, tuple] = {}
    want: Optional[int] = tiles
    deadline = time.monotonic() + timeout_ms / 1000.0
    while want is None or len(done) < want:
        if time.monotonic() > deadline:
            break
        for host, sub in subs.items():
            got = sub.receive_tile(timeout_ms=200)
            if got is None or hasattr(got, "kind"):      # timeout / drop
                continue
            vdi, meta, tile = got
            if tile is None:
                continue
            if want is None:
                want = int(tile["tiles"])
            nb = getattr(sub, "last_recv_bytes", 0)
            for _, t, col0, block, deg in asm.add(host, vdi, meta, tile,
                                                  nbytes=nb):
                done[t] = (col0, block, deg)
    degraded = False
    for _, t, col0, block, deg in asm.flush_incomplete():
        if t not in done:
            done[t] = (col0, block, deg)
            degraded = True
    if not done:
        return None, True
    blocks = [done[t] for t in sorted(done)]
    color = np.concatenate([_host(b.color) for _, b, _ in blocks], axis=-1)
    depth = np.concatenate([_host(b.depth) for _, b, _ in blocks], axis=-1)
    degraded = degraded or any(d for _, _, d in blocks)
    return VDI(color, depth), degraded


def run_host_path(process_id: int, num_processes: int, field, tf, cam,
                  origin, spacing, width: int, height: int,
                  vdi_cfg: VDIConfig, comp_cfg: CompositeConfig,
                  ranks: int, device=None, max_steps: int = 256,
                  frames: int = 1, codec: str = "zlib",
                  precision: str = "f32", silent=(),
                  timeout_ms: int = 120_000) -> dict:
    """One process's part of ``frames`` host-path frames of ``field``
    (the global ``f32[D, H, W]``, an array or a memmap; only this
    host's block is read) in a fleet (``multihost.initialize``): its
    ``ranks`` ranks as a local mesh on ``device``, its domain partial
    (`domain_partial_vdi_step`) published as ``ranks`` tiles over
    loopback (``codec``, ``precision``), endpoints exchanged through the
    store, barriers on both sides of the subscriptions (zmq's slow
    joiners), and process 0 the head (`assemble_hier_frame` on
    ``device``). Hosts in ``silent`` publish nothing (the lost-host
    drill; give a short ``timeout_ms``). Every frame starts at a barrier;
    a fleet may run the host path again (each barrier has generations).

    Returns lists a frame: ``"sent"`` (this host's wire bytes) and
    ``"step_ms"`` (its step and publish, host clock); on the head also
    ``"frames"`` (``(color, depth, degraded)`` host arrays), ``"ms"``
    (barrier to assembled frame, host clock), ``"received"`` (wire bytes
    the head took in) and ``"merge_ms"`` (the ``dcn_merge`` spans: the
    head's merges on ``device``, each waited for)."""
    from scenery_insitu_tpu_torch.parallel import multihost as mh
    from scenery_insitu_tpu_torch.parallel.mesh import (make_mesh,
                                                        shard_volume)
    from scenery_insitu_tpu_torch.runtime.streaming import (VDIPublisher,
                                                            VDISubscriber)

    pid, nproc = process_id, num_processes
    mesh = make_mesh(ranks, device)
    dev = mesh.device
    n_total = nproc * ranks
    local, hlo, hhi = host_block(field, pid, ranks, n_total)
    slabs = shard_volume(torch.from_numpy(local), mesh)
    hlo, hhi = torch.from_numpy(hlo).to(dev), torch.from_numpy(hhi).to(dev)
    step = domain_partial_vdi_step(mesh, tf, width, height, vdi_cfg,
                                   comp_cfg, max_steps, pid * ranks, n_total)
    gz, gy, gx = field.shape
    meta = VDIMetadata.create(torch.eye(4), torch.eye(4),
                              volume_dims=(gx, gy, gz),
                              window_dims=(width, height))
    rec = _obs.get_recorder()
    pub = VDIPublisher(bind="tcp://127.0.0.1:0", codec=codec,
                       precision=precision, epoch=100 + pid)
    mh.kv_put_bytes(f"hier/ep/{pid}", pub.endpoint.encode())
    mh.barrier("hier_eps")
    subs = None
    if pid == 0:
        subs = {h: VDISubscriber(connect=mh.kv_get_bytes(
            f"hier/ep/{h}").decode()) for h in range(nproc)}
        time.sleep(0.5)                    # zmq slow-joiner settle
    mh.barrier("hier_subs")
    out = {"sent": [], "step_ms": []}
    if pid == 0:
        out.update(frames=[], ms=[], merge_ms=[], received=[])
    try:
        for f in range(frames):
            mh.barrier("hier_frame", timeout_ms=600_000)
            t0 = time.perf_counter()
            acc_c, acc_d = step(slabs, origin, spacing, cam, hlo, hhi)
            out["sent"].append(0 if pid in silent else publish_partial_tiles(
                pub, acc_c, acc_d, meta._replace(
                    index=torch.tensor(f, dtype=torch.int32)), ranks))
            del acc_c, acc_d
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            if pid == 0:
                merge0 = rec.timers.stats["dcn_merge"].total
                recv0 = rec.counters.get("dcn_bytes_received", 0)
                frame, degraded = assemble_hier_frame(
                    subs, nproc, comp_cfg, tiles=ranks,
                    timeout_ms=timeout_ms, device=dev)
                out["ms"].append((time.perf_counter() - t0) * 1e3)
                out["merge_ms"].append(
                    (rec.timers.stats["dcn_merge"].total - merge0) * 1e3)
                out["received"].append(
                    rec.counters.get("dcn_bytes_received", 0) - recv0)
                out["frames"].append((None, None, True) if frame is None
                                     else (frame.color, frame.depth,
                                           degraded))
        mh.barrier("hier_done", timeout_ms=600_000)
    finally:
        pub.close()
        for s in (subs or {}).values():
            s.close()
    return out
