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
levels never see either. The host path (domain partials shipped to a head as tile streams) is
ROADMAP A8b items 8–9.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from scenery_insitu_tpu_torch import obs as _obs
from scenery_insitu_tpu_torch.config import CompositeConfig
from scenery_insitu_tpu_torch.core.vdi import VDI
from scenery_insitu_tpu_torch.ops import wire as _wire
from scenery_insitu_tpu_torch.ops.composite import (
    composite_plain, modeled_exchange_traffic, resegment_stream, sort_stream)
from scenery_insitu_tpu_torch.parallel.pipeline import (
    _column_blocks, _exchange_plain_columns, _exchange_vdi_columns,
    _out_block_index, _ring_accumulate, _ring_blocks, _ring_cap,
    ring_hop_markers)
from scenery_insitu_tpu_torch.parallel.topology import Topology

Stream = Tuple[torch.Tensor, torch.Tensor]


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
    return [sort_stream(rc[j].reshape(d * k, 4, h, w),
                        rd[j].reshape(d * k, 2, h, w)) for j in range(d)]


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
            ec, ed, scale = _wire.encode_fragment(*accs[h][j], wire)
            blocks.append((_column_blocks(ec, hosts),
                           _column_blocks(ed, hosts), scale))
        out += [_ring_accumulate(blocks, h, wire, None)
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
    return [resegment_stream(sc, sd, comp_cfg)
            for sc, sd in hier_accumulate(color, depth, topo, comp_cfg)]


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
        partials.append([(composite_plain(ri[j], rd[j], clear),
                          torch.amin(rd[j], dim=0)) for j in range(d)])
    out = [None] * (hosts * d)
    for j in range(d):
        pi = torch.stack([partials[h][j][0] for h in range(hosts)])
        pd = torch.stack([partials[h][j][1] for h in range(hosts)])
        ri, rd = _exchange_plain_columns(pi, pd, hosts, topo.dcn_wire)
        for h in range(hosts):
            out[_out_block_index(topo, h * d + j)] = composite_plain(
                ri[h], rd[h], background)
    return out
