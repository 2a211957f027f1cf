"""Brick-to-rank render partitions (``CompositeConfig.rebalance ==
"bricks"``).

A contiguous render decomposition gives rank r one z band (the even
slab, or a planned band of ``ops/occupancy.slice_plan``). The sort-last
composite never needs convexity: ``merge_vdis_pairwise`` and
``resegment_stream`` take per-pixel depth-sorted fragment streams
whatever region produced them. A ``BrickMap`` makes the assignment
explicit: the global z extent splits into ``nbricks`` equal bricks and
an ``owner`` table says which rank marches which brick.
``parallel/mesh.reslab_bricks`` assembles each rank's brick set from
the even sim slabs, the distributed step marches every brick through
the slice march (its ``w_bounds``/``v_bounds`` become per-brick
intervals), and permuting brick ownership leaves the composited frame
unchanged.

`steal_plan` re-plans the map between frames: greedy per-brick
live-work equalization from the field's z live profile, with hysteresis
and a move cap per replan so the session rebuilds rarely and by small
deltas. Per-brick refinement levels (``level``) carry the LOD march
(`parallel/lod.py`).

Host-side numpy: a BrickMap is build-time geometry, like a render plan
tuple.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BrickMap:
    """A regular brick grid over the global volume z extent plus an
    arbitrary brick→rank owner table.

    ``depth`` is the global z slice count, split into ``len(owner)``
    equal bricks (``depth % nbricks == 0`` — the even grid keeps
    materialization and ownership masks static); ``owner[i]`` is the
    rank that marches brick ``i`` (any value in ``[0, n_ranks)``; ranks
    may own zero bricks — their march units come up empty). Per-rank
    brick sets pad to ``slots`` = the busiest rank's count, so one SPMD
    program serves every rank; absent slots are dead (zero rows, empty
    ownership interval, occupancy admits them as dead).

    ``level[i]`` is brick ``i``'s refinement level (the LOD march): level ``l`` marches a ``2^l``-downsampled copy of the
    brick through the same slice-march machinery (materialized by
    `parallel.mesh.reslab_bricks_lod`; supersegments composite
    unchanged — the fragment stream is resolution-agnostic). The empty
    tuple (the default) normalizes to all-zero, and an all-level-0 map
    is EXACTLY the flat map: every code path, `is_even_convex`
    included, behaves bitwise as before. For SPMD shape uniformity the
    builders group march units BY LEVEL (`slots_at`/`start_table_at`):
    each level present anywhere pads to its own global slot count."""

    depth: int
    n_ranks: int
    owner: Tuple[int, ...]
    level: Tuple[int, ...] = ()

    def __post_init__(self):
        owner = tuple(int(o) for o in self.owner)
        object.__setattr__(self, "owner", owner)
        nb = len(owner)
        if nb < 1:
            raise ValueError("a BrickMap needs at least one brick")
        if self.depth < 1 or self.depth % nb:
            raise ValueError(
                f"{nb} bricks do not evenly divide depth {self.depth} "
                f"(the regular brick grid keeps ownership masks static)")
        if self.n_ranks < 1:
            raise ValueError(f"n_ranks must be >= 1, got {self.n_ranks}")
        bad = [o for o in owner if not 0 <= o < self.n_ranks]
        if bad:
            raise ValueError(
                f"brick owners {sorted(set(bad))} outside the "
                f"{self.n_ranks}-rank mesh (owner table: {owner})")
        level = tuple(int(l) for l in self.level) or (0,) * nb
        object.__setattr__(self, "level", level)
        if len(level) != nb:
            raise ValueError(
                f"level table has {len(level)} entries for {nb} bricks")
        bz = self.depth // nb
        for i, l in enumerate(level):
            if l < 0:
                raise ValueError(f"brick {i} has negative level {l}")
            if bz % (1 << l):
                raise ValueError(
                    f"brick {i} at level {l}: downsample factor "
                    f"{1 << l} does not divide the {bz}-slice brick "
                    f"depth (coarse voxels must tile the brick exactly)")

    # ------------------------------------------------------------ geometry
    @property
    def nbricks(self) -> int:
        return len(self.owner)

    @property
    def brick_depth(self) -> int:
        """Slices per brick (bz)."""
        return self.depth // self.nbricks

    @property
    def slots(self) -> int:
        """Padded per-rank brick-slot count B = max bricks any rank owns
        (every rank marches B units; absent slots are dead)."""
        return max(len(self.rank_bricks(r)) for r in range(self.n_ranks))

    def rank_bricks(self, rank: int) -> Tuple[int, ...]:
        """Ascending brick ids owned by ``rank`` (deterministic slot
        order — invariance tests rely on the composite, not this)."""
        return tuple(i for i, o in enumerate(self.owner) if o == rank)

    def start_table(self) -> np.ndarray:
        """i32[n_ranks, slots] global START ROW of each rank's brick
        slots (``brick_id * brick_depth``), -1 for absent slots — the
        static table the distributed builders index by the traced rank
        id."""
        bz = self.brick_depth
        table = np.full((self.n_ranks, self.slots), -1, np.int32)
        for r in range(self.n_ranks):
            for s, b in enumerate(self.rank_bricks(r)):
                table[r, s] = b * bz
        return table

    def intervals(self, rank: int) -> List[Tuple[int, int]]:
        """[z0, z1) global slice intervals of ``rank``'s bricks."""
        bz = self.brick_depth
        return [(b * bz, (b + 1) * bz) for b in self.rank_bricks(rank)]

    # ------------------------------------------------------------- levels
    @property
    def max_level(self) -> int:
        return max(self.level)

    def levels_present(self) -> Tuple[int, ...]:
        """Ascending distinct refinement levels anywhere in the map —
        GLOBAL, so every rank builds the same per-level unit groups
        (SPMD shape uniformity; ranks owning no brick at a level march
        dead slots there)."""
        return tuple(sorted(set(self.level)))

    def rank_bricks_at(self, rank: int, level: int) -> Tuple[int, ...]:
        """Ascending brick ids owned by ``rank`` AT ``level``."""
        return tuple(i for i, (o, l) in enumerate(zip(self.owner,
                                                      self.level))
                     if o == rank and l == level)

    def slots_at(self, level: int) -> int:
        """Padded per-rank slot count of one level's unit group."""
        return max(len(self.rank_bricks_at(r, level))
                   for r in range(self.n_ranks))

    def start_table_at(self, level: int) -> np.ndarray:
        """i32[n_ranks, slots_at(level)] global start rows of each
        rank's level-``level`` brick slots, -1 for absent slots (the
        per-level twin of `start_table`; identical to it on an
        all-level-0 map)."""
        bz = self.brick_depth
        table = np.full((self.n_ranks, self.slots_at(level)), -1,
                        np.int32)
        for r in range(self.n_ranks):
            for s, b in enumerate(self.rank_bricks_at(r, level)):
                table[r, s] = b * bz
        return table

    @property
    def total_slots(self) -> int:
        """March units per rank across every level group (== ``slots``
        on an all-level-0 map) — the slot count the row-stacked temporal
        threshold state and the concatenated fragment stream carry."""
        return sum(self.slots_at(l) for l in self.levels_present())

    def with_levels(self, levels: Sequence[int]) -> "BrickMap":
        """Same ownership, new per-brick refinement levels (validated
        by construction)."""
        return BrickMap(self.depth, self.n_ranks, self.owner,
                        tuple(int(l) for l in levels))

    # ---------------------------------------------------------- structure
    def is_even_convex(self) -> bool:
        """Does this map reproduce the even contiguous z-slab split?
        True ⇒ the builders short-circuit to the pre-brick path
        (bitwise identical to a brickless step). Any coarse level keeps
        the brick path alive — only an ALL-FINE even map is the slab."""
        if any(self.level):
            return False
        nb, n = self.nbricks, self.n_ranks
        if nb % n:
            return False
        per = nb // n
        return all(o == i // per for i, o in enumerate(self.owner))

    def permute(self, perm: Sequence[int]) -> "BrickMap":
        """Relabel ranks: brick owned by r moves to ``perm[r]`` — the
        composite-invariance test's ownership shuffle (levels ride
        their bricks)."""
        perm = [int(p) for p in perm]
        if sorted(perm) != list(range(self.n_ranks)):
            raise ValueError(f"perm {perm} is not a permutation of "
                             f"0..{self.n_ranks - 1}")
        return BrickMap(self.depth, self.n_ranks,
                        tuple(perm[o] for o in self.owner), self.level)

    # -------------------------------------------------------- constructors
    @classmethod
    def even(cls, depth: int, n_ranks: int,
             nbricks: int = 0) -> "BrickMap":
        """The even contiguous map: ``nbricks`` (default ``n_ranks``)
        bricks owned in rank order — `is_even_convex` by construction."""
        nb = nbricks or n_ranks
        if nb % n_ranks:
            raise ValueError(f"even map needs n_ranks | nbricks, got "
                             f"{n_ranks} ranks x {nb} bricks")
        per = nb // n_ranks
        return cls(depth, n_ranks, tuple(i // per for i in range(nb)))

    @classmethod
    def contiguous(cls, depth: int, n_ranks: int,
                   nbricks: int) -> "BrickMap":
        """Balanced contiguous seed map for ANY brick count (`even` when
        ``n_ranks | nbricks``): brick i goes to rank ``i * n // nb`` —
        the steal planner's starting point when the auto brick count
        does not divide evenly by the rank count."""
        return cls(depth, n_ranks,
                   tuple(min(i * n_ranks // nbricks, n_ranks - 1)
                         for i in range(nbricks)))


def auto_nbricks(depth: int, n_ranks: int, target_per_rank: int = 4) -> int:
    """Default brick count of ``rebalance="bricks"``: the largest
    divisor of ``depth`` at most ``target_per_rank * n_ranks`` (fine
    enough to steal by, coarse enough that per-brick march overhead
    stays small), floored at ``n_ranks`` bricks when the depth allows."""
    cap = max(n_ranks, target_per_rank * n_ranks)
    nb = min(depth, cap)
    while depth % nb:
        nb -= 1
    return nb


# ------------------------------------------------------ brick-work model


def brick_work(live_profile, depth: int, nbricks: int,
               base_cost: Optional[float] = None) -> np.ndarray:
    """f64[nbricks] modeled march work per brick from a per-z-bin live
    profile (`ops.occupancy.z_live_profile`) under the slice work
    model: a live slice costs 1 + base, an empty one base (air is cheap,
    not free — the brick march still scans its chunks)."""
    from scenery_insitu_tpu_torch.ops.occupancy import (PLAN_BASE_COST,
                                                  _slice_work)

    if base_cost is None:
        base_cost = PLAN_BASE_COST
    if depth % nbricks:
        raise ValueError(f"{nbricks} bricks do not divide depth {depth}")
    w = _slice_work(live_profile, depth, base_cost)
    return w.reshape(nbricks, depth // nbricks).sum(axis=1)


def rank_work(bmap: BrickMap, work: np.ndarray) -> np.ndarray:
    """f64[n_ranks] summed brick work per owner."""
    out = np.zeros(bmap.n_ranks, np.float64)
    np.add.at(out, np.asarray(bmap.owner), np.asarray(work, np.float64))
    return out


def straggler_factor(bmap: BrickMap, work: np.ndarray) -> float:
    """max/mean per-rank modeled work — the frame-barrier term
    brick-stealing attacks (1.0 = perfectly balanced)."""
    loads = rank_work(bmap, work)
    return float(np.max(loads) / max(float(np.mean(loads)), 1e-12))


def steal_plan(prev: BrickMap, work: np.ndarray, max_moves: int = 2,
               hysteresis: float = 0.1) -> BrickMap:
    """Greedy brick-stealing re-plan (CompositeConfig.rebalance ==
    "bricks"): starting from ``prev``, move up to ``max_moves`` bricks
    from the most- to the least-loaded rank, each move picking the
    donor brick whose work best halves the pair's gap. Deterministic
    (numpy argmax/argmin tie-break to the lowest index), host-side.

    ``hysteresis``: stop (and return ``prev`` OBJECT-EQUAL when nothing
    moved) once ``max - min`` per-rank load falls within ``hysteresis *
    mean`` — the session keys recompiles on map identity, so a stable
    scene must converge to zero moves, not oscillate. The move cap
    bounds both the per-replan recompile delta and the reslab traffic a
    single replan can add.

    Refinement levels ride their bricks unchanged through every move;
    pass ``work`` already scaled to LEVEL UNITS (a level-l brick costs
    a fraction of its fine self — parallel/lod.level_work_scale) so the
    equalizer balances what the ranks actually march."""
    work = np.asarray(work, np.float64)
    if work.shape != (prev.nbricks,):
        raise ValueError(f"work has {work.shape} entries for "
                         f"{prev.nbricks} bricks")
    owner = np.asarray(prev.owner, np.int64).copy()
    n = prev.n_ranks
    loads = rank_work(prev, work)
    mean = max(float(loads.mean()), 1e-12)
    moved = 0
    while moved < max(int(max_moves), 0):
        donor = int(np.argmax(loads))
        recv = int(np.argmin(loads))
        gap = loads[donor] - loads[recv]
        if donor == recv or gap <= hysteresis * mean:
            break
        cand = np.nonzero(owner == donor)[0]
        if cand.size == 0:
            break
        # moving w shrinks the pair's |imbalance| iff w < gap; pick the
        # one closest to gap/2 (best single-move equalizer)
        w = work[cand]
        ok = w < gap
        if not ok.any():
            break
        score = np.where(ok, np.abs(w - gap / 2.0), np.inf)
        b = int(cand[int(np.argmin(score))])
        owner[b] = recv
        loads[donor] -= work[b]
        loads[recv] += work[b]
        moved += 1
    if not moved:
        return prev
    return BrickMap(prev.depth, n, tuple(int(o) for o in owner),
                    prev.level)
