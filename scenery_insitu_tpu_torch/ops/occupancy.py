"""Occupancy pyramid: the empty-space structure of the slice march.

Per (chunk x v-tile) cell value ranges of the march-layout volume, and
the gates derived from them by pushing each range through the transfer
function's conservative bound (``tf.max_alpha_in``). The ranges come
from one pass over the march-layout copy (`pyramid_from_volume`) or,
with no pass over the volume, from the per-brick ranges of the field in
data layout that the fused stencil's epilogue emits
(`pyramid_from_ranges`, fed `FieldRanges`).
A cell the pyramid gates off is provably zero-alpha: in-plane bilinear
resampling keeps values inside each covered row pair's range (each band
carries a one-row apron into its neighbours so every adjacent-row pair
lies inside one band), and ``max_alpha_in`` bounds any transfer function
over the whole interval. The march consumes the chunk level (and the
tile level when the spec tiles in-plane).

The plan side of the render decomposition lives here too: the per-z
live and range profiles of a field (`z_live_profile`,
`z_range_profile`) and the host-side planners of contiguous render
bands (`slice_plan`, `even_plan`, `plan_work`, `straggler_factor`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch.config import OCCUPANCY_VTILES_DEFAULT

# one storage rounding of a bf16 march copy moves a value by at most 2^-8
# relative; ranges of the f32 sim field widen by this before gating a bf16
# march (pyramid_from_ranges)
_BF16_EPS = 2.0 ** -8


class FieldRanges(NamedTuple):
    """Per-brick value ranges of a scalar field in data layout ``[D, H,
    W]``: brick (i, j) covers ``z in [i*bz, (i+1)*bz) x y in [j*by,
    (j+1)*by) x all x`` with ``bz = D // lo.shape[0]`` and ``by = H //
    lo.shape[1]``."""

    lo: torch.Tensor   # f32[nzb, nyb]
    hi: torch.Tensor   # f32[nzb, nyb]


def default_bricks(shape: Tuple[int, int, int]) -> Tuple[int, int]:
    """The canonical (nzb, nyb) brick grid of a field shape: ~32 z bricks
    x ~OCCUPANCY_VTILES_DEFAULT y bricks, snapped down to divisors (512^3
    -> (32, 16), bricks of 16 x 32 x 512 cells)."""
    d, h, _ = shape
    return _cap_divisor(d, 32), _cap_divisor(h, OCCUPANCY_VTILES_DEFAULT)


def _cap_divisor(n: int, cap: int) -> int:
    b = min(n, cap)
    while n % b:
        b -= 1
    return b


def field_ranges(field: torch.Tensor, nzb: int, nyb: int) -> FieldRanges:
    """Per-brick min/max of ``field [D, H, W]`` in one sweep of the data
    layout; needs ``nzb | D`` and ``nyb | H`` (x is reduced whole). The
    plain version of the fused stencil's ranges epilogue."""
    d, h, w = field.shape
    if d % nzb or h % nyb:
        raise ValueError(f"brick grid ({nzb}, {nyb}) does not divide "
                         f"field shape {tuple(field.shape)}")
    x = field.reshape(nzb, d // nzb, nyb, h // nyb, w).to(torch.float32)
    return FieldRanges(lo=torch.amin(x, dim=(1, 3, 4)),
                       hi=torch.amax(x, dim=(1, 3, 4)))


def remap_ranges(lo: torch.Tensor, hi: torch.Tensor,
                 to_shape: Tuple[int, int]):
    """Re-grid brick ranges to another brick count per axis,
    conservatively: reducing (from % to == 0) is exact, refining (to %
    from == 0) repeats each coarse range over its fine bricks, and
    incommensurate counts reduce to their gcd first, then refine."""
    def one_axis(x, n_to, axis, red):
        n_from = x.shape[axis]
        if n_from == n_to:
            return x
        if n_from % n_to == 0:
            shp = x.shape[:axis] + (n_to, n_from // n_to) + x.shape[axis + 1:]
            return red(x.reshape(shp), dim=axis + 1)
        if n_to % n_from:
            g = math.gcd(n_from, n_to)
            shp = x.shape[:axis] + (g, n_from // g) + x.shape[axis + 1:]
            x = red(x.reshape(shp), dim=axis + 1)
            n_from = g
        return torch.repeat_interleave(x, n_to // n_from, dim=axis)

    for axis in (0, 1):
        lo = one_axis(lo, to_shape[axis], axis, torch.amin)
        hi = one_axis(hi, to_shape[axis], axis, torch.amax)
    return lo, hi


class OccupancyPyramid(NamedTuple):
    """Two-level march-layout occupancy for one (volume, AxisSpec) pair:
    per-(chunk x v-tile) ranges ``lo/hi f32[nchunks, nt]`` with the gate
    ``tiles bool[nchunks, nt]``, and the per-chunk gate ``chunks
    bool[nchunks]`` from the union of each chunk's cell ranges. ``nt ==
    1`` when the spec does no in-plane tiling."""

    lo: torch.Tensor
    hi: torch.Tensor
    chunks: torch.Tensor
    tiles: torch.Tensor

    def gate(self, spec):
        """What ``slicer.slice_march`` consumes: None when skipping is
        off, bool[nchunks] for chunk-only skipping, (chunks, tiles) when
        the spec tiles in-plane."""
        if not spec.skip_empty:
            return None
        if spec.vtiles > 0:
            return self.chunks, self.tiles
        return self.chunks

    def live_fraction(self) -> torch.Tensor:
        """f32[]: the share of (chunk x v-tile) cells that can contribute
        opacity."""
        return torch.mean(self.tiles.to(torch.float32))

    def chunk_live_fractions(self) -> torch.Tensor:
        """f32[nchunks]: each chunk's share of live tiles."""
        return torch.mean(self.tiles.to(torch.float32), dim=1)


def resolved_tiles(spec, nv: int) -> int:
    """The tile count a march over ``nv`` v-rows uses: ``spec.vtiles``
    re-clamped so every band keeps >= 2 rows."""
    if spec.vtiles <= 0:
        return 1
    return max(1, min(spec.vtiles, nv // 2))


def _tile_bands(nv: int, nt: int):
    """Row intervals [r0, r1) of the nt v-tiles including the one-row
    apron; the last band absorbs the remainder."""
    tv = nv // nt
    return [(max(t * tv - 1, 0),
             nv if t == nt - 1 else min((t + 1) * tv + 1, nv))
            for t in range(nt)]


def _gates(tf, lo, hi, pre_shaded: bool, alpha_eps: float):
    """(chunks, tiles) gates from cell ranges. A scalar volume pushes the
    range through the TF's conservative alpha bound; a pre-shaded volume
    gates on its stored alpha directly."""
    if pre_shaded:
        tiles = hi > alpha_eps
        return torch.any(tiles, dim=1), tiles
    cl = lambda x: torch.clamp(x, 0.0, 1.0)
    tiles = tf.max_alpha_in(cl(lo), cl(hi)) > alpha_eps
    chunks = tf.max_alpha_in(cl(torch.amin(lo, dim=1)),
                             cl(torch.amax(hi, dim=1))) > alpha_eps
    return chunks, tiles


def pyramid_from_volume(vol, tf, spec, volp: Optional[torch.Tensor] = None,
                        alpha_eps: float = 1e-5) -> OccupancyPyramid:
    """Build the pyramid in one pass over the march-layout copy.
    ``volp`` (the unpadded ``slicer.permute_volume`` output) shares the
    frame's one permuted copy; chunk boundaries come from the shared
    ``slicer._pad_to_chunks``. A pre-shaded RGBA volume ranges its
    alpha plane (``tf`` may be None)."""
    from scenery_insitu_tpu_torch.ops import slicer

    if volp is None:
        volp = slicer.permute_volume(vol, spec)
    pre_shaded = vol.data.dim() == 4
    if pre_shaded:
        volp = volp[:, 3]                                  # alpha plane
    volp, nchunks = slicer._pad_to_chunks(volp, spec.chunk)
    nv = volp.shape[1]
    nt = resolved_tiles(spec, nv)
    los, his = [], []
    for r0, r1 in _tile_bands(nv, nt):
        band = volp[:, r0:r1].reshape(nchunks, -1)
        los.append(torch.amin(band, dim=1).to(torch.float32))
        his.append(torch.amax(band, dim=1).to(torch.float32))
    lo = torch.stack(los, dim=1)                           # [nchunks, nt]
    hi = torch.stack(his, dim=1)
    chunks, tiles = _gates(tf, lo, hi, pre_shaded, alpha_eps)
    return OccupancyPyramid(lo, hi, chunks, tiles)


def pyramid_from_ranges(ranges: FieldRanges, vol, tf, spec,
                        alpha_eps: float = 1e-5) -> OccupancyPyramid:
    """The pyramid from data-layout brick ranges of the field ``vol``
    wraps (``vol.data [D, H, W]``, scalar), without reading the volume.
    Each (chunk x v-tile) cell takes the union range of every brick its
    region can touch: tile bands with their apron rows, the chunk's
    marched slices mapped to data slices through the march sign, brick
    intervals rounded outward, zero admitted in the zero-padded last
    chunk, and a bf16 march copy widening the range by one storage
    rounding. What it gates off is a subset of what
    `pyramid_from_volume` gates off, and the march's skip path is exact,
    so the frame is the same."""
    if vol.data.dim() != 3:
        raise ValueError("sim field ranges describe a scalar field; "
                         "pre-shaded RGBA volumes build from the volume")
    d, h, w = vol.data.shape
    nzb, nyb = ranges.lo.shape
    if d % nzb or h % nyb:
        raise ValueError(f"brick grid {tuple(ranges.lo.shape)} does not "
                         f"divide volume shape {tuple(vol.data.shape)}")
    bz, by = d // nzb, h // nyb
    a = spec.axis

    # orient the brick grid as [slice-axis bricks, v-axis bricks]
    if a == 2:            # march z, v = y
        sl_lo, sl_hi = ranges.lo, ranges.hi
        sb, s_total, vb = bz, d, by
    elif a == 1:          # march y, v = z
        sl_lo, sl_hi = ranges.lo.T, ranges.hi.T
        sb, s_total, vb = by, h, bz
    else:                 # march x: bricks do not resolve x, so one slice
        #                   brick spans the march; tiles still resolve z
        sl_lo = torch.amin(ranges.lo, dim=1)[None, :]
        sl_hi = torch.amax(ranges.hi, dim=1)[None, :]
        sb, s_total, vb = w, w, bz

    c = spec.chunk
    nchunks = -(-s_total // c)
    nv = vol.data.shape[_data_dim(spec.v_axis)]
    nt = resolved_tiles(spec, nv)

    # per-tile band ranges along the v bricks, apron rows included
    band_lo, band_hi = [], []
    for r0, r1 in _tile_bands(nv, nt):
        b0, b1 = r0 // vb, -(-r1 // vb)
        band_lo.append(torch.amin(sl_lo[:, b0:b1], dim=1))
        band_hi.append(torch.amax(sl_hi[:, b0:b1], dim=1))
    band_lo = torch.stack(band_lo, dim=1)                   # [nsb, nt]
    band_hi = torch.stack(band_hi, dim=1)

    # per chunk: marched slice interval -> data interval (sign flip) ->
    # the slice bricks it touches, rounded outward
    los, his = [], []
    for ci in range(nchunks):
        m0, m1 = ci * c, min((ci + 1) * c, s_total)
        d0, d1 = (m0, m1) if spec.sign > 0 else (s_total - m1, s_total - m0)
        b0, b1 = d0 // sb, -(-d1 // sb)
        lo_c = torch.amin(band_lo[b0:b1], dim=0)
        hi_c = torch.amax(band_hi[b0:b1], dim=0)
        if (ci + 1) * c > s_total:
            # _pad_to_chunks zero-pads the last chunk: zero enters its range
            lo_c = torch.clamp(lo_c, max=0.0)
            hi_c = torch.clamp(hi_c, min=0.0)
        los.append(lo_c)
        his.append(hi_c)
    lo = torch.stack(los)                                   # [nchunks, nt]
    hi = torch.stack(his)
    if spec.render_dtype == "bf16":
        lo = lo - torch.abs(lo) * _BF16_EPS
        hi = hi + torch.abs(hi) * _BF16_EPS
    chunks, tiles = _gates(tf, lo, hi, False, alpha_eps)
    return OccupancyPyramid(lo, hi, chunks, tiles)


def _data_dim(axis_xyz: int) -> int:
    """xyz axis index -> the Volume.data dim, counted from the end."""
    return {0: -1, 1: -2, 2: -3}[axis_xyz]


# ------------------------------------------------------ load-aware K budget


def k_budget_target(live_frac, total_live, n_ranks: int, k: int,
                    k_min: int = 4) -> torch.Tensor:
    """f32[] per-rank segment-count target of ``CompositeConfig.k_budget
    = "occupancy"``: this rank's share ``n_ranks * k * live / total`` of
    the mesh-wide budget, by its pyramid's live fraction, clamped to
    ``[min(k_min, k), k]``; an all-empty mesh (total ~ 0) gives ``k``.
    Output shapes stay at K on every rank: a sparse rank's adaptive
    threshold closes fewer segments instead of chasing K. Tensors stay
    on their device; numbers become CPU tensors."""
    live = torch.as_tensor(live_frac, dtype=torch.float32)
    total = torch.clamp(torch.as_tensor(total_live, dtype=torch.float32,
                                        device=live.device), min=1e-12)
    share = n_ranks * k * live / total
    share = torch.where(total > 1e-9, share, torch.full_like(share, k))
    return torch.clamp(share, float(min(k_min, k)), float(k))


# -------------------------------------------- uneven z-slab render plans


# Work model of one z slice: a live slice costs 1 + base, an empty one
# only base — skipping makes air cheap, not free (the chunk scan still
# iterates, the gate still evaluates, padded fold chunks still close
# segments). The modeled straggler factors derive from it.
PLAN_BASE_COST = 0.05


def z_live_profile(field: torch.Tensor, tf, nzb: int = 0, nyb: int = 0,
                   alpha_eps: float = 1e-5) -> torch.Tensor:
    """f32[nzb] per-z-brick live fraction of a scalar field ``[D, H, W]``
    — the replan signal of ``CompositeConfig.rebalance``. One
    `field_ranges` sweep in data layout (no permute) gated through the
    TF's conservative alpha bound, reduced over the in-plane bricks:
    entry i is the fraction of (y-brick) cells in z band ``[i*D/nzb,
    (i+1)*D/nzb)`` that can contribute opacity. ``nzb``/``nyb`` default
    to `default_bricks`. The session profiles every rank's even slab
    and concatenates the profiles into the global z profile
    `slice_plan` consumes."""
    d_nzb, d_nyb = default_bricks(tuple(field.shape))
    nzb = nzb or d_nzb
    nyb = nyb or d_nyb
    fr = field_ranges(field, nzb, nyb)
    cl = lambda x: torch.clamp(x, 0.0, 1.0)
    live = tf.max_alpha_in(cl(fr.lo), cl(fr.hi)) > alpha_eps
    return torch.mean(live.to(torch.float32), dim=1)


def z_range_profile(field: torch.Tensor, nzb: int = 0):
    """(lo f32[nzb], hi f32[nzb]) per-z-brick value range of a scalar
    field ``[D, H, W]``, clipped to the TF's [0, 1] domain — the input of
    the LOD planner's TF-straddle gate (`parallel.lod.select_levels`).
    One `field_ranges` sweep with a single in-plane brick; the session
    profiles every rank's even slab and concatenates the ranges."""
    nzb = nzb or default_bricks(tuple(field.shape))[0]
    fr = field_ranges(field, nzb, 1)
    return (torch.clamp(fr.lo[:, 0], 0.0, 1.0),
            torch.clamp(fr.hi[:, 0], 0.0, 1.0))


def _slice_work(live_profile, d: int, base_cost: float) -> np.ndarray:
    """f64[d] per-slice march work from a per-z-bin live profile
    (``len(live_profile)`` must divide ``d``)."""
    prof = np.asarray(live_profile, np.float64).clip(0.0, None)
    nb = prof.shape[0]
    if nb == 0 or d % nb:
        raise ValueError(f"live profile has {nb} bins which do not "
                         f"divide depth {d}")
    return np.repeat(prof, d // nb) + base_cost


def slice_plan(live_profile, d: int, n: int, min_depth: int = 1,
               quantum: int = 1, prev=None, hysteresis: float = 0.0,
               base_cost: float = PLAN_BASE_COST,
               max_depth: int = 0):
    """Per-rank contiguous z-slice counts equalizing live march work —
    host-side numpy.

    ``live_profile`` (f32[nb], nb | d) is the global per-z-bin live
    fraction (`z_live_profile`). Greedy prefix-sum equalization places
    band boundary r at the slice where cumulative work first reaches r/n
    of the total, snapped to the nearest ``quantum`` multiple and
    clamped so every band keeps ``min_depth`` slices; the boundaries are
    a monotone ladder from 0 to d, so ``sum(plan) == d`` always.

    ``max_depth`` caps any band's depth (0 = ``2 * ceil(d / n)``): every
    rank's band pads to ``max(plan)``, so an unbounded plan would make
    every rank scan (and skip) that many chunks.

    ``prev``/``hysteresis``: when every boundary of the fresh plan is
    within ``hysteresis * (d / n)`` slices of ``prev``'s, ``prev`` is
    returned unchanged (object-equal), so the caller can key rebuilds on
    plan identity. Returns a tuple of n ints."""
    if n < 1:
        raise ValueError(f"need >= 1 rank, got {n}")
    min_depth = max(1, min(int(min_depth), d // n))
    quantum = max(1, int(quantum))
    max_depth = int(max_depth) or 2 * (-(-d // n))
    max_depth = max(max_depth, -(-d // n))          # keep n bands feasible
    w = _slice_work(live_profile, d, base_cost)
    cw = np.cumsum(w)
    total = float(cw[-1])
    bounds = [0]
    for r in range(1, n):
        target = total * r / n
        z = int(np.searchsorted(cw, target, side="left")) + 1
        z = int(round(z / quantum)) * quantum
        lo = max(bounds[-1] + min_depth, d - (n - r) * max_depth)
        hi = min(d - (n - r) * min_depth, bounds[-1] + max_depth)
        bounds.append(int(min(max(z, lo), hi)))
    bounds.append(d)
    plan = tuple(int(b1 - b0) for b0, b1 in zip(bounds, bounds[1:]))
    if prev is not None and len(prev) == n and hysteresis > 0.0:
        pb = np.concatenate([[0], np.cumsum(np.asarray(prev, np.int64))])
        if pb[-1] == d and np.max(np.abs(np.asarray(bounds) - pb)) \
                <= hysteresis * d / n:
            return tuple(int(p) for p in prev)
    return plan


def even_plan(d: int, n: int):
    """The identity render plan: the even z-slab split itself."""
    if d % n:
        raise ValueError(f"depth {d} not divisible by {n} ranks")
    return (d // n,) * n


def plan_work(live_profile, d: int, plan,
              base_cost: float = PLAN_BASE_COST):
    """Per-rank modeled march work of a render plan under the slice work
    model — the numerator of the straggler factor."""
    w = _slice_work(live_profile, d, base_cost)
    if sum(plan) != d:
        raise ValueError(f"plan {plan} does not cover depth {d}")
    bounds = np.concatenate([[0], np.cumsum(np.asarray(plan, np.int64))])
    return [float(w[b0:b1].sum()) for b0, b1 in zip(bounds, bounds[1:])]


def straggler_factor(live_profile, d: int, plan,
                     base_cost: float = PLAN_BASE_COST) -> float:
    """max/mean per-rank modeled march work — the frame-barrier term the
    rebalance attacks (1.0 = no straggler)."""
    work = plan_work(live_profile, d, plan, base_cost)
    return float(np.max(work) / max(np.mean(work), 1e-12))
