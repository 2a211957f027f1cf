"""Host-side LOD level planner for multi-resolution brick maps.

Per-block refinement is selected from data occupancy plus a
screen-space error bound, and the resulting fragments composite
resolution-agnostically, as supersegment streams do. This module is
that selection policy, host-side and numpy like `slice_plan`
(`ops/occupancy.py`): the session feeds it the per-brick live fraction
(`z_live_profile`), the per-brick sampled value range
(`z_range_profile`), the TF's opacity edges
(`core.transfer.opacity_edges`) and the camera, and gets back the level
tuple a `BrickMap` carries (`parallel/bricks.py`). The march itself
never sees this code — levels change WHAT `mesh.reslab_bricks_lod`
materializes and which `step_scale` the builders pass, nothing else.

Selection order (each stage may only REFINE the previous one's pick,
except the empty shortcut; the TF gate runs last and is absolute):

1. screen-space error cap: the coarsest level whose projected voxel
   footprint stays under ``error_px`` for this brick's distance;
2. empty bricks (live fraction <= ``live_eps``) coarsen to the full
   admissible cap — air has no detail to lose;
3. hysteresis against the previous plan: refinement applies
   immediately (quality first), coarsening moves at most ONE level per
   replan and only once the error bound clears a ``1 - hysteresis``
   deadband — so a camera hovering at a level boundary cannot flap
   recompiles;
4. the TF-straddle gate: a brick whose sampled value range crosses an
   opacity edge keeps level 0, ALWAYS — pooling across an alpha
   feature can erase or invent it, and no error bound argues with
   that.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["per_brick", "admissible_max_level", "screen_error_caps",
           "select_levels", "level_work_scale", "modeled_march_flops"]


def per_brick(profile, nbricks: int, red: str = "mean") -> np.ndarray:
    """Regrid a per-z-bin profile (f32[nb]) onto ``nbricks`` bricks:
    reduce when bins are finer (``red`` = "mean" | "min" | "max"),
    repeat when coarser. Bin and brick grids must nest (one divides the
    other) — anything else means the profile was built for a different
    depth split, a caller bug."""
    prof = np.asarray(profile, np.float64)
    nb = prof.shape[0]
    if nbricks <= 0 or nb <= 0:
        raise ValueError(f"empty regrid: {nb} bins -> {nbricks} bricks")
    if nb % nbricks == 0:
        r = prof.reshape(nbricks, nb // nbricks)
        if red == "mean":
            return r.mean(axis=1)
        if red == "min":
            return r.min(axis=1)
        if red == "max":
            return r.max(axis=1)
        raise ValueError(f"unknown reduction {red!r}")
    if nbricks % nb == 0:
        return np.repeat(prof, nbricks // nb)
    raise ValueError(f"profile bins ({nb}) and bricks ({nbricks}) do "
                     f"not nest")


def admissible_max_level(brick_depth: int, h: int, w: int,
                         max_level: int) -> int:
    """The coarsest level ANY brick may take: ``2^l`` must divide the
    brick depth (BrickMap's own invariant) and the in-plane dims
    (`mesh.reslab_bricks_lod` pools whole volumes)."""
    lvl = 0
    while (lvl < max_level and brick_depth % (1 << (lvl + 1)) == 0
           and h % (1 << (lvl + 1)) == 0 and w % (1 << (lvl + 1)) == 0):
        lvl += 1
    return lvl


def _focal_px(fov_y: float, height_px: int) -> float:
    return height_px / (2.0 * math.tan(0.5 * float(fov_y)))


def screen_error_caps(centers: np.ndarray, radius: float, eye,
                      fov_y: float, height_px: int, voxel: float,
                      error_px: float, cap: int) -> np.ndarray:
    """i64[B] per-brick coarsest level whose projected voxel footprint
    stays under ``error_px``: a level-l voxel spans ``voxel * 2^l``
    world units and projects to ``voxel * 2^l * focal_px / dist``
    pixels. ``dist`` is conservative — the distance to the NEAREST
    point of the brick's bounding sphere (``radius``), floored well
    away from zero, so a brick the camera is inside always demands
    level 0."""
    eye = np.asarray(eye, np.float64).reshape(1, 3)
    dist = np.linalg.norm(centers - eye, axis=1) - float(radius)
    dist = np.maximum(dist, 1e-6)
    focal = _focal_px(fov_y, height_px)
    # largest l with voxel * 2^l * focal / dist <= error_px
    budget = error_px * dist / max(voxel * focal, 1e-12)
    lvls = np.floor(np.log2(np.maximum(budget, 1e-12)))
    return np.clip(lvls, 0, cap).astype(np.int64)


def _brick_centers(nbricks: int, dims, origin, spacing) -> np.ndarray:
    w, h, d = dims
    origin = np.asarray(origin, np.float64)
    spacing = np.asarray(spacing, np.float64)
    bz = d // nbricks
    cx = origin[0] + 0.5 * w * spacing[0]
    cy = origin[1] + 0.5 * h * spacing[1]
    cz = origin[2] + (np.arange(nbricks) + 0.5) * bz * spacing[2]
    out = np.empty((nbricks, 3), np.float64)
    out[:, 0] = cx
    out[:, 1] = cy
    out[:, 2] = cz
    return out


def select_levels(live, lo, hi, edges, *, dims, origin, spacing, eye,
                  fov_y: float, height_px: int, cfg,
                  prev: Optional[Sequence[int]] = None,
                  nbricks: int = 0) -> Tuple[int, ...]:
    """The per-brick refinement levels for one replan — host-side,
    numpy, static (the selection order in the module docstring).

    ``live``/``lo``/``hi`` are per-brick (f32[B], `per_brick`-regridded
    live fraction and clipped value range), ``edges`` the TF's active
    opacity knot positions (`opacity_edges`), ``dims`` the global
    (w, h, d) voxel dims, ``eye``/``fov_y``/``height_px`` the camera,
    ``cfg`` a `config.LODConfig`, ``prev`` the previous level tuple
    (hysteresis; None = first plan, no damping). Returns a tuple of B
    ints ready for `BrickMap.with_levels`."""
    live = np.asarray(live, np.float64)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    b = nbricks or live.shape[0]
    if not (live.shape[0] == lo.shape[0] == hi.shape[0] == b):
        raise ValueError(
            f"profile lengths disagree: live={live.shape[0]} "
            f"lo={lo.shape[0]} hi={hi.shape[0]} nbricks={b}")
    w, h, d = dims
    if b == 0 or d % b:
        raise ValueError(f"{b} bricks do not divide depth {d}")
    bz = d // b
    cap = admissible_max_level(bz, h, w, cfg.max_level)
    spacing_np = np.asarray(spacing, np.float64)
    voxel = float(spacing_np.max())
    centers = _brick_centers(b, dims, origin, spacing)
    radius = 0.5 * math.sqrt((w * spacing_np[0]) ** 2
                             + (h * spacing_np[1]) ** 2
                             + (bz * spacing_np[2]) ** 2)

    err_caps = screen_error_caps(centers, radius, eye, fov_y, height_px,
                                 voxel, cfg.error_px, cap)
    levels = err_caps.copy()
    if cfg.coarsen_empty:
        levels = np.where(live <= cfg.live_eps, cap, levels)

    if prev is not None and len(prev) == b:
        prev_np = np.asarray(prev, np.int64)
        # refine immediately; coarsen one level per replan and only
        # past the deadband (re-evaluate the error bound at the
        # TIGHTENED budget so a boundary-hovering camera stays put)
        damped = screen_error_caps(
            centers, radius, eye, fov_y, height_px, voxel,
            cfg.error_px * (1.0 - cfg.hysteresis), cap)
        if cfg.coarsen_empty:
            damped = np.where(live <= cfg.live_eps, cap, damped)
        coarser = levels > prev_np
        step = np.where(damped > prev_np, prev_np + 1, prev_np)
        levels = np.where(coarser, step, levels)

    if len(edges):
        e = np.asarray(edges, np.float64).reshape(1, -1)
        eps = cfg.tf_edge_eps
        straddle = np.any((e > lo[:, None] - eps)
                          & (e < hi[:, None] + eps), axis=1)
        straddle &= hi >= lo          # degenerate/absent ranges pass
        levels = np.where(straddle, 0, levels)

    return tuple(int(l) for l in levels)


def _per_slice_flops(h: int, w: int, ni: int, nj: int, f: int) -> float:
    """Modeled cost of one march slice at downsample ``f``: the two
    resample matmuls [nj, H/f]@[H/f, W/f] and [nj, W/f]@[W/f, ni]
    (the slice march's two resampling products)."""
    hf, wf = h // f, w // f
    return 2.0 * nj * hf * wf + 2.0 * nj * wf * ni


def level_work_scale(levels, dims, ni: int, nj: int) -> np.ndarray:
    """f64[B] relative march work of each brick vs level 0 — the factor
    `runtime/session.py` multiplies into the per-brick work vector
    before `bricks.steal_plan`, so stealing equalizes MODELED cost in
    level units (a level-2 brick is ~64x cheaper than its level-0
    self, and pretending otherwise re-creates the straggler)."""
    levels = np.asarray(levels, np.int64)
    w, h, d = dims
    b = levels.shape[0]
    bz = d // b
    base = _per_slice_flops(h, w, ni, nj, 1) * bz
    out = np.empty(b, np.float64)
    for i, lvl in enumerate(levels):
        f = 1 << int(lvl)
        out[i] = _per_slice_flops(h, w, ni, nj, f) * (bz // f) / base
    return out


def modeled_march_flops(levels, dims, ni: int, nj: int) -> float:
    """Total modeled march FLOPs of one frame under a level tuple — the
    modeled ladder metric of the level planner. All-level-0 recovers the exact
    pre-LOD cost; the ratio exact/lod is the headline reduction."""
    levels = np.asarray(levels, np.int64)
    w, h, d = dims
    b = levels.shape[0]
    bz = d // b
    total = 0.0
    for lvl in levels:
        f = 1 << int(lvl)
        total += _per_slice_flops(h, w, ni, nj, f) * (bz // f)
    return total
