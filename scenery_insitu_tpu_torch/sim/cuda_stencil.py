"""Kernel K3: T fused Gray-Scott steps in one pass (``csrc/stencil.cu``).

`step_fused` advances ``u, v f32[D,H,W]`` by ``t_steps <= FUSE_T``
steps; on a CUDA tensor it launches the kernel (or raises), on a CPU
tensor it runs `step_fused_plain`, which is ``grayscott.step`` applied T
times. `multi_step_fused` keeps the reference's greedy decomposition of
``n`` steps into fused passes (``pallas_stencil._multi_step_impl``), so
both run the same sequence of steps. The kernel takes any grid shape,
periodic on every axis, also one smaller than its halo: there is no
``T | tz | D`` constraint.

The kernel streams through z (2.5-D blocking with a wavefront in time):
a block of 8 warps owns a 32 x 32 xy tile, the (32 - 2T)^2 core plus a
halo of T in x and y, and a segment of 128 planes (64 at T = 1, 2), and
walks the segment once. Each thread holds 4 rows of one column, so the x
neighbours are warp shuffles and the y neighbours registers (the strip
ends come from the neighbouring warps through shared memory); level s of
plane p - s is computed as soon as input plane p has landed, the T
levels' last two planes stay in registers, and level T is stored as it
is made. Input planes are copied three ahead into a shared-memory ring
with ``cp.async``. What bounds it: device-memory bytes (one read and one
write of u and v, 16 B a cell; the halo re-reads and the 2T-plane
warm-up of a segment add ~1.78 x 1.06 to the reads at T = 4, served from
L2 where neighbouring blocks share it), then the 29 f32 operations a
cell and level issued without FMA contraction, on 7.1 cell-levels a
stored cell at T = 4 (the halo is recomputed): at T = 4 these, not the
bytes, set its time. The geometry is fixed in the source; `attributes`
reports each build's registers, shared memory, resident blocks and tile.
The arithmetic follows ``grayscott.step`` operation for operation, so
the kernel equals the plain version bit for bit.

`step_fused_ranges` is the same pass with the occupancy epilogue (the
reference's ``with_ranges`` variant, B4b): it also returns the per-brick
min/max of the new v on the caller's ``(nzb, nyb)`` brick grid, exactly
``occupancy.field_ranges`` of it (each row's stored v folds into a
running min/max in registers; each warp makes one atomic pair a brick
when its z walk leaves the brick). `multi_step_fused_ranges` attaches
the epilogue to the last pass only, the one whose ranges reach the
caller.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from scenery_insitu_tpu_torch import kernels

FUSE_T = 4


def decompose(n: int) -> List[int]:
    """The fused pass lengths of ``n`` steps: greedy from FUSE_T down
    (n=10 -> [4, 4, 2], n=5 -> [4, 1])."""
    out, remaining = [], n
    for t in range(min(FUSE_T, n), 0, -1):
        reps = remaining // t
        out += [t] * reps
        remaining -= reps * t
    return out


def _check(u, v, params):
    if u.shape != v.shape or u.dim() != 3:
        raise ValueError(f"u {tuple(u.shape)} and v {tuple(v.shape)} must "
                         f"be one [D, H, W] shape")
    for name, t in (("u", u), ("v", v), ("params", params)):
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(params.shape) != (5,):
        raise ValueError(f"params must be f32[5] (f, k, du, dv, dt), got "
                         f"{tuple(params.shape)}")


def step_fused(u: torch.Tensor, v: torch.Tensor, params: torch.Tensor,
               t_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused pass of ``t_steps`` steps; returns new (u, v)."""
    if not 1 <= t_steps <= FUSE_T:
        raise ValueError(f"t_steps must be in 1..{FUSE_T}, got {t_steps}")
    _check(u, v, params)
    if u.device.type == "cpu":
        return step_fused_plain(u, v, params, t_steps)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    uo = torch.empty_like(u)
    vo = torch.empty_like(v)
    d, h, w = u.shape
    kernels.launch("grayscott_fused", u.data_ptr(), v.data_ptr(),
                   params.data_ptr(), uo.data_ptr(), vo.data_ptr(),
                   d, h, w, t_steps,
                   nbytes=kernels.operand_bytes((u, v, params), (uo, vo)))
    return uo, vo


def attributes(t_steps: int, ranges: bool = False) -> dict:
    """The build of K3 (or B4b, ``ranges=True``) for ``t_steps`` on the
    current card: registers and local-memory bytes a thread, shared bytes
    a block, resident blocks an SM, threads a block, and the tile (core
    x, core y, z segment). Needs a card: it loads the kernel library."""
    if not 1 <= t_steps <= FUSE_T:
        raise ValueError(f"t_steps must be in 1..{FUSE_T}, got {t_steps}")
    out = kernels.query("stencil_attributes", t_steps, int(ranges), nout=8)
    keys = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm",
            "threads", "core_x", "core_y", "seg_z")
    return dict(zip(keys, out))


def step_fused_plain(u: torch.Tensor, v: torch.Tensor, params: torch.Tensor,
                     t_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: ``grayscott.step`` applied ``t_steps`` times
    (the roll formulation). Any device."""
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    p = gs.GrayScottParams(*params.unbind(0))
    st = gs.multi_step(gs.GrayScott(u, v, p), t_steps)
    return st.u, st.v


def multi_step_fused(u: torch.Tensor, v: torch.Tensor, params: torch.Tensor,
                     n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` steps as the greedy sequence of fused passes."""
    for t in decompose(n):
        u, v = step_fused(u, v, params, t)
    return u, v


def modeled_sim_traffic(shape, n: int, fused: bool = True) -> float:
    """Modeled device-memory bytes of ``n`` Gray-Scott steps on a ``shape
    = (D, H, W)`` grid, a floor: each fused pass of `decompose` reads u
    and v once and writes them once (the halo re-reads K3's blocks share
    through L2 are not counted); ``fused=False`` charges one read and
    one write of u and v per step (``grayscott.multi_step``). The bench
    twin's traffic model when the cost count is unavailable."""
    d, h, w = shape
    vol_bytes = 2 * 4.0 * d * h * w          # u + v, f32
    passes = len(decompose(n)) if fused else n
    return passes * 2.0 * vol_bytes


def _check_bricks(v, bricks):
    nzb, nyb = bricks
    d, h, _ = v.shape
    if nzb < 1 or nyb < 1 or d % nzb or h % nyb:
        raise ValueError(f"brick grid ({nzb}, {nyb}) does not divide "
                         f"field shape {tuple(v.shape)}")


def step_fused_ranges(u: torch.Tensor, v: torch.Tensor,
                      params: torch.Tensor, t_steps: int,
                      bricks: Tuple[int, int]):
    """One fused pass with the ranges epilogue: returns ``(u', v', lo,
    hi)`` with ``lo, hi f32[nzb, nyb]`` the min/max of v' per brick of
    ``bricks = (nzb, nyb)`` (``nzb | D``, ``nyb | H``)."""
    if not 1 <= t_steps <= FUSE_T:
        raise ValueError(f"t_steps must be in 1..{FUSE_T}, got {t_steps}")
    _check(u, v, params)
    _check_bricks(v, bricks)
    if u.device.type == "cpu":
        return step_fused_ranges_plain(u, v, params, t_steps, bricks)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    nzb, nyb = bricks
    uo = torch.empty_like(u)
    vo = torch.empty_like(v)
    # the kernel folds into these with atomics: seeded on every call
    lo = torch.full((nzb, nyb), torch.inf, device=u.device)
    hi = torch.full((nzb, nyb), -torch.inf, device=u.device)
    d, h, w = u.shape
    kernels.launch("grayscott_fused_ranges", u.data_ptr(), v.data_ptr(),
                   params.data_ptr(), uo.data_ptr(), vo.data_ptr(),
                   lo.data_ptr(), hi.data_ptr(), d, h, w, t_steps, nzb, nyb,
                   nbytes=kernels.operand_bytes((u, v, params, lo, hi),
                                                (uo, vo, lo, hi)))
    return uo, vo, lo, hi


def step_fused_ranges_plain(u: torch.Tensor, v: torch.Tensor,
                            params: torch.Tensor, t_steps: int,
                            bricks: Tuple[int, int]):
    """Plain version of the ranges epilogue: `step_fused_plain`, then
    ``occupancy.field_ranges`` of the new v. Any device."""
    from scenery_insitu_tpu_torch.ops.occupancy import field_ranges

    u, v = step_fused_plain(u, v, params, t_steps)
    r = field_ranges(v, *bricks)
    return u, v, r.lo, r.hi


def multi_step_fused_ranges(u: torch.Tensor, v: torch.Tensor,
                            params: torch.Tensor, n: int,
                            bricks: Tuple[int, int]):
    """``n`` steps as `multi_step_fused`, the last pass with the ranges
    epilogue: ``(u', v', lo, hi)``, the ranges those of the final v. For
    ``n == 0`` no pass runs and the ranges are those of ``v`` as it
    is."""
    passes = decompose(n)
    if not passes:
        from scenery_insitu_tpu_torch.ops.occupancy import field_ranges

        r = field_ranges(v, *bricks)
        return u, v, r.lo, r.hi
    for t in passes[:-1]:
        u, v = step_fused(u, v, params, t)
    return step_fused_ranges(u, v, params, passes[-1], bricks)
