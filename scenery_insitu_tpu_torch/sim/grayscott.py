"""Gray-Scott 3D reaction-diffusion: the built-in in-situ simulation.

The update is elementwise plus a 6-point Laplacian with periodic
boundaries (``torch.roll``). `multi_step_fast` is the single-device fast
path: on a CUDA tensor it runs the fused stencil kernel K3
(``sim/cuda_stencil.py``); on the CPU it runs K3's plain version, which
is `step` repeated. `multi_step_fast_ranges` also returns the field's
per-brick value ranges, the frame's occupancy structure, from the
stencil's epilogue.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch.config import SimConfig
from scenery_insitu_tpu_torch.device import resolve_device


class GrayScottParams(NamedTuple):
    f: torch.Tensor      # feed rate
    k: torch.Tensor      # kill rate
    du: torch.Tensor     # diffusion of u
    dv: torch.Tensor     # diffusion of v
    dt: torch.Tensor

    @classmethod
    def create(cls, f=None, k=None, du=None, dv=None, dt=None,
               device=None) -> "GrayScottParams":
        d = SimConfig()
        dev = resolve_device(device)
        a = lambda x, dflt: torch.tensor(dflt if x is None else x,
                                         dtype=torch.float32, device=dev)
        return cls(a(f, d.gs_f), a(k, d.gs_k), a(du, d.gs_du),
                   a(dv, d.gs_dv), a(dt, d.dt))

    def vector(self) -> torch.Tensor:
        """f32[5] (f, k, du, dv, dt): the kernel's parameter operand."""
        return torch.stack([self.f, self.k, self.du, self.dv, self.dt])


class GrayScott(NamedTuple):
    u: torch.Tensor      # f32[D, H, W]
    v: torch.Tensor      # f32[D, H, W]
    params: GrayScottParams

    @classmethod
    def init(cls, grid: Tuple[int, int, int], params: GrayScottParams = None,
             seed: int = 0, n_seeds: int = 4, device=None) -> "GrayScott":
        """Uniform u=1, v=0 with one central seed cube plus ``n_seeds``
        satellite cubes placed by a numpy generator seeded with ``seed``
        (the reference draws them with ``jax.random``, whose bits this
        package does not reproduce; parity runs hand both packages the
        same u, v arrays instead)."""
        dev = resolve_device(device)
        d, h, w = grid
        u = np.ones(grid, np.float32)
        v = np.zeros(grid, np.float32)

        def stamp(c, r):
            # the cells with |index - c| < r on every axis
            box = tuple(slice(max(int(ci) - r + 1, 0), int(ci) + r)
                        for ci in c)
            u[box] = 0.5
            v[box] = 0.25

        stamp((d // 2, h // 2, w // 2), max(min(d, h, w) // 4, 2))
        rng = np.random.default_rng(seed)
        rs = max(min(d, h, w) // 8, 2)
        for _ in range(n_seeds):
            stamp(rng.integers(rs, np.array([d - rs, h - rs, w - rs])), rs)
        return cls(torch.as_tensor(u, device=dev),
                   torch.as_tensor(v, device=dev),
                   params or GrayScottParams.create(device=dev))

    @classmethod
    def from_config(cls, cfg: SimConfig, seed: int = 0,
                    device=None) -> "GrayScott":
        return cls.init(tuple(cfg.grid),
                        GrayScottParams.create(cfg.gs_f, cfg.gs_k,
                                               cfg.gs_du, cfg.gs_dv, cfg.dt,
                                               device=device),
                        seed=seed, device=device)

    @property
    def field(self) -> torch.Tensor:
        """The scalar field rendered in-situ (v concentration, ≈[0, 1])."""
        return self.v


def _laplacian(x: torch.Tensor) -> torch.Tensor:
    return (torch.roll(x, 1, 0) + torch.roll(x, -1, 0)
            + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
            + torch.roll(x, 1, 2) + torch.roll(x, -1, 2) - 6.0 * x)


def step(state: GrayScott) -> GrayScott:
    u, v, p = state.u, state.v, state.params
    uvv = u * v * v
    du = p.du * _laplacian(u) - uvv + p.f * (1.0 - u)
    dv = p.dv * _laplacian(v) + uvv - (p.f + p.k) * v
    return GrayScott(u + p.dt * du, v + p.dt * dv, p)


def multi_step(state: GrayScott, n: int) -> GrayScott:
    for _ in range(n):
        state = step(state)
    return state


def multi_step_fast(state: GrayScott, n: int) -> GrayScott:
    """``n`` steps through the fused stencil (K3 on CUDA, its plain
    version on the CPU), fused ``FUSE_T`` steps at a time with the
    reference's greedy decomposition (n=10 -> T=4, 4, 2). Single device
    only: the periodic wrap is per tensor."""
    from scenery_insitu_tpu_torch.sim import cuda_stencil

    p = state.params
    u, v = cuda_stencil.multi_step_fused(state.u, state.v, p.vector(), n)
    return GrayScott(u, v, p)


def multi_step_fast_ranges(state: GrayScott, n: int, bricks=None,
                           fused: bool = True):
    """`multi_step_fast` that also returns the per-brick min/max of the
    rendered field (``ops/occupancy.FieldRanges``): ``fused=True`` takes
    them from the last fused pass's epilogue (the ranges kernel on CUDA,
    its plain version on the CPU); ``fused=False`` runs the roll
    formulation `multi_step` and reduces the final field once.
    ``bricks = (nzb, nyb)`` is the brick grid (default
    ``occupancy.default_bricks``). Returns ``(state', FieldRanges)``."""
    from scenery_insitu_tpu_torch.ops import occupancy as occ
    from scenery_insitu_tpu_torch.sim import cuda_stencil

    bricks = tuple(bricks or occ.default_bricks(tuple(state.v.shape)))
    p = state.params
    if fused:
        u, v, lo, hi = cuda_stencil.multi_step_fused_ranges(
            state.u, state.v, p.vector(), n, bricks)
        return GrayScott(u, v, p), occ.FieldRanges(lo, hi)
    st = multi_step(state, n)
    return st, occ.field_ranges(st.field, *bricks)
