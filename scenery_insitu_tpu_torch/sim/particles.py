"""Particle simulations: Lennard-Jones MD (the reference's BASELINE Config
4) and the simple-harmonic-oscillator toy sim of the reference's shared
memory producer.

LJ uses a fixed-capacity cell list rebuilt every force pass: particles
are sorted by cell id and each particle gathers candidates from its 27
neighbour cells. A cell's overflow beyond ``capacity`` is dropped (the
reference's trade for static shapes). Velocity-Verlet integration on a
periodic box.

The force pass runs in blocks of particles (`FORCE_BLOCK_ENTRIES`
candidate pairs a block, ~400 MB a ``[B, M, 3]`` f32 temporary): at a
million particles (M = 27 * 28 = 756 candidates a particle) each ``[N,
M, 3]`` temporary would hold 9 GB, and a particle's force is a sum over
its own candidates, so the blocks change no number.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch.device import resolve_device

# candidate pairs (particle x neighbour slot) a block of the force pass
FORCE_BLOCK_ENTRIES = 1 << 25


class ParticleState(NamedTuple):
    pos: torch.Tensor     # f32[N, 3] in [0, box)
    vel: torch.Tensor     # f32[N, 3]
    box: torch.Tensor     # f32[] periodic box side


def _f32(x, dev) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=dev)


# ----------------------------------------------------------------- SHO sim

class SHOParams(NamedTuple):
    omega2: torch.Tensor
    dt: torch.Tensor


def sho_init(n: int, box: float = 1.0, seed: int = 0, omega2: float = 4.0,
             dt: float = 0.005, device=None
             ) -> Tuple[ParticleState, SHOParams]:
    """``n`` oscillators, positions uniform in the box and velocities
    normal (0.1 box), drawn from a numpy generator seeded with
    ``seed``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, box, (n, 3)).astype(np.float32)
    vel = (rng.standard_normal((n, 3), dtype=np.float32)
           * np.float32(0.1 * box))
    return (ParticleState(torch.as_tensor(pos, device=dev),
                          torch.as_tensor(vel, device=dev), _f32(box, dev)),
            SHOParams(_f32(omega2, dev), _f32(dt, dev)))


def sho_step(state: ParticleState, p: SHOParams) -> ParticleState:
    """Each particle oscillates about the box centre independently."""
    center = state.box / 2.0
    acc = -p.omega2 * (state.pos - center)
    vel = state.vel + p.dt * acc
    pos = state.pos + p.dt * vel
    return state._replace(pos=pos, vel=vel)


def sho_multi_step(state: ParticleState, p: SHOParams,
                   n: int) -> ParticleState:
    for _ in range(n):
        state = sho_step(state, p)
    return state


# ------------------------------------------------------------------- LJ MD

class LJParams(NamedTuple):
    epsilon: torch.Tensor
    sigma: torch.Tensor
    cutoff: torch.Tensor     # in units of sigma
    dt: torch.Tensor

    @classmethod
    def create(cls, epsilon=1.0, sigma=1.0, cutoff=2.5, dt=0.002,
               device=None) -> "LJParams":
        dev = resolve_device(device)
        return cls(*(_f32(x, dev) for x in (epsilon, sigma, cutoff, dt)))


class CellSpec(NamedTuple):
    """Static cell-list geometry (host ints)."""
    ncell: int            # cells per axis
    capacity: int         # max particles per cell


def lj_init(n: int, density: float = 0.5, params: Optional[LJParams] = None,
            seed: int = 0, temperature: float = 1.0, device=None
            ) -> Tuple[ParticleState, LJParams, CellSpec]:
    """Particles on a jittered cubic lattice (no overlapping starts); the
    jitter and the velocities are drawn from a numpy generator seeded
    with ``seed``. ``device`` places the state when ``params`` is None;
    given params, the state lies on theirs."""
    params = params or LJParams.create(device=device)
    dev = params.dt.device
    box = float((n / density) ** (1.0 / 3.0))
    # the side rounds up in f32, as the reference's jnp.ceil does
    side = int(np.ceil(np.float32(n ** (1.0 / 3.0))))
    idx = np.arange(side ** 3)[:n]
    lattice = np.stack([idx % side, (idx // side) % side,
                        idx // (side * side)], axis=-1).astype(np.float32)
    spacing = box / side
    rng = np.random.default_rng(seed)
    jitter = rng.uniform(-0.1 * spacing, 0.1 * spacing,
                         (n, 3)).astype(np.float32)
    vel = (rng.standard_normal((n, 3), dtype=np.float32)
           * np.float32(np.sqrt(temperature)))
    pos = torch.as_tensor(lattice, device=dev)
    pos = (pos + 0.5) * spacing + torch.as_tensor(jitter, device=dev)
    vel = torch.as_tensor(vel, device=dev)
    vel = vel - vel.mean(dim=0, keepdim=True)
    rc = float(np.float32(params.cutoff.item())
               * np.float32(params.sigma.item()))
    ncell = max(int(box / rc), 3)
    mean_occ = n / ncell ** 3
    capacity = max(int(mean_occ * 3) + 4, 8)
    return (ParticleState(pos, vel, _f32(box, dev)), params,
            CellSpec(ncell, capacity))


def _cells(pos: torch.Tensor, box: torch.Tensor, nc: int) -> torch.Tensor:
    """Each particle's cell ``i64[N, 3]`` (x, y, z)."""
    return torch.clamp((pos / (box / nc)).to(torch.int32), 0, nc - 1) \
        .to(torch.int64)


def _build_cells(pos: torch.Tensor, box: torch.Tensor, spec: CellSpec
                 ) -> torch.Tensor:
    """-> ``i64[ncell^3, capacity]`` particle indices a cell (N marks an
    empty entry), in index order within a cell; a cell's particles past
    ``capacity`` are dropped."""
    n = pos.shape[0]
    nc = spec.ncell
    cell = _cells(pos, box, nc)
    cid = (cell[:, 2] * nc + cell[:, 1]) * nc + cell[:, 0]
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    dev = pos.device
    start = torch.searchsorted(
        cid_sorted, torch.arange(nc ** 3, device=dev), side="left")
    rank = torch.arange(n, device=dev) - start[cid_sorted]
    table = torch.full((nc ** 3, spec.capacity), n, dtype=torch.int64,
                       device=dev)
    keep = rank < spec.capacity
    table[cid_sorted[keep], rank[keep]] = order[keep]
    return table


def _neighbour_offsets(dev) -> torch.Tensor:
    """The 27 cell offsets ``i64[27, 3]`` in the reference's order."""
    r = torch.arange(-1, 2, device=dev)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(-1, 3)


def lj_forces(pos: torch.Tensor, box: torch.Tensor, params: LJParams,
              spec: CellSpec, block: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (forces ``f32[N, 3]``, potential ``f32[]``) from the 27-cell
    neighbourhood, ``block`` particles at a time (default: as many as
    keep a block within `FORCE_BLOCK_ENTRIES` candidate pairs)."""
    n = pos.shape[0]
    nc = spec.ncell
    dev = pos.device
    table = _build_cells(pos, box, spec)                   # [nc^3, cap]
    cell = _cells(pos, box, nc)
    offs = _neighbour_offsets(dev)
    m = 27 * spec.capacity
    block = block or max(1, FORCE_BLOCK_ENTRIES // m)
    pos_pad = torch.cat([pos, torch.zeros((1, 3), dtype=pos.dtype,
                                          device=dev)])
    rc2 = (params.cutoff * params.sigma) ** 2
    sig2 = params.sigma ** 2
    forces = torch.empty_like(pos)
    pots = []
    for a in range(0, n, block):
        b = min(n, a + block)
        ids = torch.remainder(cell[a:b, None, :] + offs[None], nc)
        nid = (ids[..., 2] * nc + ids[..., 1]) * nc + ids[..., 0]
        cand = table[nid].reshape(b - a, m)                # [B, M]
        dr = pos[a:b, None, :] - pos_pad[cand]             # [B, M, 3]
        dr = dr - box * torch.round(dr / box)              # minimum image
        r2 = torch.sum(dr * dr, dim=-1)
        self_ = torch.arange(a, b, device=dev)[:, None]
        valid = (cand < n) & (cand != self_) & (r2 < rc2)
        r2 = torch.where(valid, r2, 1e10)
        inv6 = (sig2 / r2) ** 3
        # F = 24 eps (2 (s/r)^12 - (s/r)^6) / r² dr
        fmag = 24.0 * params.epsilon * (2.0 * inv6 * inv6 - inv6) / r2
        forces[a:b] = torch.sum(torch.where(valid[..., None],
                                            fmag[..., None] * dr, 0.0),
                                dim=1)
        pots.append(torch.sum(torch.where(valid, inv6 * inv6 - inv6, 0.0)))
    # 4 eps / 2: every pair is counted from both ends
    return forces, 2.0 * params.epsilon * torch.stack(pots).sum()


def lj_step(state: ParticleState, params: LJParams, spec: CellSpec,
            forces: Optional[torch.Tensor] = None
            ) -> Tuple[ParticleState, torch.Tensor]:
    """One velocity-Verlet step; returns (state, new forces) so that the
    next step reuses the forces."""
    if forces is None:
        forces, _ = lj_forces(state.pos, state.box, params, spec)
    vel_half = state.vel + 0.5 * params.dt * forces
    pos = torch.remainder(state.pos + params.dt * vel_half, state.box)
    new_forces, _ = lj_forces(pos, state.box, params, spec)
    vel = vel_half + 0.5 * params.dt * new_forces
    return state._replace(pos=pos, vel=vel), new_forces


def lj_multi_step(state: ParticleState, params: LJParams, spec: CellSpec,
                  n: int) -> ParticleState:
    f, _ = lj_forces(state.pos, state.box, params, spec)
    for _ in range(n):
        state, f = lj_step(state, params, spec, f)
    return state


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    return 0.5 * torch.sum(state.vel ** 2)


def speeds(state: ParticleState) -> torch.Tensor:
    return torch.sqrt(torch.sum(state.vel * state.vel, dim=-1))
