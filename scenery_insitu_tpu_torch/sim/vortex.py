"""Vortex-ring Navier-Stokes simulation (the reference's BASELINE Config 3,
a vortex-in-cell flow whose vorticity magnitude is rendered in situ).

A stable-fluids incompressible solver on a periodic box:

- semi-Lagrangian advection (a trilinear back-trace through the
  renderer's sampler, ``ops/sampling.sample_trilinear``, on a volume
  padded by one wrapped layer a face),
- spectral diffusion and the exact Leray projection in one real-FFT
  round trip (``torch.fft``, cuFFT on a card).

State is the velocity ``u f32[3, D, H, W]`` in voxel units a time unit
(components x, y, z); the rendered field is the normalised vorticity
magnitude. Tracers (the hybrid workload) are ``f32[N, 3]`` voxel
positions (x, y, z) advected through the same flow.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch.device import resolve_device
from scenery_insitu_tpu_torch.ops.sampling import sample_trilinear


class VortexParams(NamedTuple):
    viscosity: torch.Tensor   # f32[] kinematic viscosity
    dt: torch.Tensor          # f32[]

    @classmethod
    def create(cls, viscosity=1e-3, dt=0.1, device=None) -> "VortexParams":
        dev = resolve_device(device)
        a = lambda x: torch.tensor(float(x), dtype=torch.float32,
                                   device=dev)
        return cls(a(viscosity), a(dt))


class VortexFlow(NamedTuple):
    u: torch.Tensor           # f32[3, D, H, W] velocity (x, y, z)
    params: VortexParams

    @classmethod
    def init_ring(cls, grid: Tuple[int, int, int], params: VortexParams = None,
                  rings: int = 2, radius: float = 0.22, strength: float = 6.0,
                  device=None) -> "VortexFlow":
        """One or two coaxial vortex rings travelling along +z (two rings
        leapfrog). ``device`` places the flow when ``params`` is None
        (None means CUDA); given params, the flow lies on theirs."""
        params = params or VortexParams.create(device=device)
        dev = params.dt.device
        d, h, w = grid

        def axis(n):
            return (torch.arange(n, dtype=torch.float32, device=dev)
                    + 0.5) / n - 0.5

        z, y, x = torch.meshgrid(axis(d), axis(h), axis(w), indexing="ij")
        u = torch.zeros((3, d, h, w), dtype=torch.float32, device=dev)
        offsets = [-0.12, 0.12][:rings] if rings > 1 else [0.0]
        core = 0.05
        for zo in offsets:
            # swirling velocity about the ring's core circle (x² + y² =
            # radius², z = zo), circulating in the (rho, z) plane
            rho = torch.sqrt(x * x + y * y) + 1e-6
            dr = torch.sqrt((rho - radius) ** 2 + (z - zo) ** 2)
            swirl = strength * torch.exp(-(dr / core) ** 2 / 2)
            u_rho = -swirl * (z - zo) / (dr + 1e-6) * core
            u_z = swirl * (rho - radius) / (dr + 1e-6) * core
            u[0] += u_rho * x / rho
            u[1] += u_rho * y / rho
            u[2] += u_z
        # built in domain units; the solver works in voxel units
        scale = torch.tensor([w, h, d], dtype=torch.float32,
                             device=dev).reshape(3, 1, 1, 1)
        u = u * scale
        return cls(project_divfree(u, params, 0.0), params)

    @property
    def field(self) -> torch.Tensor:
        """Normalised vorticity magnitude ``f32[D, H, W]`` for rendering."""
        w = vorticity(self.u)
        mag = torch.sqrt(torch.sum(w * w, dim=0))
        return mag / (torch.max(mag) + 1e-6)


def _grad_axes(shape, device=None):
    """Periodic spectral wavenumbers for (D, H, W) on the real-FFT grid,
    with the Nyquist bins zeroed: the Nyquist derivative is
    sign-ambiguous, and a nonzero choice breaks the Hermitian symmetry
    of the projected spectrum (irfft then drops the asymmetric part and
    leaves divergence behind)."""
    d, h, w = shape

    def axis_freqs(n, rfft=False):
        k = (torch.fft.rfftfreq(n, device=device) if rfft
             else torch.fft.fftfreq(n, device=device)) * 2 * math.pi
        if n % 2 == 0:
            k[-1 if rfft else n // 2] = 0.0
        return k

    return torch.meshgrid(axis_freqs(d), axis_freqs(h), axis_freqs(w, True),
                          indexing="ij")


def vorticity(u: torch.Tensor) -> torch.Tensor:
    """curl(u) by central differences on the periodic grid (grid units)."""
    def dd(f, dim):
        return 0.5 * (torch.roll(f, -1, dim) - torch.roll(f, 1, dim))

    ux, uy, uz = u[0], u[1], u[2]
    # dims of f[D, H, W]: 0 = z, 1 = y, 2 = x
    wx = dd(uz, 1) - dd(uy, 0)
    wy = dd(ux, 0) - dd(uz, 2)
    wz = dd(uy, 2) - dd(ux, 1)
    return torch.stack([wx, wy, wz])


def _sample_periodic(f: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of the periodic ``f [D, H, W]`` at voxel positions
    ``pos [..., 3]`` (x, y, z) in ``[0, n)``: one wrapped layer is padded
    on BOTH faces and the positions shifted by +1, so the clamped sampler
    interpolates across the low boundary too (positions in [0, 0.5)
    blend f[0] with f[n-1])."""
    fp = torch.nn.functional.pad(f[None, None], (1, 1, 1, 1, 1, 1),
                                 mode="circular")[0, 0]
    return sample_trilinear(fp, pos + 1.0)


def advect_semilagrangian(u: torch.Tensor, dt) -> torch.Tensor:
    """Back-trace each grid point through the velocity field and resample
    (periodic wrap)."""
    _, d, h, w = u.shape

    def centres(n):
        return torch.arange(n, dtype=torch.float32, device=u.device) + 0.5

    z, y, x = torch.meshgrid(centres(d), centres(h), centres(w),
                             indexing="ij")
    # Python's modulus: back-traced positions are negative
    bx = torch.remainder(x - dt * u[0], w)
    by = torch.remainder(y - dt * u[1], h)
    bz = torch.remainder(z - dt * u[2], d)
    pos = torch.stack([bx, by, bz], dim=-1)
    return torch.stack([_sample_periodic(u[i], pos) for i in range(3)])


def project_divfree(u: torch.Tensor, params: VortexParams,
                    dt_override=None) -> torch.Tensor:
    """Spectral viscous decay and the exact Leray projection onto
    divergence-free fields."""
    dt = params.dt if dt_override is None else torch.tensor(
        float(dt_override), dtype=torch.float32, device=u.device)
    _, d, h, w = u.shape
    kz, ky, kx = _grad_axes((d, h, w), device=u.device)
    k2 = kx * kx + ky * ky + kz * kz
    uh = torch.stack([torch.fft.rfftn(u[i]) for i in range(3)])
    uh = uh * torch.exp(-params.viscosity * k2 * dt)
    # remove the component along k: uh -= k (k·uh) / k²
    kdotu = kx * uh[0] + ky * uh[1] + kz * uh[2]
    k2s = torch.where(k2 == 0, 1.0, k2)
    uh = uh - torch.stack([kx, ky, kz]) * (kdotu / k2s)
    return torch.stack([torch.fft.irfftn(uh[i], s=(d, h, w))
                        for i in range(3)]).to(torch.float32)


def seed_tracers(grid: Tuple[int, int, int], n: int, seed: int = 0,
                 device=None) -> torch.Tensor:
    """``f32[N, 3]`` tracer positions in voxel coordinates (x, y, z),
    uniform in the central half of the box (where the rings live),
    drawn from a numpy generator seeded with ``seed``."""
    d, h, w = grid
    u01 = np.random.default_rng(seed).random((n, 3), dtype=np.float32)
    lo = np.array([w * 0.25, h * 0.25, d * 0.25], np.float32)
    ext = np.array([w * 0.5, h * 0.5, d * 0.5], np.float32)
    return torch.as_tensor(lo + u01 * ext, device=resolve_device(device))


def tracer_velocities(u: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The flow's velocity at tracer positions, ``f32[N, 3]`` (voxel units
    a time unit), periodic as `advect_semilagrangian` samples."""
    return torch.stack([_sample_periodic(u[i], pos) for i in range(3)],
                       dim=-1)


def advect_tracers(u: torch.Tensor, pos: torch.Tensor, dt) -> torch.Tensor:
    """One forward-Euler step of passive tracers through the flow (the
    hybrid workload's tracers), periodic."""
    _, d, h, w = u.shape
    vel = tracer_velocities(u, pos)
    box = torch.tensor([w, h, d], dtype=torch.float32, device=pos.device)
    return torch.remainder(pos + dt * vel, box)


def tracers_to_world(pos: torch.Tensor, origin: torch.Tensor,
                     spacing: torch.Tensor) -> torch.Tensor:
    """Voxel-coordinate tracers -> world positions (x, y, z)."""
    return origin + pos * spacing


def step(flow: VortexFlow) -> VortexFlow:
    u = advect_semilagrangian(flow.u, flow.params.dt)
    return flow._replace(u=project_divfree(u, flow.params))


def multi_step(flow: VortexFlow, n: int) -> VortexFlow:
    for _ in range(n):
        flow = step(flow)
    return flow
