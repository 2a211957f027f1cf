"""Parity of the port's Gray-Scott simulation with the JAX package, on the
CPU: the roll formulation (`multi_step`) and the fused-stencil path
(`multi_step_fast`, which on the CPU runs the plain version of kernel K3
in the reference's greedy T decomposition) against JAX `multi_step` and
the reference's Pallas stencil in interpret mode.

Tolerance: atol 1e-6 * n for n steps. Both sides evaluate the same
expression in the same order; XLA's fused CPU loops round a few
products differently, and the measured worst case on these grids is
3.0e-7 (u, n=5; 2.4e-7 at n=10, 6.0e-8 at n=1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu.sim import grayscott as jgs
from scenery_insitu_tpu.sim import pallas_stencil as jps
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch.config import SimConfig
from scenery_insitu_tpu_torch.sim import cuda_stencil as cst
from scenery_insitu_tpu_torch.sim import grayscott as tgs
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

CPU = "cpu"


def _states(grid, seed=0, noise=0.05):
    """The same (u, v) for both packages: the reference's seeded init
    plus numpy noise, so the fields are not piecewise constant."""
    st = jgs.GrayScott.init(grid, n_seeds=2, seed=seed)
    rng = np.random.default_rng(seed)
    u = (np.asarray(st.u) - noise * rng.random(grid)).astype(np.float32)
    v = (np.asarray(st.v) + noise * rng.random(grid)).astype(np.float32)
    js = jgs.GrayScott(jnp.asarray(u), jnp.asarray(v), st.params)
    ts = convert.gray_scott(u, v, [np.asarray(x) for x in st.params],
                            device=CPU)
    return js, ts


def _close(ts, ju, jv, n):
    for a, b in ((ts.u, ju), (ts.v, jv)):
        np.testing.assert_allclose(convert.to_numpy(a), np.asarray(b),
                                   atol=1e-6 * n, rtol=0)


@pytest.mark.parametrize("n", [1, 5, 10])
def test_multi_step_matches_reference(n):
    js, ts = _states((16, 16, 32))
    ref = jgs.multi_step(js, n)
    _close(tgs.multi_step(ts, n), ref.u, ref.v, n)


@pytest.mark.parametrize("n", [1, 5, 10])
def test_fused_path_matches_pallas_stencil_interpret(n):
    js, ts = _states((16, 16, 128), seed=1)
    p = js.params
    pvec = jnp.stack([p.f, p.k, p.du, p.dv, p.dt])
    ju, jv = jps.multi_step_pallas(js.u, js.v, pvec, n, interpret=True)
    _close(tgs.multi_step_fast(ts, n), ju, jv, n)


@pytest.mark.parametrize("n", [3, 10])
def test_ragged_grid_matches_roll_reference(n):
    """A grid no tile divides (the reference's Pallas stencil rejects
    it); the fused path runs it and must equal JAX multi_step."""
    js, ts = _states((20, 24, 28), seed=2)
    ref = jgs.multi_step(js, n)
    _close(tgs.multi_step_fast(ts, n), ref.u, ref.v, n)


def test_greedy_decomposition():
    assert cst.decompose(10) == [4, 4, 2]
    assert cst.decompose(5) == [4, 1]
    assert cst.decompose(7) == [4, 3]
    assert cst.decompose(3) == [3]
    assert cst.decompose(0) == []
    for n in range(1, 20):
        assert sum(cst.decompose(n)) == n
        assert max(cst.decompose(n)) <= cst.FUSE_T


def test_init_and_params_match_reference():
    """Without satellite seeds the init is deterministic on both sides
    (the satellites come from jax.random in the reference and from a
    numpy seed here)."""
    j = jgs.GrayScott.init((12, 16, 20), n_seeds=0)
    t = tgs.GrayScott.init((12, 16, 20), n_seeds=0, device=CPU)
    np.testing.assert_array_equal(convert.to_numpy(t.u), np.asarray(j.u))
    np.testing.assert_array_equal(convert.to_numpy(t.v), np.asarray(j.v))
    for a, b in zip(t.params, j.params):
        np.testing.assert_array_equal(convert.to_numpy(a), np.asarray(b))
    a = tgs.GrayScott.init((12, 16, 20), seed=3, device=CPU)
    b = tgs.GrayScott.init((12, 16, 20), seed=3, device=CPU)
    assert torch.equal(a.v, b.v) and float(a.v.sum()) > float(t.v.sum())
    cfg = SimConfig(grid=(8, 8, 8), gs_f=0.03)
    s = tgs.GrayScott.from_config(cfg, device=CPU)
    assert tuple(s.u.shape) == (8, 8, 8)
    assert float(s.params.vector()[0]) == pytest.approx(0.03)


@pytest.mark.parametrize("grid,seed", [((12, 16, 20), 3), ((16, 9, 24), 5)])
def test_init_seed_cubes_are_the_cells_within_radius(grid, seed):
    """Each seed cube is the set of cells with |index - centre| < r on
    every axis, the reference's mask, for the central cube and the
    numpy-drawn satellites, cut at the grid's edges."""
    d, h, w = grid
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    rs = max(min(grid) // 8, 2)
    cubes = [((d // 2, h // 2, w // 2), max(min(grid) // 4, 2))]
    rng = np.random.default_rng(seed)
    cubes += [(rng.integers(rs, np.array([d - rs, h - rs, w - rs])), rs)
              for _ in range(4)]
    mask = np.zeros(grid, bool)
    for c, r in cubes:
        mask |= ((np.abs(zz - c[0]) < r) & (np.abs(yy - c[1]) < r)
                 & (np.abs(xx - c[2]) < r))
    st = tgs.GrayScott.init(grid, seed=seed, device=CPU)
    np.testing.assert_array_equal(st.u.numpy(), np.where(mask, 0.5, 1.0))
    np.testing.assert_array_equal(st.v.numpy(), np.where(mask, 0.25, 0.0))


def test_step_fused_rejects_bad_operands():
    _, ts = _states((8, 8, 8))
    p = ts.params.vector()
    with pytest.raises(ValueError, match="t_steps"):
        cst.step_fused(ts.u, ts.v, p, 5)
    with pytest.raises(TypeError):
        cst.step_fused(ts.u.double(), ts.v, p, 1)
    with pytest.raises(ValueError, match="shape"):
        cst.step_fused(ts.u, ts.v[:4], p, 1)
    with pytest.raises(ValueError, match="params"):
        cst.step_fused(ts.u, ts.v, p[:4], 1)
    with pytest.raises(ValueError, match="contiguous"):
        cst.step_fused(ts.u.transpose(0, 2), ts.v.transpose(0, 2), p, 1)
