"""Parity of the port's sim-fused occupancy path with the JAX package, on
the CPU: the per-brick field ranges and their re-gridding, the pyramid
built from them, the ranges epilogue of the fused stencil (its plain
version), the sim advance that returns ranges, the march gated by the
sim pyramid, and the temporal frame with ``occupancy="sim"``.

Tolerances: ranges, brick grids and pyramids exactly (min and max are
exact, and both sides reduce the same values); the fused stencil's
plain version within 1e-6 of the reference's Pallas stencil in interpret
mode (the same expression, rounded differently by XLA's fused CPU loops:
``tests/test_torch_sim.py``), and its ranges exactly those of its own v;
the sim advance within 1e-5 (state) and 1e-6 (ranges); the gated march
against the ungated one at the reference's bars (colour rtol 1e-5, atol
1e-6, depth 1e-5, ``tests/test_occupancy.py``); the frame at the bars of
``tests/test_torch_pipeline.py``'s occupancy modes (VDI 1e-4, v 1e-5,
thresholds 1e-6)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.core import volume as jvol
from scenery_insitu_tpu.models import pipelines as jpipe
from scenery_insitu_tpu.ops import occupancy as jocc
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.sim import grayscott as jgs
from scenery_insitu_tpu.sim import pallas_stencil as jps
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.models import pipelines as tpipe
from scenery_insitu_tpu_torch.ops import occupancy as tocc
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.sim import cuda_stencil as cst
from scenery_insitu_tpu_torch.sim import grayscott as tgs
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

CPU = "cpu"

AXIS_CAMS = {(2, 1): (0.0, 0.2, -3.0), (1, -1): (0.1, 3.0, 0.2),
             (0, 1): (-3.0, 0.2, 0.1)}


def np_(x):
    return convert.to_numpy(x)


def _field(shape, seed, lo=-0.05):
    rng = np.random.default_rng(seed)
    return (lo + rng.random(shape)).astype(np.float32)


@pytest.mark.parametrize("shape,bricks", [((12, 8, 5), (4, 2)),
                                          ((9, 10, 3), (3, 5)),
                                          ((8, 6, 4), (8, 6))])
def test_field_ranges_match_reference(shape, bricks):
    f = _field(shape, sum(shape))
    want = jocc.field_ranges(jnp.asarray(f), *bricks)
    got = tocc.field_ranges(torch.from_numpy(f), *bricks)
    np.testing.assert_array_equal(np_(got.lo), np.asarray(want.lo))
    np.testing.assert_array_equal(np_(got.hi), np.asarray(want.hi))
    with pytest.raises(ValueError, match="does not divide"):
        tocc.field_ranges(torch.from_numpy(f), shape[0] + 1, 1)


def test_default_bricks_match_reference():
    for shape in [(512,) * 3, (24,) * 3, (48, 24, 24), (20, 36, 28),
                  (64, 64, 64), (7, 13, 5), (100, 90, 8)]:
        assert tocc.default_bricks(shape) == jocc.default_bricks(shape)
    assert tocc.default_bricks((512,) * 3) == (32, 16)


@pytest.mark.parametrize("src,dst", [((4, 2), (2, 2)),     # reduce
                                     ((4, 2), (8, 2)),     # refine
                                     ((6, 4), (4, 6)),     # gcd both axes
                                     ((8, 3), (2, 12)),    # mixed
                                     ((5, 5), (5, 5))])    # identity
def test_remap_ranges_match_reference(src, dst):
    rng = np.random.default_rng(7)
    lo = rng.random(src).astype(np.float32)
    hi = lo + rng.random(src).astype(np.float32)
    jl, jh = jocc.remap_ranges(jnp.asarray(lo), jnp.asarray(hi), dst)
    tl, th = tocc.remap_ranges(torch.from_numpy(lo), torch.from_numpy(hi),
                               dst)
    assert tuple(tl.shape) == dst
    np.testing.assert_array_equal(np_(tl), np.asarray(jl))
    np.testing.assert_array_equal(np_(th), np.asarray(jh))


def _sparse_data(d=48, h=24, w=24, lo=0.7, hi=0.9, seed=3,
                 second_blob=True):
    data = np.zeros((d, h, w), np.float32)
    rng = np.random.RandomState(seed)
    data[4:16, 2:10, 3:14] = rng.uniform(lo, hi, (12, 8, 11))
    if second_blob:
        data[30:38, 14:22, 8:20] = rng.uniform(lo, hi, (8, 8, 12))
    return data


def _both(data, axis_sign, vtiles=6, chunk=16, render_dtype="f32",
          tf_kind="ramp"):
    """(reference, port) of (volume, tf, spec, camera) for one march."""
    eye = AXIS_CAMS[axis_sign]
    if tf_kind == "ramp":
        tfs = (jtf.TransferFunction.ramp(0.05, 0.8, 0.7),
               ttf.TransferFunction.ramp(0.05, 0.8, 0.7, device=CPU))
    else:
        pts = [(0.0, 0.0), (0.35, 0.0), (0.5, 0.9), (0.65, 0.0), (1.0, 0.0)]
        tfs = (jtf.TransferFunction.points(pts),
               ttf.TransferFunction.points(pts, device=CPU))
    out = []
    for vol_m, cam_m, cfg_m, sl, tf in (
            (jvol, jcam, jcfg, jsl, tfs[0]),
            (tvol, tcam, tcfg, tsl, tfs[1])):
        kw = {} if vol_m is jvol else {"device": CPU}
        vol = vol_m.Volume.centered(
            jnp.asarray(data) if vol_m is jvol else torch.from_numpy(data),
            extent=2.0)
        cam = cam_m.Camera.create(eye, target=(0.0, 0.0, 0.0),
                                  fov_y_deg=45.0, **kw)
        spec = sl.make_spec(cam, tuple(data.shape), cfg_m.SliceMarchConfig(
            matmul_dtype="f32", scale=1.0, chunk=chunk,
            occupancy_vtiles=vtiles, render_dtype=render_dtype))
        assert (spec.axis, spec.sign) == axis_sign
        out.append((vol, tf, spec, cam))
    return out


@pytest.mark.parametrize("axis_sign", sorted(AXIS_CAMS))
@pytest.mark.parametrize("variant", ["f32", "padded", "bf16", "bandpass"])
def test_pyramid_from_ranges_matches_reference(axis_sign, variant):
    """Chunk 10 leaves a zero-padded last chunk on every axis; bf16
    widens the ranges; the band-pass TF gates a range that straddles
    its band."""
    data = _sparse_data(second_blob=False)
    (jv, jt, js, _), (tv, tt, ts, _) = _both(
        data, axis_sign, chunk=10 if variant == "padded" else 16,
        render_dtype="bf16" if variant == "bf16" else "f32",
        tf_kind="bandpass" if variant == "bandpass" else "ramp")
    want = jocc.pyramid_from_ranges(jocc.field_ranges(jv.data, 12, 6), jv,
                                    jt, js)
    rng = convert.field_ranges(
        {f: np.asarray(x) for f, x in
         zip(("lo", "hi"), jocc.field_ranges(jv.data, 12, 6))}, device=CPU)
    got = tocc.pyramid_from_ranges(rng, tv, tt, ts)
    assert got.lo.shape == want.lo.shape
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    assert not np_(got.tiles).all()
    # the same from the port's own reduction of the field
    own = tocc.pyramid_from_ranges(tocc.field_ranges(tv.data, 12, 6), tv,
                                   tt, ts)
    for a, b in zip(own, got):
        assert torch.equal(a, b)


def test_pyramid_live_fractions_match_reference():
    data = _sparse_data()
    (jv, jt, js, _), (tv, tt, ts, _) = _both(data, (2, 1))
    want = jocc.pyramid_from_volume(jv, jt, js)
    got = tocc.pyramid_from_volume(tv, tt, ts)
    np.testing.assert_array_equal(np_(got.chunk_live_fractions()),
                                  np.asarray(want.chunk_live_fractions()))
    assert float(got.live_fraction()) == float(want.live_fraction())
    with pytest.raises(ValueError, match="does not divide"):
        tocc.pyramid_from_ranges(tocc.FieldRanges(torch.zeros(5, 6),
                                                  torch.zeros(5, 6)), tv,
                                 tt, ts)


def _states(grid, seed=0, noise=0.05):
    st = jgs.GrayScott.init(grid, n_seeds=2, seed=seed)
    rng = np.random.default_rng(seed)
    u = (np.asarray(st.u) - noise * rng.random(grid)).astype(np.float32)
    v = (np.asarray(st.v) + noise * rng.random(grid)).astype(np.float32)
    params = [np.asarray(x) for x in st.params]
    return (jgs.GrayScott(jnp.asarray(u), jnp.asarray(v), st.params),
            convert.gray_scott(u, v, params, device=CPU))


@pytest.mark.parametrize("t", [1, 2, 4])
def test_step_ranges_plain_matches_pallas_epilogue(t):
    js, ts = _states((16, 16, 24), seed=t)
    p = js.params
    pvec = jnp.stack([p.f, p.k, p.du, p.dv, p.dt])
    ju, jv, jlo, jhi = jps.step_pallas(js.u, js.v, pvec, t, interpret=True,
                                       tz=4, with_ranges=True)
    bricks = (16 // 4, 1)
    tu, tv, tlo, thi = cst.step_fused_ranges_plain(
        ts.u, ts.v, ts.params.vector(), t, bricks)
    for a, b in ((tu, ju), (tv, jv), (tlo, jlo), (thi, jhi)):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0, atol=1e-6)
    own = tocc.field_ranges(tv, *bricks)
    assert torch.equal(tlo, own.lo) and torch.equal(thi, own.hi)
    # the wrapper runs the plain version on a CPU tensor
    wu, wv, wlo, whi = cst.step_fused_ranges(ts.u, ts.v, ts.params.vector(),
                                             t, bricks)
    assert torch.equal(wv, tv) and torch.equal(wlo, tlo) and \
        torch.equal(whi, thi)
    with pytest.raises(ValueError, match="brick grid"):
        cst.step_fused_ranges(ts.u, ts.v, ts.params.vector(), t, (5, 1))


@pytest.mark.parametrize("n,fused,bricks", [(10, True, None),
                                            (5, True, (4, 8)),
                                            (3, False, None),
                                            (0, True, (2, 2))])
def test_multi_step_fast_ranges_matches_reference(n, fused, bricks):
    js, ts = _states((16, 16, 24), seed=n)
    jst, jr = jgs.multi_step_fast_ranges(js, n, bricks=bricks, fused=fused)
    tst, tr = tgs.multi_step_fast_ranges(ts, n, bricks=bricks, fused=fused)
    for a, b in ((tst.u, jst.u), (tst.v, jst.v)):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0, atol=1e-5)
    want_shape = bricks or jocc.default_bricks((16, 16, 24))
    assert tuple(tr.lo.shape) == tuple(want_shape)
    for a, b in ((tr.lo, jr.lo), (tr.hi, jr.hi)):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0, atol=1e-6)
    own = tocc.field_ranges(tst.v, *want_shape)
    assert torch.equal(tr.lo, own.lo) and torch.equal(tr.hi, own.hi)
    if n == 0:
        assert torch.equal(tst.v, ts.v)


@pytest.mark.parametrize("axis_sign", sorted(AXIS_CAMS))
def test_generation_with_sim_pyramid_matches_ungated(axis_sign):
    """One corner blob, so the x march (whose bricks resolve z only)
    still gates in-plane tiles."""
    data = _sparse_data(second_blob=False)
    _, (vol, tf, spec, cam) = _both(data, axis_sign)
    cfg = tcfg.VDIConfig(max_supersegments=6, adaptive_iters=2)
    pyr = tocc.pyramid_from_ranges(tocc.field_ranges(vol.data, 12, 6), vol,
                                   tf, spec)
    assert not bool(pyr.tiles.all())
    on, _, _ = tsl.generate_vdi_mxu(vol, tf, cam, spec, cfg, occupancy=pyr)
    spec_off = dataclasses.replace(spec, skip_empty=False, vtiles=0)
    off, _, _ = tsl.generate_vdi_mxu(vol, tf, cam, spec_off, cfg)
    np.testing.assert_allclose(np_(on.color), np_(off.color), rtol=1e-5,
                               atol=1e-6)
    d_on = np.nan_to_num(np_(on.depth), posinf=1e9)
    d_off = np.nan_to_num(np_(off.depth), posinf=1e9)
    np.testing.assert_allclose(d_on, d_off, rtol=1e-5, atol=1e-5)


def test_sim_occupancy_frame_matches_reference():
    """3 temporal frames with ``occupancy="sim"`` (16 v-tiles asked, 12
    on this grid) from the same u, v as the reference's frame step, the
    sim through the fused stencil's plain version (``sim_fused=False``,
    the roll formulation, is held in the sim advance's test above)."""
    n, k = 24, 6
    st = jgs.multi_step(jgs.GrayScott.init((n,) * 3, n_seeds=3, seed=0), 4)
    u, v = np.asarray(st.u), np.asarray(st.v)
    params = [np.asarray(x) for x in st.params]
    eyes = [(0.3 * np.sin(0.7 * i), 0.6, 3.0) for i in range(4)]
    kw = dict(sim_steps=3, grid_shape=(n,) * 3, sim_fused=True,
              fov_y_deg=50.0, occupancy="sim", engine="mxu",
              axis_sign=(2, -1))
    jstep = jpipe.grayscott_vdi_frame_step(
        64, 48, vdi_cfg=jcfg.VDIConfig(max_supersegments=k,
                                       adaptive_mode="temporal",
                                       histogram_bins=8),
        comp_cfg=jcfg.CompositeConfig(max_output_supersegments=k),
        slicer_cfg=jcfg.SliceMarchConfig(matmul_dtype="f32", fold="seg"),
        params=jgs.GrayScottParams(*(jnp.asarray(p) for p in params)), **kw)
    tstep = tpipe.grayscott_vdi_frame_step(
        vdi_cfg=tcfg.VDIConfig(max_supersegments=k, adaptive_mode="temporal",
                               histogram_bins=8),
        comp_cfg=tcfg.CompositeConfig(max_output_supersegments=k),
        slicer_cfg=tcfg.SliceMarchConfig(fold="seg"),
        params=tgs.GrayScottParams(*(torch.from_numpy(np.array(p))
                                     for p in params)), device=CPU, **kw)
    assert tstep.spec.vtiles == 12 and tstep.spec.skip_empty
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    tu, tv = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
    jthr = jstep.init_threshold(ju, jv, jnp.asarray(eyes[0], jnp.float32))
    tthr = tstep.init_threshold(tu, tv, torch.tensor(eyes[0]))
    for i in range(1, 4):
        jc, jd, ju, jv, jthr = jstep(ju, jv, jnp.asarray(eyes[i],
                                                          jnp.float32), jthr)
        tc, td, tu, tv, tthr = tstep(tu, tv, torch.tensor(eyes[i]), tthr)
        np.testing.assert_allclose(np_(tc), np.asarray(jc), rtol=1e-4,
                                   atol=1e-4)
        live = np.isfinite(np.asarray(jd))
        assert (np.isfinite(np_(td)) == live).all(), "VDI slot liveness"
        np.testing.assert_allclose(np_(td)[live], np.asarray(jd)[live],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np_(tv), np.asarray(jv), atol=1e-5)
        for a, b in zip(tthr, jthr):
            np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-6)
    assert np.isfinite(np_(td)[:, 0]).any(), "the frame has live slots"
