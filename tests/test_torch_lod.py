"""Parity of the port's LOD brick marching (per-brick levels on a
``BrickMap``) with the JAX package's, on the CPU.

Every function of ``parallel/lod.py`` (``per_brick``,
``admissible_max_level``, ``screen_error_caps``, ``select_levels`` with
its TF-straddle property over the reference's seeds,
``level_work_scale``, ``modeled_march_flops``) and ``opacity_edges``
give the reference's values exactly. ``reslab_bricks_lod`` equals the
reference's pooled levels (rtol 1e-6, atol 1e-7), f32 and bf16, with the
reference's message for a plane the level does not tile. The 8-rank
distributed mxu step under the reference tests' empty-brick level-2 map
and uniform level-1 map, in both march regimes (and the level-2 map's
temporal step), matches the reference's same steps at the ``xla`` fold
bar; the empty-brick map matches the even step at the 1e-5 gate, the
uniform level-1 map holds 28 dB on the smooth field as
``tests/test_lod.py`` holds it; an all-level-0 map is the plain brick
build bit for bit; a rank owning no brick runs through the tile waves
with and without levels. The session's level replan matches the
reference's session (the same owners, levels and frames), and
``lod.enabled`` without bricks is inert on the ledger. A steered TF
update clears the plan clock, and the next replan brings every brick
that straddles a new opacity edge back to level 0, with the reference's
levels before and after."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.parallel import lod as jlod
from scenery_insitu_tpu.parallel import mesh as jmesh
from scenery_insitu_tpu.runtime import session as jses
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core.vdi import VDI, render_vdi_same_view
from scenery_insitu_tpu_torch.parallel import lod as tlod
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.runtime import session as tses
from tests.test_torch_bricks import ISLANDS, OWNER, maps
from tests.test_torch_rebalance import (CPU, D, EYES, GATE, HW, N, REGIMES,
                                        MovingSim, assert_frames_close,
                                        assert_meta_global,
                                        assert_sessions_match, jax_sharded,
                                        port_slabs, run_jax, run_port,
                                        run_sessions, scene_data,
                                        session_overrides)
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

EMPTY_L2 = (0, 0, 0, 0, 0, 0, 2, 0)      # brick 6 (rows 24..27) is empty
UNIFORM_L1 = (1,) * N
PSNR_FLOOR_DB = 28.0


def _lod_cfg(pkg, **kw):
    base = dict(enabled=True, max_level=2, error_px=1.0)
    base.update(kw)
    return pkg.LODConfig(**base)


def _plan_kw(rng):
    vox = 2.0 / D
    return dict(dims=(HW, HW, D),
                origin=np.asarray([-HW * vox / 2, -HW * vox / 2, -1.0]),
                spacing=np.full(3, vox),
                eye=rng.uniform(-3.0, 3.0, 3) + np.asarray([0, 0, 2.5]),
                fov_y=np.deg2rad(50.0), height_px=int(rng.integers(32, 128)))


# ---------------------------------------------------------------- planner


def test_lod_helpers_match_reference():
    prof = np.random.default_rng(1).random(16)
    for nb in (8, 16, 32, 4):
        for red in ("mean", "min", "max"):
            np.testing.assert_array_equal(tlod.per_brick(prof, nb, red),
                                          jlod.per_brick(prof, nb, red))
    for fn in (lambda m: m.per_brick(prof, 6),
               lambda m: m.per_brick(prof, 8, "median"),
               lambda m: m.per_brick(prof, 0)):
        with pytest.raises(ValueError) as a:
            fn(jlod)
        with pytest.raises(ValueError) as b:
            fn(tlod)
        assert str(a.value) == str(b.value)
    for args in [(4, 16, 16, 8), (8, 16, 16, 2), (8, 16, 16, 8),
                 (4, 2, 16, 8), (16, 512, 512, 2), (1, 8, 8, 3)]:
        assert tlod.admissible_max_level(*args) == \
            jlod.admissible_max_level(*args)
    rng = np.random.default_rng(2)
    centers = rng.uniform(-1, 1, (8, 3))
    for eye in ((0, 0, 2.5), (0, 0, 60.0), (0.1, 0.0, 0.0)):
        np.testing.assert_array_equal(
            tlod.screen_error_caps(centers, 0.4, eye, 0.87, 64, 0.0625,
                                   1.0, 2),
            jlod.screen_error_caps(centers, 0.4, eye, 0.87, 64, 0.0625,
                                   1.0, 2))
    for lv in ((0,) * 8, (0, 1, 2, 0, 0, 0, 0, 0), (2,) * 8, UNIFORM_L1):
        for ni, nj in ((32, 32), (640, 640)):
            np.testing.assert_array_equal(
                tlod.level_work_scale(lv, (HW, HW, D), ni, nj),
                jlod.level_work_scale(lv, (HW, HW, D), ni, nj))
            assert tlod.modeled_march_flops(lv, (HW, HW, D), ni, nj) == \
                jlod.modeled_march_flops(lv, (HW, HW, D), ni, nj)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_select_levels_matches_reference_and_straddle_property(seed):
    """The reference's seeds: random ranges, live fractions, cameras and
    previous plans; the levels equal the reference's, and no brick whose
    range crosses an opacity edge leaves level 0."""
    rng = np.random.default_rng(seed)
    nb = 16
    lo = rng.uniform(0.0, 0.9, nb)
    hi = lo + rng.uniform(0.0, 0.5, nb)
    live = rng.uniform(0.0, 1.0, nb) * (rng.random(nb) > 0.3)
    edges = ttf.opacity_edges(
        ttf.TransferFunction.ramp(0.05, 0.8, 0.7, device=CPU))
    prev = tuple(int(x) for x in rng.integers(0, 3, nb))
    for err, coarsen, hyst in ((1e4, True, 0.2), (1.0, True, 0.0),
                               (0.01, False, 0.5), (30.0, True, 0.2)):
        kw = _plan_kw(rng)
        for p in (None, prev):
            got = tlod.select_levels(live, lo, hi, edges, cfg=_lod_cfg(
                tcfg, error_px=err, coarsen_empty=coarsen,
                hysteresis=hyst), prev=p, **kw)
            want = jlod.select_levels(live, lo, hi, edges, cfg=_lod_cfg(
                jcfg, error_px=err, coarsen_empty=coarsen,
                hysteresis=hyst), prev=p, **kw)
            assert got == want
            for i in range(nb):
                if any(lo[i] - 1e-4 < e < hi[i] + 1e-4 for e in edges):
                    assert got[i] == 0
    with pytest.raises(ValueError) as a:
        jlod.select_levels(live[:4], lo, hi, edges, cfg=_lod_cfg(jcfg),
                           **_plan_kw(rng))
    with pytest.raises(ValueError) as b:
        tlod.select_levels(live[:4], lo, hi, edges, cfg=_lod_cfg(tcfg),
                           **_plan_kw(rng))
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("name", ["ramp", "gray_scott", "procedural",
                                  "points"])
def test_opacity_edges_match_reference(name):
    if name == "ramp":
        j = jtf.TransferFunction.ramp(0.05, 0.8, 0.7)
        t = ttf.TransferFunction.ramp(0.05, 0.8, 0.7, device=CPU)
    elif name == "points":
        pts = [(0.0, 0.8), (0.01, 0.0), (0.5, 0.0), (1.0, 0.3)]
        j = jtf.TransferFunction.points(pts)
        t = ttf.TransferFunction.points(pts, device=CPU)
    else:
        j, t = jtf.for_dataset(name), ttf.for_dataset(name, device=CPU)
    for eps in (1e-4, 0.5):
        got, want = ttf.opacity_edges(t, eps), jtf.opacity_edges(j, eps)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- pooled reslab


@pytest.mark.parametrize("h", [0, 1])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reslab_bricks_lod_matches_reference(h, dtype):
    data = np.random.default_rng(7).uniform(0, 1, (D, 8, 8)).astype(
        np.float32)
    jm, tm = maps(ISLANDS, (0, 1, 0, 2, 0, 1, 0, 0))
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    want = jax_sharded(
        lambda x: jmesh.reslab_bricks_lod(x.astype(jdt), jm, "ranks", h=h),
        data, out_dims=4, levels=jm.levels_present())
    slabs = port_slabs(data)
    if dtype == "bf16":
        slabs = slabs.to(torch.bfloat16)
    got = tmesh.reslab_bricks_lod(slabs, tm, h=h)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for lvl, arr in got.items():
        w = np.asarray(want[lvl].astype(np.float32))
        g = arr.to(torch.float32).numpy()
        assert g.shape == w.reshape(g.shape).shape
        tol = dict(rtol=1e-6, atol=1e-7) if dtype == "f32" else \
            dict(rtol=2 ** -8, atol=0)
        np.testing.assert_allclose(g, w.reshape(g.shape), **tol)
    # level 0 of a leveled map is `reslab_bricks`' rows bit for bit
    plain = tmesh.reslab_bricks(slabs, tm, h=h)
    table0 = tm.start_table_at(0)
    for r in range(N):
        for s, st in enumerate(table0[r]):
            if st >= 0:
                col = list(tm.start_table()[r]).index(st)
                assert torch.equal(got[0][r, s], plain[r, col])


def test_reslab_bricks_lod_rejects_non_dividing_plane():
    data = np.zeros((D, 6, 6), np.float32)
    jm, tm = maps(ISLANDS, (2,) + (0,) * 7)
    with pytest.raises(ValueError) as a:
        jax_sharded(lambda x: jmesh.reslab_bricks_lod(x, jm, "ranks"),
                    data, out_dims=4, levels=jm.levels_present())
    with pytest.raises(ValueError) as b:
        tmesh.reslab_bricks_lod(port_slabs(data), tm)
    assert str(a.value) == str(b.value) and "lod.max_level" in str(b.value)


# ------------------------------------------------------- distributed steps


@pytest.fixture(scope="module", params=range(len(EYES)), ids=REGIMES)
def lod_steps(request):
    """Per march regime: the reference's step under the empty-brick
    level-2 map and the uniform level-1 map, and the level-2 map's seed
    and 2 temporal frames on the noisy scene."""
    eye = EYES[request.param]
    return dict(
        eye=eye,
        empty=run_jax(eye, "bricks", bricks=maps(OWNER, EMPTY_L2)[0]),
        uniform=run_jax(eye, "bricks",
                        bricks=maps(tuple(range(N)), UNIFORM_L1)[0]),
        temporal=run_jax(eye, "bricks", temporal=True,
                         data=scene_data("noisy"),
                         bricks=maps(OWNER, EMPTY_L2)[0]))


def test_coarse_empty_brick_step_matches_reference_and_even(lod_steps):
    eye = lod_steps["eye"]
    got = run_port(eye, "bricks", bricks=maps(OWNER, EMPTY_L2)[1])
    assert_frames_close(got, lod_steps["empty"])
    assert_meta_global(got, lod_steps["empty"][0][3])
    if eye == EYES[0]:
        # pooled air is air: the reference's gate, on its march axis
        assert_frames_close(got, run_port(eye), rtol=0.0, atol=GATE)


def test_uniform_level1_step_matches_reference(lod_steps):
    got = run_port(lod_steps["eye"], "bricks",
                   bricks=maps(tuple(range(N)), UNIFORM_L1)[1])
    assert_frames_close(got, lod_steps["uniform"])


def test_coarse_temporal_step_matches_reference(lod_steps):
    got = run_port(lod_steps["eye"], "bricks", temporal=True,
                   data=scene_data("noisy"),
                   bricks=maps(OWNER, EMPTY_L2)[1])
    assert_frames_close(got, lod_steps["temporal"])


def _psnr(a, b):
    mse = float(torch.mean((a.double() - b.double()) ** 2))
    return np.inf if mse == 0.0 else 10.0 * np.log10(1.0 / mse)


@pytest.mark.parametrize("eye", EYES, ids=REGIMES)
def test_uniform_level1_smooth_field_psnr_floor(eye):
    """The coarse march (pooled volume, ``dwm * 2``, ``step_scale =
    1/2``) on the smooth field holds the reference's 28 dB floor against
    the exact frame."""
    smooth = scene_data("smooth")
    even = run_port(eye, data=smooth)
    lod = run_port(eye, "bricks", data=smooth,
                   bricks=maps(tuple(range(N)), UNIFORM_L1)[1])
    img = [render_vdi_same_view(VDI(torch.from_numpy(c), torch.from_numpy(d)))
           for c, d, _, _ in (even[0], lod[0])]
    assert _psnr(*img) > PSNR_FLOOR_DB


def test_level0_map_is_the_plain_brick_build():
    bm = maps(OWNER)[1]
    bm0 = maps(OWNER, (0,) * N)[1]
    assert bm0 == bm
    a = run_port(EYES[1], "bricks", bricks=bm)
    b = run_port(EYES[1], "bricks", bricks=bm0)
    for x, y in zip(a[0][:2], b[0][:2]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("level", [(), EMPTY_L2], ids=["fine", "coarse"])
def test_zero_brick_rank_through_waves(level):
    """A rank owning no brick runs end to end through the tile waves,
    with and without levels, and matches the frame schedule."""
    bm = maps(ISLANDS, level)[1]
    base = run_port(EYES[0], "bricks", bricks=bm)
    waves = run_port(EYES[0], "bricks", bricks=bm,
                     comp=dict(schedule="waves", wave_tiles=2))
    assert_frames_close(waves, base, rtol=0.0, atol=GATE)


# ------------------------------------------------------------ the session


def test_session_lod_replan_matches_reference():
    """``lod.enabled`` with ``rebalance=bricks`` on 4 ranks: the replan
    assigns coarse levels to the bricks whose ranges straddle no opacity
    edge (a huge ``error_px`` admits them), the same owners and levels
    at the same frames as the reference's, and the same frames."""
    frames = 3
    out = run_sessions(frames, n=4, **{
        "composite.rebalance": "bricks", "composite.rebalance_period": "2",
        "composite.rebalance_bricks": "8", "lod.enabled": "true",
        "lod.error_px": "1000"})
    assert_sessions_match(out, frames)
    ev = out["port"][1]
    assert ev and max(ev[0]["level"]) > 0 and ev[0]["level"] == \
        out["jax"][1][0]["level"]
    sess = out["port"][3]
    assert sess._bricks is not None and sess._bricks.max_level > 0


def test_session_lod_inert_without_bricks_on_the_ledger():
    tobs.clear_ledger()
    sess = tses.InSituSession(
        tcfg.FrameworkConfig().with_overrides(*session_overrides(
            2, **{"lod.enabled": "true"})),
        sim=MovingSim(torch.from_numpy), device=CPU)
    sess.run(1)
    assert sess._bricks is None
    assert any(e["component"] == "lod.inert" for e in tobs.ledger())


class _SkewedSim:
    """The reference test's static field: value 0.6 in slices 1..7 of
    32, zero elsewhere (numpy; wrapped for either package)."""

    kind = "skewed"

    def __init__(self, wrap):
        data = np.zeros((D, HW, HW), np.float32)
        data[1:8] = 0.6
        self.field = wrap(data)

    def advance(self, n):
        pass


LOD_STEER_OVER = ("composite.rebalance=bricks",
                  "composite.rebalance_period=2",
                  "composite.rebalance_bricks=8", "render.width=32",
                  "render.height=32", "slicer.engine=mxu",
                  "slicer.matmul_dtype=f32", "obs.enabled=true",
                  "lod.enabled=true", "lod.error_px=1000",
                  f"mesh.num_devices={N}")
STEERED_TF = {"type": "tf", "points": [[0.0, 0.8], [0.01, 0.0], [1.0, 0.0]]}


def test_session_lod_tf_straddle_after_steered_update():
    """A steered TF update moves the opacity edges; the very next replan
    re-runs the level gate under the NEW TF (the update clears the plan
    clock), so bricks now straddling an edge are back at level 0 before
    the next marched frame — the levels before and after the update are
    the reference's session's."""
    levels = {}
    for name, pkg, ses, wrap, kw in (
            ("jax", jcfg, jses, jnp.asarray, {}),
            ("port", tcfg, tses, torch.from_numpy, {"device": CPU})):
        sess = ses.InSituSession(
            pkg.FrameworkConfig().with_overrides(*LOD_STEER_OVER),
            sim=_SkewedSim(wrap), **kw)
        for _ in range(3):
            sess.render_frame()
        before = tuple(sess._bricks.level)
        # the new TF's opacity lives at 0.0..0.01 only: the 0.6 slabs go
        # transparent and their bricks' ranges [0, 0.6] straddle 0.01
        sess._apply_tf_message(dict(STEERED_TF))
        assert sess._plan_frame is None                  # forced replan
        sess.render_frame()
        levels[name] = (before, tuple(sess._bricks.level))
    assert levels["port"] == levels["jax"]
    assert max(levels["port"][0]) > 0
    edges = ttf.opacity_edges(sess.tf)
    lo, hi = sess._replan_ranges()
    lo_b = tlod.per_brick(lo, sess._bricks.nbricks, "min")
    hi_b = tlod.per_brick(hi, sess._bricks.nbricks, "max")
    straddled = 0
    for i, lvl in enumerate(sess._bricks.level):
        if any(lo_b[i] - 1e-4 < e < hi_b[i] + 1e-4 for e in edges):
            straddled += 1
            assert lvl == 0, (i, lo_b[i], hi_b[i], edges)
    assert straddled
