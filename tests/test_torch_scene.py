"""Parity of the port's multi-grid scene (``core/scene.py``), its
externally driven session (``runtime/scene_session.py``) and the slice
march's ``u_bounds`` with the JAX package's, on the CPU.

The cases of ``tests/test_scene.py`` on its 24^3 blob volume: each
whole-scene render (plain, gather VDI, slice-march VDI cut in z and cut
in x) is held against the reference's same call within 1e-5 and keeps
the reference's dB bar against the port's own single volume. The scene
session's frames are held against the reference's jitted session at the
golden tolerance (rtol 2e-4, atol 2e-5: XLA fuses the jitted march where
the port runs it eagerly), and its caches (steps, thresholds, the extent
cache, regime re-entry, prewarm) behave as the reference's. The
``u_bounds`` march of one grid of an x-split equals the reference's
within 1e-5 and differs from the march without it. Each reference run
is shared through a module fixture."""

import glob

import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.core import scene as jscene
from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.core import volume as jvol
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.runtime import scene_session as jss
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import scene as tscene
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.core.vdi import VDI, render_vdi_same_view
from scenery_insitu_tpu_torch.ops import composite as tcomp
from scenery_insitu_tpu_torch.ops import raycast as tray
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.ops import supersegments as tsup
from scenery_insitu_tpu_torch.ops import vdi_gen as tgen
from scenery_insitu_tpu_torch.runtime import scene_session as tss
from scenery_insitu_tpu_torch.runtime import session as tses
from scenery_insitu_tpu_torch.utils.image import psnr
from tests.test_torch_pipeline import (  # noqa: F401
    assert_vdi_close, np_, one_torch_thread)

CPU = "cpu"
GATE = 1e-5                     # port against reference, eager calls
JIT_RTOL, JIT_ATOL = 2e-4, 2e-5  # against the reference's jitted session
VDI_KW = dict(max_supersegments=6, adaptive_iters=2)
COMP_KW = dict(max_output_supersegments=8, adaptive_iters=2)
F32_KW = dict(matmul_dtype="f32", scale=1.5)
SESSION_OVER = ("vdi.max_supersegments=4",
                "composite.max_output_supersegments=6",
                "composite.adaptive_iters=1", "slicer.engine=mxu",
                "slicer.matmul_dtype=f32", "runtime.dataset=procedural")
TEMPORAL_OVER = SESSION_OVER + ("vdi.adaptive_mode=temporal",)
EYE_Z = (0.1, 0.2, 3.0)
EYE_X = (3.0, 0.2, 0.1)


@pytest.fixture(scope="module")
def vol():
    """The reference's volume, its numpy data and the port's twin."""
    j = jvol.procedural_volume(24, kind="blobs", seed=5)
    data = np.asarray(j.data)
    t = tvol.Volume.create(data, np.asarray(j.origin), np.asarray(j.spacing),
                           device=CPU)
    return dict(j=j, t=t, data=data, origin=np.asarray(j.origin),
                spacing=np.asarray(j.spacing))


def _tf(pkg):
    return (ttf.for_dataset("procedural", device=CPU) if pkg == "t"
            else jtf.for_dataset("procedural"))


def _cam(pkg, eye):
    if pkg == "t":
        return tcam.Camera.create(eye, fov_y_deg=45.0, near=0.3, far=10.0,
                                  device=CPU)
    return jcam.Camera.create(eye, fov_y_deg=45.0, near=0.3, far=10.0)


def _cfgs(pkg):
    c = tcfg if pkg == "t" else jcfg
    return c.VDIConfig(**VDI_KW), c.CompositeConfig(**COMP_KW)


def _scene(pkg, vol, axis, cuts):
    """The volume cut along data axis ``axis`` (0 z, 2 x) at ``cuts``
    into grids with 1-voxel ghosts on their inner faces."""
    scene = tscene.MultiGridScene(CPU) if pkg == "t" \
        else jscene.MultiGridScene()
    data, sp = vol["data"], vol["spacing"]
    n = data.shape[axis]
    xyz = {0: 2, 2: 0}[axis]
    edges = [0] + list(cuts) + [n]
    for i, (a0, a1) in enumerate(zip(edges[:-1], edges[1:])):
        g_lo = 1 if a0 > 0 else 0
        g_hi = 1 if a1 < n else 0
        sl = [slice(None)] * 3
        sl[axis] = slice(a0 - g_lo, a1 + g_hi)
        shift = np.zeros(3, np.float32)
        shift[xyz] = (a0 - g_lo) * float(sp[xyz])
        glo, ghi = [0, 0, 0], [0, 0, 0]
        glo[xyz], ghi[xyz] = g_lo, g_hi
        scene.set_grid(0, i, data[tuple(sl)], vol["origin"] + shift, sp,
                       ghost_lo=tuple(glo), ghost_hi=tuple(ghi))
    return scene


def _mxu_spec(pkg, vol, cam):
    if pkg == "t":
        return tsl.make_spec(cam, vol["data"].shape,
                             tcfg.SliceMarchConfig(**F32_KW))
    return jsl.make_spec(cam, vol["data"].shape,
                         jcfg.SliceMarchConfig(**F32_KW))


def _image(vdi) -> np.ndarray:
    return render_vdi_same_view(VDI(torch.as_tensor(np_(vdi.color)),
                                    torch.as_tensor(np_(vdi.depth)))).numpy()


def _close(got, want, rtol=GATE, atol=GATE):
    assert_vdi_close(got.color, got.depth, want.color, want.depth, rtol,
                     atol)


# ------------------------------------------------------------- the scene


def test_bookkeeping(vol):
    scene = _scene("t", vol, 0, [7])
    assert scene.num_grids == 2
    scene.update_data(1, [vol["data"][:4]], [vol["origin"]],
                      vol["spacing"])
    assert scene.num_grids == 3
    scene.update_data(1, [], [], vol["spacing"])
    assert scene.num_grids == 2
    lo, hi = scene.global_bounds()
    want = _scene("j", vol, 0, [7]).global_bounds()
    np.testing.assert_allclose(lo.numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(hi.numpy(), np.asarray(want[1]), atol=1e-6)
    np.testing.assert_allclose(lo.numpy(), np.asarray(vol["j"].world_min),
                               atol=1e-6)
    np.testing.assert_allclose(hi.numpy(), np.asarray(vol["j"].world_max),
                               atol=1e-6)
    with pytest.raises(ValueError, match="update_data"):
        scene.update_grid(0, 0, vol["data"][:3])


def test_plain_render_matches_reference_and_single_volume(vol):
    eye = (0.3, 0.6, 2.8)
    cfgs = {p: (tcfg if p == "t" else jcfg).RenderConfig(
        width=48, height=40, max_steps=64) for p in "tj"}
    got = _scene("t", vol, 0, [7, 15]).render(       # uneven 7/8/9 split
        _tf("t"), _cam("t", eye), 48, 40, cfgs["t"])
    want = _scene("j", vol, 0, [7, 15]).render(
        _tf("j"), _cam("j", eye), 48, 40, cfgs["j"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GATE,
                               atol=GATE)
    ref = tray.raycast(vol["t"], _tf("t"), _cam("t", eye), 48, 40,
                       cfgs["t"])
    p = psnr(got.numpy(), ref.image.numpy())
    assert p > 35.0, f"multi-grid plain render diverges: {p:.1f} dB"


def test_vdi_gather_matches_reference_and_single_volume(vol):
    eye = (0.2, 0.5, 2.9)
    vc, cc = _cfgs("t")
    got, meta = _scene("t", vol, 0, [9]).generate_vdi(
        _tf("t"), _cam("t", eye), 40, 32, vc, cc, max_steps=64)
    want, jmeta = _scene("j", vol, 0, [9]).generate_vdi(
        _tf("j"), _cam("j", eye), 40, 32, *_cfgs("j"), max_steps=64)
    _close(got, want)
    np.testing.assert_allclose(meta.volume_dims.numpy(), [24, 24, 24],
                               atol=1e-4)
    np.testing.assert_allclose(meta.volume_dims.numpy(),
                               np.asarray(jmeta.volume_dims), atol=1e-6)
    one, _ = tgen.generate_vdi(vol["t"], _tf("t"), _cam("t", eye), 40, 32,
                               vc, max_steps=64)
    ref = tcomp.composite_vdis(one.color[None], one.depth[None], cc)
    p = psnr(_image(got), _image(ref))
    assert p > 30.0, f"multi-grid VDI diverges: {p:.1f} dB"


@pytest.mark.parametrize("axis,cuts,eye", [
    (0, [5, 14], (0.1, 0.4, 2.8)),      # uneven 5/9/10 z-slabs
    (2, [10], (0.0, 0.3, 2.8)),         # an in-plane (x) split, u-bounds
], ids=["z_split", "x_split"])
def test_vdi_mxu_matches_reference_and_single_volume(vol, axis, cuts, eye):
    """The flagship check: an uneven multi-grid slice march equals the
    reference's and the single volume at the reference's 30 dB bar; the
    x split of a z-marching camera exercises the u ownership and the
    in-plane ghost columns."""
    tcm, jcm = _cam("t", eye), _cam("j", eye)
    spec = _mxu_spec("t", vol, tcm)
    assert spec.axis == 2
    vc, cc = _cfgs("t")
    got, meta = _scene("t", vol, axis, cuts).generate_vdi_mxu(
        _tf("t"), tcm, spec, vc, cc)
    want, jmeta = _scene("j", vol, axis, cuts).generate_vdi_mxu(
        _tf("j"), jcm, _mxu_spec("j", vol, jcm), *_cfgs("j"))
    _close(got, want)
    np.testing.assert_allclose(meta.volume_dims.numpy(),
                               np.asarray(jmeta.volume_dims), atol=1e-6)
    one, _, _ = tsl.generate_vdi_mxu(vol["t"], _tf("t"), tcm, spec, vc)
    ref = tcomp.composite_vdis(one.color[None], one.depth[None], cc)
    p = psnr(_image(got), _image(ref))
    assert p > 30.0, f"multi-grid MXU VDI diverges: {p:.1f} dB"


def test_u_bounds_march_matches_reference(vol):
    """One grid of the x split marched alone with its ownership on both
    in-plane axes, as `_march_grids` hands it: the port's
    `generate_vdi_mxu(..., u_bounds=...)` equals the reference's within
    1e-5, and the bounds matter (the march without them differs)."""
    eye = (0.0, 0.3, 2.8)
    tcm, jcm = _cam("t", eye), _cam("j", eye)
    spec = _mxu_spec("t", vol, tcm)
    jspec = _mxu_spec("j", vol, jcm)
    ts, js = _scene("t", vol, 2, [10]), _scene("j", vol, 2, [10])
    lo, hi = ts.global_bounds()
    jlo, jhi = js.global_bounds()
    vc, jvc = _cfgs("t")[0], _cfgs("j")[0]
    tvol_, tub, tvb = ts._march_grids(spec, lo, hi)[0]
    jvol_, jub, jvb = js._march_grids(jspec, jlo, jhi)[0]
    np.testing.assert_allclose([float(x) for x in tub],
                               [float(x) for x in jub], atol=1e-7)
    got, _, _ = tsl.generate_vdi_mxu(tvol_, _tf("t"), tcm, spec, vc,
                                     box_min=lo, box_max=hi, u_bounds=tub,
                                     v_bounds=tvb)
    want, _, _ = jsl.generate_vdi_mxu(jvol_, _tf("j"), jcm, jspec, jvc,
                                      box_min=jlo, box_max=jhi,
                                      u_bounds=jub, v_bounds=jvb)
    _close(got, want)
    free, _, _ = tsl.generate_vdi_mxu(tvol_, _tf("t"), tcm, spec, vc,
                                      box_min=lo, box_max=hi, v_bounds=tvb)
    assert not np.array_equal(free.color.numpy(), got.color.numpy())
    # the other feeds of the march take the bounds alike: the plain
    # render's planes and the raw value planes of the fused folds
    axcam = tsl.make_axis_camera(tvol_, tcm, spec, lo, hi)
    jaxcam = jsl.make_axis_camera(jvol_, jcm, jspec, jlo, jhi)
    plain = tsl.render_slices(tvol_, _tf("t"), axcam, spec, u_bounds=tub,
                              v_bounds=tvb)
    jplain = jsl.render_slices(jvol_, _tf("j"), jaxcam, jspec, u_bounds=jub,
                               v_bounds=jvb)
    np.testing.assert_allclose(plain.image.numpy(), np.asarray(jplain.image),
                               rtol=GATE, atol=GATE)
    vals, sks = [], []

    def keep(carry, val, sk):
        vals.append(val)
        sks.append(sk)
        return carry

    tsl.slice_march(tvol_, _tf("t"), axcam, spec, keep, None,
                    u_bounds=tub, v_bounds=tvb, raw=True)
    sk = torch.cat(sks)
    pos_u = axcam.eye_u + (axcam.u_grid[None] - axcam.eye_u) * sk[:, None]
    outside = (pos_u < tub[0]) | (pos_u >= tub[1])          # [S, Ni]
    assert bool(outside.any()) and bool(outside.logical_not().any())
    dead = torch.cat(vals) == -1.0                          # [S, Nj, Ni]
    assert bool(dead.permute(0, 2, 1)[outside].all())


# ------------------------------------------------------------ the session


def _session(pkg, over, **kw):
    if pkg == "t":
        return tss.SceneSession(tcfg.FrameworkConfig().with_overrides(*over),
                                device=CPU, **kw)
    return jss.SceneSession(jcfg.FrameworkConfig().with_overrides(*over),
                            **kw)


def _z_halves(vol):
    data, org, sp = vol["data"], vol["origin"], vol["spacing"]
    d = data.shape[0]
    grids, origins, glo, ghi = [], [], [], []
    for z0, z1 in [(0, 11), (11, 24)]:          # uneven
        g0 = 1 if z0 > 0 else 0
        g1 = 1 if z1 < d else 0
        grids.append(data[z0 - g0:z1 + g1])
        origins.append(org + np.array([0, 0, (z0 - g0) * float(sp[2])],
                                      np.float32))
        glo.append((0, 0, g0))
        ghi.append((0, 0, g1))
    return grids, origins, glo, ghi


EXTERNAL_OVER = ("render.width=32", "render.height=24",
                 "render.max_steps=24", "vdi.adaptive_iters=1") \
    + SESSION_OVER


def _drive_external(pkg, vol, sinks=()):
    """The external-driver loop: grids pushed, a frame, a new timestep
    for grid 0, a frame."""
    sess = _session(pkg, EXTERNAL_OVER, sinks=list(sinks))
    grids, origins, glo, ghi = _z_halves(vol)
    sess.update_data(0, grids, origins, vol["spacing"], glo, ghi)
    p1 = sess.render_frame()
    sess.update_grid(0, 0, grids[0] * 0.5)
    return sess, p1, sess.render_frame()


def _drive_temporal(pkg, vol):
    """The temporal session: two frames, then the scene moved (same
    shapes, new extent) and a third."""
    sess = _session(pkg, TEMPORAL_OVER)
    sess.update_data(0, [vol["data"]], [vol["origin"]], vol["spacing"])
    frames = [sess.render_frame(), sess.render_frame()]
    counts = (len(sess._steps), len(sess._thr))
    sess.update_data(0, [vol["data"]], [vol["origin"] + 1.5],
                     vol["spacing"])
    frames.append(sess.render_frame())
    return sess, frames, counts


def _drive_reentry(pkg, vol):
    sess = _session(pkg, TEMPORAL_OVER)
    sess.update_data(0, [vol["data"]], [vol["origin"]], vol["spacing"])
    cams = {e: (tcam.Camera.create(e, fov_y_deg=50.0, near=0.3, far=20.0,
                                   device=CPU) if pkg == "t" else
                jcam.Camera.create(e, fov_y_deg=50.0, near=0.3, far=20.0))
            for e in (EYE_Z, EYE_X)}
    sess.camera = cams[EYE_Z]
    frames = [sess.render_frame()]
    (key_z,) = list(sess._thr)
    stale = sess._thr[key_z]
    sess.camera = cams[EYE_X]                  # leave the +z regime
    frames.append(sess.render_frame())
    sess.update_grid(0, 0, vol["data"] * 0.25)   # grids evolve meanwhile
    sess.camera = cams[EYE_Z]                  # return: must re-seed
    frames.append(sess.render_frame())
    return sess, frames, key_z, stale


@pytest.fixture(scope="module")
def jax_sessions(vol):
    """The reference sessions' runs the session cases hold the port to."""
    return dict(external=_drive_external("j", vol)[1:],
                temporal=_drive_temporal("j", vol)[1:],
                reentry=_drive_reentry("j", vol)[1])


def _payloads_close(got, want):
    assert got["frame"] == want["frame"]
    assert_vdi_close(got["vdi_color"], got["vdi_depth"], want["vdi_color"],
                     want["vdi_depth"], JIT_RTOL, JIT_ATOL)
    for f in ("view", "projection", "volume_dims", "nw"):
        np.testing.assert_allclose(np_(getattr(got["meta"], f)),
                                   np.asarray(getattr(want["meta"], f)),
                                   atol=1e-5, err_msg=f)
    assert int(got["meta"].index) == got["frame"]


def test_scene_session_external_driver(vol, jax_sessions, tmp_path):
    """The external-driver loop: push grids through the updateData
    boundary, render, update a grid, render again (≅ OpenFPM driving the
    JNI callbacks between frames), the frames equal to the reference's
    session's."""
    from scenery_insitu_tpu_torch.runtime.session import png_sink

    empty = _session("t", EXTERNAL_OVER)
    with pytest.raises(RuntimeError, match="no grids"):
        empty.render_frame()
    _, p1, p2 = _drive_external("t", vol, [png_sink(str(tmp_path))])
    assert p1["vdi_color"].shape[0] == 6
    assert np.isfinite(p1["vdi_color"]).all()
    assert not np.array_equal(p1["vdi_color"], p2["vdi_color"])
    assert len(glob.glob(str(tmp_path / "frame*.png"))) == 2
    for got, want in zip((p1, p2), jax_sessions["external"]):
        _payloads_close(got, want)


def test_scene_session_temporal_mode(vol, jax_sessions):
    """Temporal thresholds are seeded on the first frame, carried across
    frames ([G, nj, ni] maps), and re-seeded when the grid-set signature
    changes (the moved scene builds a second step); the frames equal the
    reference session's."""
    sess, frames, counts = _drive_temporal("t", vol)
    assert sess._temporal
    assert counts == (1, 1)
    assert len(sess._steps) == 2 and len(sess._thr) == 2
    thr1 = next(iter(sess._thr.values()))
    assert isinstance(thr1, tsup.ThresholdState)
    assert thr1.thr.shape[0] == 1      # one grid
    want, jcounts = jax_sessions["temporal"]
    assert jcounts == counts
    for got, w in zip(frames, want):
        assert np.isfinite(got["vdi_color"]).all()
        _payloads_close(got, w)


def test_insitu_session_rejects_temporal():
    """The port's "auto" engine is the slice march, where temporal runs;
    the gather engine rejects it as the reference's does off its TPU."""
    cfg = tcfg.FrameworkConfig().with_overrides(
        "vdi.adaptive_mode=temporal", "slicer.engine=gather",
        "sim.grid=[8,8,8]")
    with pytest.raises(ValueError, match="temporal"):
        tses.InSituSession(cfg, device=CPU)


def test_scene_session_extent_cache_survives_update_grid(vol):
    """update_grid replaces data only, so the extent cache is kept (the
    canonical driver loop would otherwise read the extent back every
    frame); update_data can change the layout and drops it."""
    sess = _session("t", SESSION_OVER)
    sess.update_data(0, [vol["data"]], [vol["origin"]], vol["spacing"])
    sess.render_frame()
    assert sess._extent_cache is not None
    cached = sess._extent_cache
    sess.update_grid(0, 0, vol["data"] * 0.5)
    assert sess._extent_cache is cached
    sess.render_frame()
    assert len(sess._steps) == 1
    sess.update_data(0, [vol["data"]], [vol["origin"] + 1.0],
                     vol["spacing"])
    assert sess._extent_cache is None


def test_scene_session_temporal_reseeds_on_regime_reentry(vol, jax_sessions):
    """A camera returning to a regime it left re-seeds that regime's
    thresholds instead of reusing the map frozen when it left; the three
    frames equal the reference session's."""
    sess, frames, key_z, stale = _drive_reentry("t", vol)
    assert sess._thr[key_z] is not stale
    for got, want in zip(frames, jax_sessions["reentry"]):
        _payloads_close(got, want)


def test_scene_session_prewarm_regimes(vol):
    """prewarm_regimes builds the steps of the given regimes for the
    current scene, leaves the camera, thresholds and frame index as they
    were, and the first real frame reuses the prewarmed step."""
    sess = _session("t", TEMPORAL_OVER)
    sess.update_data(0, [vol["data"]], [vol["origin"]], vol["spacing"])
    start = sess._slicer.choose_axis(sess.camera)
    eye0 = sess.camera.eye.clone()
    times = sess.prewarm_regimes(regimes=[start, (0, 1)])
    assert set(times) == {start, (0, 1)}
    assert len(sess._steps) == 2
    assert sess._thr == {}
    assert sess.frame_index == 0
    assert torch.equal(eye0, sess.camera.eye)
    p = sess.render_frame()
    assert np.isfinite(p["vdi_color"]).all()
    assert len(sess._steps) == 2
    plain = _session("t", SESSION_OVER + ("runtime.generate_vdis=false",))
    plain.update_data(0, [vol["data"]], [vol["origin"]], vol["spacing"])
    assert plain.prewarm_regimes() == {}


def test_scene_session_tf_steering_and_eviction(vol):
    """A ``tf`` message swaps the session's TF and drops its steps (the
    next frame builds with the new TF); the step cache keeps at most
    ``_MAX_CACHED_STEPS`` keys, dropping the oldest with its thresholds."""
    from scenery_insitu_tpu_torch.runtime.session import steer_session
    from scenery_insitu_tpu_torch.runtime.streaming import make_tf_message

    sess = _session("t", TEMPORAL_OVER)
    sess.update_data(0, [vol["data"]], [vol["origin"]], vol["spacing"])
    before = sess.render_frame()
    tf0 = sess.tf
    steer_session(sess, make_tf_message([(0.0, 0.0), (1.0, 0.9)], "jet"))
    assert sess.tf is not tf0 and not sess._steps and not sess._thr
    after = sess.render_frame()
    assert not np.array_equal(before["vdi_color"], after["vdi_color"])
    steer_session(sess, {"type": "tf", "points": "garbage"})
    assert len(sess._steps) == 1                    # ignored, logged
    for i in range(sess._MAX_CACHED_STEPS + 1):
        sess.update_data(0, [vol["data"]], [vol["origin"] + 0.5 * (i + 1)],
                         vol["spacing"])
        sess.render_frame()
    assert len(sess._steps) == sess._MAX_CACHED_STEPS
    assert set(sess._thr) <= set(sess._steps)
    assert set(sess._thr_init) == set(sess._steps)
