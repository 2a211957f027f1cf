"""Parity of the port's pre-shaded volumes with the JAX package, on the
CPU: the pre-shaded march layout, its occupancy pyramid, the AO
pre-shader ``shade_volume_ao``, the slice march of a pre-shaded volume
(``raycast_mxu`` and ``generate_vdi_mxu`` with ``tf=None``), the raw
march's refusal, and the slice-march AO of ``distributed_plain_step_mxu``
over 4 ranks (frame, ring waves, a plan; an x march) and in the session's
plain mode.

Both packages get the same numpy-seeded volumes (``tests/test_ao.py``'s
32^3 scene). Images and VDI colours agree within 1e-5 absolute, finite
depths within 1e-5 relative with the same +inf pattern, the shaded
volume within 1e-6. The reference tests' own bars hold on the port: the
pre-shaded slice march >= 24 dB from the gather AO render, the 4-rank AO
step within rtol 1e-4, atol 2e-5 of the single-device pre-shaded render.
Each reference run is shared through a module-scoped fixture."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.core import volume as jvol
from scenery_insitu_tpu.ops import ao as jao
from scenery_insitu_tpu.ops import occupancy as jocc
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.parallel import mesh as jmesh
from scenery_insitu_tpu.parallel import pipeline as jpipe
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.ops import ao as tao
from scenery_insitu_tpu_torch.ops import occupancy as tocc
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.ops.raycast import raycast as traycast
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from scenery_insitu_tpu_torch.utils.image import psnr
from tests.test_torch_pipeline import (  # noqa: F401
    assert_vdi_close, np_, one_torch_thread)
from tests.test_torch_session import _capture, port_session

CPU = "cpu"
ATOL = 1e-5
N = 4
W, H = 64, 48
RADIUS, STRENGTH = 3, 0.8
EYE = (0.4, 0.7, 2.6)                       # tests/test_ao.py's scene
EYE_X = (2.6, 0.4, 0.5)                     # an x march of it
EYE_Y = (0.3, -2.7, 0.4)                    # a y march


def _cam(eye, port=True):
    if port:
        return tcam.Camera.create(eye, fov_y_deg=50.0, near=0.3, far=20.0,
                                  device=CPU)
    return jcam.Camera.create(eye, fov_y_deg=50.0, near=0.3, far=20.0)


def _spec(eye, shape, port=True, **over):
    sc = dict(matmul_dtype="f32", **over)
    if port:
        return tsl.make_spec(_cam(eye), shape, tcfg.SliceMarchConfig(**sc))
    return jsl.make_spec(_cam(eye, False), shape, jcfg.SliceMarchConfig(**sc))


@pytest.fixture(scope="module")
def scene():
    """tests/test_ao.py's scene in both packages, and both packages'
    shaded volumes (the reference's jitted)."""
    vol = tvol.procedural_volume(32, kind="blobs", seed=5, device=CPU)
    jv = jvol.procedural_volume(32, kind="blobs", seed=5)
    tf = ttf.for_dataset("procedural", device=CPU)
    jt = jtf.for_dataset("procedural")
    jshaded = jax.jit(lambda v: jao.shade_volume_ao(v, jt, RADIUS,
                                                    STRENGTH))(jv)
    return dict(vol=vol, jvol=jv, tf=tf, jtf=jt,
                shaded=tao.shade_volume_ao(vol, tf, RADIUS, STRENGTH),
                jshaded=jshaded)


def test_shade_volume_ao_matches_reference(scene):
    s = scene
    got, want = s["shaded"], s["jshaded"]
    assert tuple(got.data.shape) == (4, 32, 32, 32)
    np.testing.assert_allclose(np_(got.data), np.asarray(want.data),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np_(got.origin), np.asarray(want.origin))
    np.testing.assert_array_equal(np_(got.spacing),
                                  np.asarray(want.spacing))


@pytest.mark.parametrize("eye,render_dtype", [(EYE, "f32"), (EYE_X, "f32"),
                                              (EYE_Y, "bf16")])
def test_permute_volume_pre_shaded(eye, render_dtype):
    """The channel dim moves behind the slice dim, in every regime; the
    bf16 march copy casts it."""
    data = np.random.default_rng(2).random((4, 6, 7, 9), dtype=np.float32)
    vol = tvol.Volume.create(data, device=CPU)
    jv = jvol.Volume.create(jnp.asarray(data))
    spec = _spec(eye, data.shape[1:], render_dtype=render_dtype)
    jspec = _spec(eye, data.shape[1:], port=False,
                  render_dtype=render_dtype)
    got = tsl.permute_volume(vol, spec)
    want = jsl.permute_volume(jv, jspec)
    assert got.dtype == (torch.bfloat16 if render_dtype == "bf16"
                         else torch.float32)
    np.testing.assert_array_equal(np_(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("vtiles", [0, 4])
def test_pyramid_pre_shaded_matches_reference(vtiles, scene):
    """The pyramid of a pre-shaded volume ranges its stored alpha and
    gates on it, without a TF; sim field ranges refuse it in both."""
    s = scene
    spec = _spec(EYE, (32, 32, 32), occupancy_vtiles=vtiles)
    jspec = _spec(EYE, (32, 32, 32), port=False, occupancy_vtiles=vtiles)
    got = tocc.pyramid_from_volume(s["shaded"], None, spec)
    want = jocc.pyramid_from_volume(s["jshaded"], None, jspec)
    for name in ("chunks", "tiles"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    for name in ("lo", "hi"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6)
    ranges = tocc.FieldRanges(torch.zeros(4, 4), torch.ones(4, 4))
    with pytest.raises(ValueError, match="pre-shaded"):
        tocc.pyramid_from_ranges(ranges, s["shaded"], None, spec)
    with pytest.raises(ValueError, match="pre-shaded"):
        jocc.pyramid_from_ranges(
            jocc.FieldRanges(jnp.zeros((4, 4)), jnp.ones((4, 4))),
            s["jshaded"], None, jspec)


@pytest.mark.parametrize("eye", [EYE, EYE_X])
def test_raycast_mxu_pre_shaded_matches_reference(eye, scene):
    s = scene
    spec = _spec(eye, (32, 32, 32))
    jspec = _spec(eye, (32, 32, 32), port=False)
    got = tsl.raycast_mxu(s["shaded"], None, _cam(eye), W, H, spec,
                          background=(1, 1, 1, 1))
    # eager: XLA's fused power in a jitted march moves the reference's
    # image up to 2.4e-5 from its own eager run
    want = jsl.raycast_mxu(s["jshaded"], None, _cam(eye, False), W, H, jspec,
                           background=(1, 1, 1, 1))
    np.testing.assert_allclose(np_(got.image), np.asarray(want.image),
                               rtol=0, atol=ATOL)
    wd = np.asarray(want.depth)
    live = np.isfinite(wd)
    assert (np.isfinite(np_(got.depth)) == live).all()
    np.testing.assert_allclose(np_(got.depth)[live], wd[live], rtol=1e-5)


def test_ao_mxu_pre_shaded_matches_gather(scene):
    """The reference test's bar on the port: the slice march of the
    pre-shaded volume against the gather AO render, >= 24 dB."""
    s = scene
    cam = _cam(EYE)
    g = traycast(s["vol"], s["tf"], cam, W, H,
                 tcfg.RenderConfig(max_steps=64, background=(1, 1, 1, 1)),
                 ao_field=tao.ao_field_volume(s["vol"], s["tf"], RADIUS,
                                              STRENGTH))
    m = tsl.raycast_mxu(s["shaded"], None, cam, W, H, _spec(EYE, (32,) * 3),
                        background=(1, 1, 1, 1))
    q = psnr(np_(g.image), np_(m.image))
    assert q > 24.0, f"PSNR {q:.1f} dB"


@pytest.mark.parametrize("fold", ["xla", "pallas_seg"])
def test_generate_vdi_mxu_pre_shaded_matches_reference(fold, scene):
    """A VDI of the pre-shaded volume (K1's plain version under
    ``pallas_seg``) against the reference's ``xla`` fold; the fused folds
    feed a TF kernel and refuse it."""
    s = scene
    vcfg = dict(max_supersegments=8, adaptive_mode="histogram",
                histogram_bins=16)
    spec = _spec(EYE, (32,) * 3, fold=fold)
    jspec = _spec(EYE, (32,) * 3, port=False, fold="xla")
    vdi, meta, _ = tsl.generate_vdi_mxu(s["shaded"], None, _cam(EYE), spec,
                                        tcfg.VDIConfig(**vcfg))
    jvdi, jmeta = _reference_vdi(s, jspec, vcfg)
    assert_vdi_close(vdi.color, vdi.depth, jvdi.color, jvdi.depth,
                     rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(np_(meta.nw), np.asarray(jmeta.nw))
    for raw in ("pallas_fused", "fused_stream"):
        with pytest.raises(ValueError, match="pre-shaded"):
            tsl.generate_vdi_mxu(s["shaded"], None, _cam(EYE),
                                 _spec(EYE, (32,) * 3, fold=raw),
                                 tcfg.VDIConfig(**vcfg))


_REF_VDI = {}


def _reference_vdi(s, jspec, vcfg):
    if "vdi" not in _REF_VDI:
        _REF_VDI["vdi"] = jsl.generate_vdi_mxu(
            s["jshaded"], None, _cam(EYE, False), jspec,
            jcfg.VDIConfig(**vcfg))[:2]
    return _REF_VDI["vdi"]


def test_raw_slice_march_pre_shaded_raises(scene):
    s = scene
    spec = _spec(EYE, (32,) * 3)
    axcam = tsl.make_axis_camera(s["shaded"], _cam(EYE), spec)
    with pytest.raises(ValueError, match="pre-shaded"):
        tsl.slice_march(s["shaded"], None, axcam, spec,
                        lambda c, *a: c, None, raw=True)


# ------------------------------------------------ the distributed AO step

DIST = {
    "frame": dict(eye=EYE, knobs={}),
    "ring_waves": dict(eye=EYE, knobs=dict(exchange="ring",
                                           schedule="waves", wave_tiles=2)),
    "plan": dict(eye=EYE, knobs=dict(rebalance="occupancy"),
                 plan=(4, 12, 8, 8)),
    "x_march": dict(eye=EYE_X, knobs={}),
}


def _dist_spec(eye, port=True):
    sc = dict(matmul_dtype="f32", scale=1.0)
    if port:
        return tsl.make_spec(_cam(eye), (32,) * 3,
                             tcfg.SliceMarchConfig(**sc), multiple_of=N)
    return jsl.make_spec(_cam(eye, False), (32,) * 3,
                         jcfg.SliceMarchConfig(**sc), multiple_of=N)


@pytest.fixture(scope="module")
def x_march_reference(scene):
    """The reference's 4-rank AO step on the x march: its own x/y march
    is not seam-exact against the single-device pre-shaded render (the
    ranks' in-plane ownership cuts the shaded slab's bilinear support),
    so the port is held to the step itself there."""
    s = scene
    rc = jcfg.RenderConfig(ao_strength=0.9, ao_radius=RADIUS)
    m = jmesh.make_mesh(N)
    img, _ = jpipe.distributed_plain_step_mxu(
        m, s["jtf"], _dist_spec(EYE_X, port=False), rc)(
            jpipe.shard_volume(s["jvol"].data, m), s["jvol"].origin,
            s["jvol"].spacing, _cam(EYE_X, False))
    return np.asarray(img)


@pytest.mark.parametrize("name", list(DIST))
def test_distributed_ao_seam_exact_mxu(name, scene, request):
    """Every rank pre-shades its slab (or planned band) on a radius-deep
    halo: the 4-rank AO step equals the single-device pre-shaded render
    at the reference test's bar (rtol 1e-4, atol 2e-5)."""
    s, case = scene, DIST[name]
    spec = _dist_spec(case["eye"])
    mesh = tmesh.make_mesh(N, device=CPU)
    rc = tcfg.RenderConfig(ao_strength=0.9, ao_radius=RADIUS)
    img, axcam = tpipe.distributed_plain_step_mxu(
        mesh, s["tf"], spec, rc, tcfg.CompositeConfig(**case["knobs"]),
        plan=case.get("plan"))(tmesh.shard_volume(s["vol"].data, mesh),
                               s["vol"].origin, s["vol"].spacing,
                               _cam(case["eye"]))
    if name == "x_march":
        want = request.getfixturevalue("x_march_reference")
        np.testing.assert_allclose(np_(img), want, rtol=0, atol=ATOL)
        return
    shaded = tao.shade_volume_ao(s["vol"], s["tf"], RADIUS, 0.9)
    ref = tsl.render_slices(shaded, None, tsl.make_axis_camera(
        shaded, _cam(case["eye"]), spec), spec)
    np.testing.assert_allclose(np_(img), np_(ref.image), rtol=1e-4,
                               atol=2e-5)


def test_ao_plan_needs_the_halo_depth(scene):
    """A planned band must hold the AO halo: ``ao_radius + 1`` slices."""
    s = scene
    mesh = tmesh.make_mesh(N, device=CPU)
    with pytest.raises(ValueError):
        tpipe.distributed_plain_step_mxu(
            mesh, s["tf"], _dist_spec(EYE),
            tcfg.RenderConfig(ao_strength=0.9, ao_radius=RADIUS),
            tcfg.CompositeConfig(rebalance="occupancy"),
            plan=(2, 14, 8, 8))


def test_session_plain_mxu_with_ao():
    """The session's plain slice-march mode with AO: its frame is the
    hand-driven AO step's, warped, and not the frame without AO."""
    over = {"runtime.generate_vdis": "false", "render.width": "32",
            "render.height": "24", "render.ao_strength": "0.9",
            "render.ao_radius": "1"}
    frames = {}
    sess = port_session(N, "histogram", sinks=[_capture(frames)], **over)
    sess.orbit_rate = 0.0
    sess.run(1)
    cfg, cam = sess.cfg, sess.camera
    field = sess.sim.field
    spec = tsl.make_spec(cam, tuple(field.shape), cfg.slicer,
                         axis_sign=tsl.choose_axis(cam), multiple_of=N)
    img, axcam = tpipe.distributed_plain_step_mxu(
        sess.mesh, sess.tf, spec, cfg.render, cfg.composite)(
            tmesh.shard_volume(field, sess.mesh), sess._origin,
            sess._spacing, cam)
    want = tsl.warp_to_camera(img, axcam, spec, cam, 32, 24,
                              cfg.render.background)
    np.testing.assert_array_equal(frames[0]["image"], np_(want))
    plain = tpipe.distributed_plain_step_mxu(
        sess.mesh, sess.tf, spec,
        dataclasses.replace(cfg.render, ao_strength=0.0), cfg.composite)(tmesh.shard_volume(field, sess.mesh), sess._origin,
                       sess._spacing, cam)[0]
    assert np.abs(np_(img) - np_(plain)).max() > 1e-2
