"""Parity of the port's VDI renderers and converters with the JAX package,
on the CPU: ``core/transfer.colormap_lut``, ``core/volume.load_raw`` and
``load_dataset``, ``ops/vdi_render`` (the gather novel-view renderer),
``ops/vdi_novel`` (the camera rebuilt from the metadata, the plane sweep,
the pre-shaded proxy and its cross-regime march, the exact renderer, the
batch) and ``ops/vdi_convert`` (NDC depths, interchange layouts,
validation, the Vulkan frame), with the three golden images
``golden_novel_view.png``, ``golden_vdi_decode.png`` and
``golden_reference_frame.png`` through the port.

Both packages get the same inputs: the scenes of ``tests/test_vdi_novel.py``
(32^3 blobs, its VDI made by the reference and carried over),
``tests/test_vdi_convert.py`` (its VDIs made by the port and carried
over) and the golden configs. Tolerances: 1e-5 absolute on images and
VDI colour, 1e-5 relative on finite depths with the same +inf pattern,
except where a case states its bound. One such statement covers the
plane sweep and the proxy: their planes are the slice planes of the
march that made the VDI, so a slab's start or end lies on a plane, and a
one-ulp difference in the plane's depth between XLA's fused arithmetic
and torch's moves a sample across the slab edge. Those cases hold 1e-5 on
the same VDI with every depth scaled by 1.0007 (edges 3 % of a slice off
the planes) and a PSNR floor on the VDI itself. Each reference run is
shared through a module-scoped fixture."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.core import vdi as jvdi
from scenery_insitu_tpu.core import volume as jvol
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.ops import vdi_convert as jvc
from scenery_insitu_tpu.ops import vdi_novel as jnv
from scenery_insitu_tpu.ops import vdi_render as jvr
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.core.vdi import VDI, render_vdi_same_view
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.ops import vdi_convert as tvc
from scenery_insitu_tpu_torch.ops import vdi_novel as tnv
from scenery_insitu_tpu_torch.ops import vdi_render as tvr
from scenery_insitu_tpu_torch.ops.composite import composite_vdis
from scenery_insitu_tpu_torch.ops.vdi_gen import generate_vdi
from scenery_insitu_tpu_torch.utils.image import psnr, to_display
from tests.golden import make_golden as mg
from tests.test_torch_pipeline import np_, one_torch_thread  # noqa: F401

CPU = "cpu"
ATOL = 1e-5
SHIFT = 1.0007
EYE0 = (0.1, 0.3, 2.8)                  # tests/test_vdi_novel.py's camera
EYE_NOVEL = (0.45, 0.55, 2.6)
EYE_X = (3.0, 0.4, 0.5)
CROSS = [(2.6, 0.2, 0.3), (0.2, -2.7, 0.3)]


def _cams(eye, fov=45.0, near=0.3, far=10.0):
    return (tcam.Camera.create(eye, fov_y_deg=fov, near=near, far=far,
                               device=CPU),
            jcam.Camera.create(eye, fov_y_deg=fov, near=near, far=far))


def _golden_gap(img, name, gamma=2.2):
    """Max 8-bit difference of a render against its committed PNG."""
    want = np.asarray(Image.open(os.path.join(
        mg.GOLDEN_DIR, f"golden_{name}.png")), np.float32)
    got = to_display(np_(img), gamma).astype(np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max())


def _assert_tight_and_floor(got, want, want_off, got_off, floor_db):
    """The knife-edge statement of the module docstring: 1e-5 on the
    shifted VDI's render, a PSNR floor on the VDI's own."""
    np.testing.assert_allclose(np_(got_off), np.asarray(want_off), rtol=0,
                               atol=ATOL)
    q = psnr(np.asarray(want), np_(got))
    assert q >= floor_db, f"{q:.1f} dB"


# --------------------------------------------------------------- core


@pytest.mark.parametrize("name,n", [("grays", 256), ("hot", 256),
                                    ("jet", 17), ("viridis", 256)])
def test_colormap_lut(name, n):
    got = ttf.colormap_lut(name, n)
    np.testing.assert_array_equal(got, jtf.colormap_lut(name, n))
    assert got.shape == (n, 3) and got.dtype == np.float32
    assert ttf.LUT_SIZE == jtf.LUT_SIZE


@pytest.mark.parametrize("is16bit", [False, True])
def test_load_raw_and_dataset(is16bit, tmp_path, monkeypatch):
    """A raw file the test writes (x fastest), loaded by both packages;
    ``load_dataset`` on a name whose table entry is shrunk to it."""
    dims = (7, 5, 3)
    dtype = np.uint16 if is16bit else np.uint8
    raw = np.random.default_rng(1).integers(
        0, np.iinfo(dtype).max, size=dims[::-1], dtype=dtype)
    path = tmp_path / "beechnut.raw"
    raw.tofile(path)
    got = tvol.load_raw(str(path), dims, is16bit=is16bit, extent=1.5,
                        device=CPU)
    want = jvol.load_raw(str(path), dims, is16bit=is16bit, extent=1.5)
    for name in ("data", "origin", "spacing"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    if is16bit:
        monkeypatch.setitem(tvol.DATASET_DIMS_XYZ, "beechnut", dims)
        monkeypatch.setitem(jvol.DATASET_DIMS_XYZ, "beechnut", dims)
        got = tvol.load_dataset("beechnut", str(tmp_path), device=CPU)
        want = jvol.load_dataset("beechnut", str(tmp_path))
        np.testing.assert_array_equal(np_(got.data), np.asarray(want.data))
    assert tvol.DATASET_DIMS_XYZ["rotstrat"] == \
        jvol.DATASET_DIMS_XYZ["rotstrat"]


# ------------------------------------------------- the goldens, vdi_render


@pytest.fixture(scope="module")
def golden():
    """The golden configs: the reference's composited VDI and metadata
    (``make_golden.build_vdi``), and the port's own of the same scene."""
    comp, meta, _ = mg.build_vdi(fold="xla")
    vol = tvol.procedural_volume(mg.GRID, kind="blobs", seed=mg.SEED,
                                 device=CPU)
    cam, _ = _cams(mg.EYE, 50.0, 0.3, 20.0)
    spec = tsl.make_spec(cam, tuple(vol.data.shape), tcfg.SliceMarchConfig(
        matmul_dtype="f32", fold="xla"))
    tf = ttf.for_dataset("procedural", device=CPU)
    vdi, tmeta, _ = tsl.generate_vdi_mxu(vol, tf, cam, spec, tcfg.VDIConfig(
        max_supersegments=mg.K, adaptive_mode="histogram", histogram_bins=8))
    tcomp = composite_vdis(vdi.color[None], vdi.depth[None],
                           tcfg.CompositeConfig(
                               max_output_supersegments=mg.K))
    return dict(jvdi=jvdi.VDI(comp.color, comp.depth), jmeta=meta,
                vdi=convert.vdi(comp, device=CPU),
                meta=convert.vdi_metadata(meta, device=CPU),
                port_vdi=VDI(tcomp[0], tcomp[1]), port_meta=tmeta,
                vol=vol, tf=tf, cam=cam, spec=spec)


def test_original_eye_and_frustum_aabb(golden):
    g = golden
    np.testing.assert_allclose(np_(tvr.original_eye(g["meta"])),
                               np.asarray(jvr.original_eye(g["jmeta"])),
                               rtol=0, atol=1e-6)
    lo, hi = tvr.frustum_aabb(g["meta"])
    jlo, jhi = jvr.frustum_aabb(g["jmeta"])
    np.testing.assert_allclose(np_(lo), np.asarray(jlo), rtol=1e-5)
    np.testing.assert_allclose(np_(hi), np.asarray(jhi), rtol=1e-5)


def test_render_vdi_matches_reference_and_goldens(golden):
    """The gather renderer on the reference's golden VDI against the
    reference's render; ``golden_novel_view.png`` from the port's own
    VDI and from the reference's, and ``golden_vdi_decode.png`` from the
    port's VDI, within ``tests/test_golden.py``'s 3.0."""
    g = golden
    cam2, jcam2 = _cams(mg.EYE_NOVEL, 50.0, 0.3, 20.0)
    bg = (1.0, 1.0, 1.0, 1.0)
    got = tvr.render_vdi(g["vdi"], g["meta"], cam2, mg.W, mg.H,
                         steps=mg.STEPS, background=bg)
    want = jvr.render_vdi(g["jvdi"], g["jmeta"], jcam2, mg.W, mg.H,
                          steps=mg.STEPS, background=bg)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert _golden_gap(got, "novel_view") <= 3.0
    own = tvr.render_vdi(g["port_vdi"], g["port_meta"], cam2, mg.W, mg.H,
                         steps=mg.STEPS, background=bg)
    assert _golden_gap(own, "novel_view") <= 3.0
    assert _golden_gap(render_vdi_same_view(g["port_vdi"], background=bg),
                       "vdi_decode") <= 3.0


def test_reference_frame_golden(golden):
    """``golden_reference_frame.png``: the port's slice-march render of
    the golden scene in the Vulkan frame (already gamma-encoded, so its
    PNG round trip takes gamma 1.0)."""
    g = golden
    img = tsl.raycast_mxu(g["vol"], g["tf"], g["cam"], mg.W, mg.H,
                          g["spec"], background=(1.0, 1.0, 1.0, 1.0)).image
    assert _golden_gap(tvc.to_reference_frame(img), "reference_frame",
                       gamma=1.0) <= 3.0


# ------------------------------------------------------- vdi_novel


@pytest.fixture(scope="module")
def novel():
    """tests/test_vdi_novel.py's fixture: the reference's VDI of the
    32^3 blobs, carried to the port, with its depth-scaled twin in both
    packages."""
    vol = jvol.procedural_volume(32, kind="blobs", seed=3)
    tf = jtf.for_dataset("procedural")
    _, jc0 = _cams(EYE0)
    spec = jsl.make_spec(jc0, vol.data.shape, jcfg.SliceMarchConfig(
        matmul_dtype="f32", scale=1.5))
    vdi, meta, axcam = jsl.generate_vdi_mxu(
        vol, tf, jc0, spec, jcfg.VDIConfig(max_supersegments=8,
                                           adaptive_iters=3))
    off = jvdi.VDI(vdi.color, vdi.depth * jnp.float32(SHIFT))
    return dict(jvdi=vdi, jmeta=meta, jaxcam=axcam, jspec=spec, joff=off,
                vdi=convert.vdi(vdi, device=CPU),
                off=convert.vdi(off, device=CPU),
                meta=convert.vdi_metadata(meta, device=CPU),
                axcam=convert.axis_camera(axcam, device=CPU),
                spec=convert.axis_spec(spec), ref={})


def _ref(n, key, fn):
    """A reference render computed once for the module."""
    if key not in n["ref"]:
        n["ref"][key] = np.asarray(fn())
    return n["ref"][key]


def test_axis_camera_and_spec_from_meta(novel):
    """The generating camera rebuilt from the metadata alone equals the
    reference's rebuild and the stored camera (the reference test's
    tolerances)."""
    n = novel
    rec = tnv.axis_camera_from_meta(n["meta"], n["spec"])
    jrec = jnv.axis_camera_from_meta(n["jmeta"], n["jspec"])
    for f in rec._fields:
        np.testing.assert_allclose(np_(getattr(rec, f)),
                                   np.asarray(getattr(jrec, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(np_(rec.u_grid), np_(n["axcam"].u_grid),
                               atol=1e-3)
    np.testing.assert_allclose(float(rec.dwm), float(n["axcam"].dwm),
                               atol=1e-5)
    spec = tnv.axis_spec_from_meta(n["meta"])
    jspec = jnv.axis_spec_from_meta(n["jmeta"])
    assert (spec.axis, spec.sign, spec.ni, spec.nj, spec.chunk) == (
        jspec.axis, jspec.sign, jspec.ni, jspec.nj, jspec.chunk)
    assert spec.matmul_dtype == "f32"


@pytest.mark.parametrize("eye", [EYE0, EYE_NOVEL])
def test_render_vdi_mxu_matches_reference(eye, novel):
    n = novel
    cam, jc = _cams(eye)
    args = (96, 80)
    got = tnv.render_vdi_mxu(n["vdi"], n["axcam"], n["spec"], cam, *args,
                             num_slices=40)
    got_off = tnv.render_vdi_mxu(n["off"], n["axcam"], n["spec"], cam,
                                 *args, num_slices=40)
    want = _ref(n, ("mxu", eye), lambda: jnv.render_vdi_mxu(
        n["jvdi"], n["jaxcam"], n["jspec"], jc, *args, num_slices=40))
    want_off = _ref(n, ("mxu_off", eye), lambda: jnv.render_vdi_mxu(
        n["joff"], n["jaxcam"], n["jspec"], jc, *args, num_slices=40))
    _assert_tight_and_floor(got, want, want_off, got_off, 75.0)


def test_render_vdi_mxu_quality_gates(novel):
    """The reference tests' bars on the port: >= 25 dB against the gather
    renderer (three views), >= 40 dB from the camera rebuilt from the
    metadata; a cross-regime view raises."""
    n = novel
    rec = tnv.axis_camera_from_meta(n["meta"], n["spec"])
    for eye in (EYE0, EYE_NOVEL, (0.7, 0.8, 2.4)):
        cam, _ = _cams(eye)
        a = tnv.render_vdi_mxu(n["vdi"], n["axcam"], n["spec"], cam, 96, 80,
                               num_slices=40)
        b = tvr.render_vdi(n["vdi"], n["meta"], cam, 96, 80, steps=200)
        assert np.isfinite(np_(a)).all()
        assert psnr(np_(a), np_(b)) > 25.0, eye
    cam, _ = _cams((0.4, 0.5, 2.65))
    a = tnv.render_vdi_mxu(n["vdi"], rec, n["spec"], cam, 96, 80,
                           num_slices=40)
    b = tnv.render_vdi_mxu(n["vdi"], n["axcam"], n["spec"], cam, 96, 80,
                           num_slices=40)
    assert psnr(np_(a), np_(b)) > 40.0
    cam_x, _ = _cams(EYE_X)
    with pytest.raises(ValueError, match="axis"):
        tnv.render_vdi_mxu(n["vdi"], n["axcam"], n["spec"], cam_x, 64, 48)


def test_vdi_to_rgba_volume_matches_reference(novel):
    """The proxy against the reference's (the knife-edge statement, 60 dB
    on the VDI's own); its same-view march >= 24 dB from the VDI's
    decode (the reference test's bar)."""
    n = novel
    got = tnv.vdi_to_rgba_volume(n["vdi"], n["axcam"], n["spec"],
                                 num_slices=32)
    off = tnv.vdi_to_rgba_volume(n["off"], n["axcam"], n["spec"],
                                 num_slices=32)
    want = jnv.vdi_to_rgba_volume(n["jvdi"], n["jaxcam"], n["jspec"],
                                  num_slices=32)
    want_off = jnv.vdi_to_rgba_volume(n["joff"], n["jaxcam"], n["jspec"],
                                      num_slices=32)
    assert tuple(got.data.shape) == (4, 32, 48, 48)
    _assert_tight_and_floor(got.data, want.data, want_off.data, off.data,
                            60.0)
    for f in ("origin", "spacing"):
        np.testing.assert_allclose(np_(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-6)
    cam0, _ = _cams(EYE0)
    spec_new = tsl.make_spec(cam0, tuple(got.data.shape[-3:]),
                             tcfg.SliceMarchConfig(matmul_dtype="f32"))
    out = tsl.raycast_mxu(got, None, cam0, 64, 48, spec_new)
    ref = tsl.warp_to_camera(render_vdi_same_view(n["vdi"]), n["axcam"],
                             n["spec"], cam0, 64, 48)
    assert psnr(np_(ref), np_(out.image)) > 24.0


@pytest.mark.parametrize("eye", CROSS)
def test_render_vdi_any_cross_regime(eye, novel):
    """A view marching another axis: the proxy's slice march. The depth-
    scaled VDI's view within 3e-5 of the reference's (the proxy's own
    ~3e-6 carried through a second march); the reference test's bar
    (>= 24 dB against the gather renderer) on the VDI's own."""
    n = novel
    cam, jc = _cams(eye)
    assert tsl.choose_axis(cam)[0] != n["spec"].axis
    got = tnv.render_vdi_any(n["vdi"], n["axcam"], n["spec"], cam, 80, 64,
                             num_slices=32)
    got_off = tnv.render_vdi_any(n["off"], n["axcam"], n["spec"], cam, 80,
                                 64, num_slices=32)
    want_off = jnv.render_vdi_any(n["joff"], n["jaxcam"], n["jspec"], jc,
                                  80, 64, num_slices=32)
    np.testing.assert_allclose(np_(got_off), np.asarray(want_off), rtol=0,
                               atol=3e-5)
    ref = tvr.render_vdi(n["vdi"], n["meta"], cam, 80, 64, steps=128)
    assert np.isfinite(np_(got)).all()
    assert psnr(np_(ref), np_(got)) > 24.0


def test_render_vdi_any_routes(novel):
    """The same regime takes the plane sweep bit for bit, ``exact=True``
    the exact renderer; a prebuilt proxy gives the view built inside."""
    n = novel
    cam, _ = _cams((0.3, 0.4, 2.7))
    a = tnv.render_vdi_any(n["vdi"], n["axcam"], n["spec"], cam, 64, 48,
                           num_slices=32)
    b = tnv.render_vdi_mxu(n["vdi"], n["axcam"], n["spec"], cam, 64, 48,
                           num_slices=32)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    cam_x, _ = _cams(EYE_X)
    a = tnv.render_vdi_any(n["vdi"], n["axcam"], n["spec"], cam_x, 48, 40,
                           exact=True)
    b = tnv.render_vdi_exact(n["vdi"], n["axcam"], n["spec"], cam_x, 48, 40)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    proxy = tnv.vdi_to_rgba_volume(n["vdi"], n["axcam"], n["spec"],
                                   num_slices=32)
    a = tnv.render_vdi_any(n["vdi"], n["axcam"], n["spec"], cam_x, 48, 40,
                           num_slices=32, proxy=proxy)
    b = tnv.render_vdi_any(n["vdi"], n["axcam"], n["spec"], cam_x, 48, 40,
                           num_slices=32)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("eye,atol", [(EYE_NOVEL, ATOL), (EYE_X, 1e-4)])
def test_render_vdi_exact_matches_reference(eye, atol, novel):
    """The closed-form renderer against the reference's. Across regimes
    the bound is 1e-4: the port's rays are within 5e-6 of JAX's
    (``core/camera.pixel_rays`` inverts ``proj @ view`` in f32), which
    moves the closed-form crossing times; the proxy stays >= 24 dB from
    it (the reference test's bar)."""
    n = novel
    cam, jc = _cams(eye)
    got = tnv.render_vdi_exact(n["vdi"], n["axcam"], n["spec"], cam, 80, 64)
    want = jnv.render_vdi_exact(n["jvdi"], n["jaxcam"], n["jspec"], jc, 80,
                                64)
    assert np.isfinite(np_(got)).all()
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0,
                               atol=atol)
    if eye == EYE_X:
        proxy = tnv.render_vdi_any(n["vdi"], n["axcam"], n["spec"], cam, 80,
                                   64, num_slices=32)
        assert psnr(np_(proxy), np_(got)) > 24.0


def test_render_vdi_exact_uniform_slab(novel):
    """One slab of alpha A over [len0, 1.2 len0] in every pixel: the
    generating camera's rays cross it whole, so the alpha is A."""
    n = novel
    spec, axcam = n["spec"], n["axcam"]
    nj, ni, k, a_ = spec.nj, spec.ni, 4, 0.625
    len0 = np_(axcam.ray_lengths())
    starts = np.full((k, nj, ni), np.inf, np.float32)
    ends = np.full((k, nj, ni), -np.inf, np.float32)
    starts[0], ends[0] = len0, len0 * 1.2
    color = np.zeros((k, 4, nj, ni), np.float32)
    color[0, 0], color[0, 3] = 0.8 * a_, a_
    synth = convert.vdi((color, np.stack([starts, ends], axis=1)),
                        device=CPU)
    cam, _ = _cams(EYE0)
    img = np_(tnv.render_vdi_exact(synth, axcam, spec, cam, 96, 80))
    np.testing.assert_allclose(img[3, 30:50, 38:58], a_, atol=0.02)
    np.testing.assert_allclose(img[0, 30:50, 38:58] / img[3, 30:50, 38:58],
                               0.8, atol=0.02)


@pytest.mark.parametrize("tier", ["exact", "sweep", "proxy"])
def test_render_vdi_batch(tier, novel):
    """Every element equals the independent single-camera render of its
    tier, bit for bit."""
    n = novel
    eyes = [(0.1, 0.3, 2.8), (0.3, 0.4, 2.7), (0.2, 0.5, 2.75)]
    cams = [_cams(e)[0] for e in eyes]
    batch = tnv.stack_cameras(cams)
    kw = dict(num_slices=32, axis_sign=tsl.choose_axis(cams[0]))
    out = tnv.render_vdi_batch(n["vdi"], n["axcam"], n["spec"], batch, 40,
                               32, tier=tier, **kw)
    assert tuple(out.shape) == (3, 4, 32, 40)
    proxy = tnv.vdi_to_rgba_volume(n["vdi"], n["axcam"], n["spec"],
                                   num_slices=32)
    spec_new = tsl.make_spec(cams[0], tuple(proxy.data.shape[-3:]),
                             tcfg.SliceMarchConfig(matmul_dtype="f32"),
                             axis_sign=kw["axis_sign"])
    for i, cam in enumerate(cams):
        if tier == "exact":
            one = tnv.render_vdi_exact(n["vdi"], n["axcam"], n["spec"], cam,
                                       40, 32)
        elif tier == "sweep":
            one = tnv.render_vdi_mxu(n["vdi"], n["axcam"], n["spec"], cam,
                                     40, 32, **kw)
        else:
            one = tnv.render_vdi_proxy(proxy, cam, 40, 32, spec_new)
        torch.testing.assert_close(out[i], one, rtol=0, atol=0)
    with pytest.raises(ValueError, match="axis_sign"):
        tnv.render_vdi_batch(n["vdi"], n["axcam"], n["spec"], batch, 40, 32,
                             tier="sweep")
    with pytest.raises(ValueError, match="tier"):
        tnv.render_vdi_batch(n["vdi"], n["axcam"], n["spec"], batch, 40, 32,
                             tier="fast")
    with pytest.raises(ValueError, match="at least one"):
        tnv.stack_cameras([])


# ------------------------------------------------------- vdi_convert


@pytest.fixture(scope="module")
def converted():
    """tests/test_vdi_convert.py's scene: the port's gather VDI (48 x 40,
    96 steps) and slice-march VDI of the 32^3 blobs, with both packages'
    copies."""
    vol = tvol.procedural_volume(32, kind="blobs", seed=5, device=CPU)
    tf = ttf.for_dataset("procedural", device=CPU)
    cam, _ = _cams((0.2, 0.5, 2.6), near=0.4)
    vcfg = tcfg.VDIConfig(max_supersegments=8, adaptive_iters=3)
    out = {"cam": cam}
    gvdi, gmeta = generate_vdi(vol, tf, cam, 48, 40, vcfg, max_steps=96)
    spec = tsl.make_spec(cam, tuple(vol.data.shape),
                         tcfg.SliceMarchConfig(matmul_dtype="f32"))
    svdi, smeta, _ = tsl.generate_vdi_mxu(vol, tf, cam, spec, vcfg)
    for name, (v, m) in {"gathered": (gvdi, gmeta),
                         "sliced": (svdi, smeta)}.items():
        hv, hm = convert.to_numpy(v), convert.to_numpy(m)
        out[name] = (v, m, jvdi.VDI(jnp.asarray(hv.color),
                                    jnp.asarray(hv.depth)),
                     jvdi.VDIMetadata(*(jnp.asarray(x) for x in hm)))
    return out


def _assert_depths(got, want):
    got, want = np_(got), np.asarray(want)
    live = np.isfinite(want)
    assert (np.isfinite(got) == live).all(), "+inf pattern"
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["gathered", "sliced"])
def test_rays_and_ndc_depths_match_reference(name, converted):
    v, m, jv, jm = converted[name]
    eye, dirs = tvc.rays_from_metadata(m)
    jeye, jdirs = jvc.rays_from_metadata(jm)
    np.testing.assert_allclose(np_(eye), np.asarray(jeye), atol=1e-6)
    np.testing.assert_allclose(np_(dirs), np.asarray(jdirs), atol=ATOL)
    if name == "gathered":
        _, pdirs = tcam.pixel_rays(converted["cam"], 48, 40)
        np.testing.assert_allclose(np_(dirs), np_(pdirs), atol=1e-4)
    ndc = tvc.depths_to_ndc(v, m)
    jndc = jvc.depths_to_ndc(jv, jm)
    _assert_depths(ndc.depth, jndc.depth)
    live = np.isfinite(np_(v.depth[:, 0]))
    s = np_(ndc.depth[:, 0])[live]
    assert (s >= -1.0 - 1e-3).all() and (s <= 1.0 + 1e-3).all()
    back = tvc.depths_from_ndc(ndc, m)
    _assert_depths(back.depth, jvc.depths_from_ndc(jndc, jm).depth)
    t0, t1 = np_(v.depth), np_(back.depth)
    both = np.isfinite(t0)
    np.testing.assert_allclose(t0[both], t1[both], rtol=1e-3, atol=1e-3)


def test_interchange_layouts_match_reference(converted):
    v, _, jv, _ = converted["gathered"]
    color, depth = tvc.pack_reference_layout(v)
    jcolor, jdepth = jvc.pack_reference_layout(jv)
    np.testing.assert_array_equal(color, jcolor)
    np.testing.assert_array_equal(depth, jdepth)
    back = tvc.unpack_reference_layout(color, depth, device=CPU)
    jback = jvc.unpack_reference_layout(jcolor, jdepth)
    np.testing.assert_array_equal(np_(back.color), np.asarray(jback.color))
    np.testing.assert_array_equal(np_(back.depth), np.asarray(jback.depth))
    packed = tvc.pack_3layer(v)
    np.testing.assert_array_equal(packed, jvc.pack_3layer(jv))
    rt = tvc.unpack_3layer(packed, device=CPU)
    jrt = jvc.unpack_3layer(packed)
    np.testing.assert_array_equal(np_(rt.depth), np.asarray(jrt.depth))
    img = tvc.render_packed_vdi(packed, background=(1, 1, 1, 1),
                                device=CPU)
    np.testing.assert_allclose(np_(img), np.asarray(jvc.render_packed_vdi(
        packed, background=(1, 1, 1, 1))), rtol=0, atol=ATOL)
    np.testing.assert_allclose(np_(img), np_(render_vdi_same_view(
        v, background=(1, 1, 1, 1))), rtol=0, atol=ATOL)


def test_validate_vdi_matches_reference(converted):
    for name in ("gathered", "sliced"):
        v, m, jv, jm = converted[name]
        rep = tvc.validate_vdi(v)
        assert rep == jvc.validate_vdi(jv)
        assert rep["live_slots"] > 0
        for key in ("inverted_extent", "overlapping", "unsorted",
                    "alpha_out_of_range"):
            assert rep[key] == 0, (key, rep)
        rep = tvc.validate_vdi(tvc.depths_to_ndc(v, m), ndc=True)
        assert rep["ndc_out_of_range"] == 0, rep
    bad = np_(converted["gathered"][0].depth).copy()
    k, h, w = np.argwhere(np.isfinite(bad[:, 0]))[0]
    bad[k, 1, h, w] = bad[k, 0, h, w] - 1.0
    v = converted["gathered"][0]
    rep = tvc.validate_vdi(VDI(v.color, torch.from_numpy(bad)))
    assert rep["inverted_extent"] >= 1
    assert rep == jvc.validate_vdi(jvdi.VDI(jnp.asarray(np_(v.color)),
                                            jnp.asarray(bad)))


def test_vulkan_frame_converters_match_reference():
    cam, jc = _cams((0.2, 0.4, 3.0), 50.0, 0.5, 10.0)
    p_gl = tcam.projection_matrix(cam, 64, 48)
    p_vk = tvc.projection_gl_to_vulkan(p_gl)
    np.testing.assert_allclose(np_(p_vk), np.asarray(
        jvc.projection_gl_to_vulkan(jcam.projection_matrix(jc, 64, 48))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np_(tvc.projection_vulkan_to_gl(p_vk)),
                               np_(p_gl), atol=1e-6)
    np.testing.assert_array_equal(tvc.vulkan_projection_fix(),
                                  jvc.vulkan_projection_fix())
    img = np.random.default_rng(0).random((4, 8, 6)).astype(np.float32)
    t = torch.from_numpy(img)
    for fn in ("gamma_encode", "gamma_decode", "flip_y",
               "to_reference_frame"):
        np.testing.assert_allclose(np_(getattr(tvc, fn)(t)), np.asarray(
            getattr(jvc, fn)(jnp.asarray(img))), rtol=1e-6, atol=1e-7,
            err_msg=fn)
    np.testing.assert_allclose(np_(tvc.gamma_decode(tvc.gamma_encode(t))),
                               img, rtol=1e-4, atol=1e-6)


def test_new_entry_points_without_cuda_raise(monkeypatch, tmp_path):
    """device=None means CUDA: without a card the slice's entry points
    that make tensors raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "v.raw"
    np.zeros(8, np.uint8).tofile(path)
    packed = np.zeros((3, 2, 2, 4), np.float32)
    calls = [
        lambda: tvol.load_raw(str(path), (2, 2, 2)),
        lambda: tvol.load_dataset("kingsnake", str(tmp_path)),
        lambda: tvc.unpack_reference_layout(np.zeros((1, 2, 2, 4)),
                                            np.zeros((2, 2, 2))),
        lambda: tvc.unpack_3layer(packed),
        lambda: tvc.render_packed_vdi(packed),
        lambda: convert.axis_camera([np.zeros(3)] * 9),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
