"""Parity of the port's bf16 resampling with the JAX package, on the CPU.

The reference resamples in bf16 on its accelerator: its einsums round the
three operands to bf16 and accumulate in f32 (``preferred_element_type``).
Its jaxpr lowers each to two products, ``wv @ slices`` first, with an f32
intermediate. The port does the same on the card (``aten::bmm.dtype`` for
the first product) and, on the CPU, in its plain form: the operands
rounded through bf16, then f32 products. ``make_spec`` resolves bf16 to
f32 on the CPU in both packages, so both sides here replace their spec's
``matmul_dtype`` with ``"bf16"`` (the reference is not edited).

Both packages get the same inputs (the numpy-seeded 32^3 blobs, the
reference's VDI of ``tests/test_vdi_novel.py`` carried to the port).
Tolerances: 1e-5 absolute on products and proxy volumes (they differ
only in their f32 summation order), 1.6e-4 on the raw values summed over
a march, 2e-5 on images: the opacity power amplifies the summation
order (the plane sweep's image 1.65e-5 from the reference in bf16, 5.5e-6
in f32), and XLA's eager TF and power move the f32 march's own image by
1.1e-5 on this scene, so the bf16 march also stays within 1e-6 of the
f32 path's gap. The f32 path is held bit for bit to the plain product
pair it always was."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.core import vdi as jvdi
from scenery_insitu_tpu.core import volume as jvol
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.ops import vdi_novel as jnv
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.ops import ao as tao
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.ops import vdi_novel as tnv
from tests.test_torch_pipeline import np_, one_torch_thread  # noqa: F401

CPU = "cpu"
ATOL = 1e-5
IMAGE_ATOL = 2e-5       # images: see the module docstring
EYE = (0.4, 0.7, 2.6)
EYE_X = (2.6, 0.4, 0.5)
SHIFT = 1.0007          # tests/test_torch_novel.py's depth scaling


def _cams(eye):
    return (tcam.Camera.create(eye, fov_y_deg=50.0, near=0.3, far=20.0,
                               device=CPU),
            jcam.Camera.create(eye, fov_y_deg=50.0, near=0.3, far=20.0))


def _mm(spec, mm):
    return dataclasses.replace(spec, matmul_dtype=mm)


def _specs(eye, shape, mm="bf16", **over):
    """Both packages' specs with ``matmul_dtype`` replaced by ``mm``."""
    cam, jc = _cams(eye)
    spec = tsl.make_spec(cam, shape, tcfg.SliceMarchConfig(**over))
    jspec = jsl.make_spec(jc, shape, jcfg.SliceMarchConfig(**over))
    assert spec.matmul_dtype == jspec.matmul_dtype == "f32"
    return (_mm(spec, mm), _mm(jspec, mm),
            cam, jc)


@pytest.fixture(scope="module")
def scene():
    vol = tvol.procedural_volume(32, kind="blobs", seed=5, device=CPU)
    jv = jvol.procedural_volume(32, kind="blobs", seed=5)
    np.testing.assert_array_equal(np_(vol.data), np.asarray(jv.data))
    return dict(vol=vol, jvol=jv, tf=ttf.for_dataset("procedural",
                                                     device=CPU),
                jtf=jtf.for_dataset("procedural"))


def test_matmul_dtype_resolves_by_device():
    """bf16 only on a CUDA device; the CPU's spec and the metadata's
    rebuilt spec resolve to f32, as the reference's do off its
    accelerator."""
    assert tsl.resolve_matmul_dtype("bf16", True) == "bf16"
    assert tsl.resolve_matmul_dtype("bf16", False) == "f32"
    assert tsl.resolve_matmul_dtype("f32", True) == "f32"
    cam, _ = _cams(EYE)
    assert tsl.make_spec(cam, (32,) * 3).matmul_dtype == "f32"
    assert tcfg.SliceMarchConfig().matmul_dtype == "bf16"


@pytest.mark.parametrize("channels", [0, 5])
def test_resample_product_matches_reference_einsum(channels):
    """One chunk's operands through both packages' bf16 product (the
    reference's einsum with ``preferred_element_type=f32``), and the
    f32 product bit for bit the plain pair it replaced."""
    rng = np.random.default_rng(7)
    c, b, y, x, i = 4, 24, 20, 18, 22
    shape = (c, channels, y, x) if channels else (c, y, x)
    wv = rng.random((c, b, y), dtype=np.float32)
    sl = rng.random(shape, dtype=np.float32)
    wu = rng.random((c, i, x), dtype=np.float32)
    t = [torch.from_numpy(a) for a in (wv, sl, wu)]
    got = tsl.resample_product(*t, "bf16")
    bf = jnp.bfloat16
    sub = "cjy,cdyx,cix->cdji" if channels else "cjy,cyx,cix->cji"
    want = jnp.einsum(sub, *(jnp.asarray(a).astype(bf) for a in
                             (wv, sl, wu)),
                      preferred_element_type=jnp.float32)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-6,
                               atol=ATOL)
    f32 = tsl.resample_product(*t, "f32")
    if channels:
        old = torch.matmul(torch.matmul(t[0][:, None], t[1]),
                           t[2].transpose(1, 2)[:, None])
    else:
        old = torch.bmm(torch.bmm(t[0], t[1]), t[2].transpose(1, 2))
    assert torch.equal(f32, old)
    assert float((got - f32).abs().max()) > 0.0   # bf16 rounded something


@pytest.mark.parametrize("eye", [EYE, EYE_X])
def test_bf16_raycast_matches_reference(eye, scene):
    """The shaded march (``rows_rgba``) and its warp, in two regimes."""
    gaps = {}
    for mm in ("f32", "bf16"):
        spec, jspec, cam, jc = _specs(eye, (32,) * 3, mm=mm)
        got = tsl.raycast_mxu(scene["vol"], scene["tf"], cam, 48, 40, spec)
        want = jsl.raycast_mxu(scene["jvol"], scene["jtf"], jc, 48, 40,
                               jspec)
        gaps[mm] = (float(np.abs(np_(got.image)
                                 - np.asarray(want.image)).max()),
                    got.image)
    # XLA's TF and opacity power already move the f32 image on this
    # scene; bf16 adds at most 1e-6 to that
    assert gaps["bf16"][0] <= IMAGE_ATOL, gaps["bf16"][0]
    assert gaps["bf16"][0] <= gaps["f32"][0] + 1e-6, gaps
    assert float((gaps["bf16"][1] - gaps["f32"][1]).abs().max()) > 0.0


def test_bf16_raw_and_pre_shaded_rows_match_reference(scene):
    """The raw rows (``rows_val``: the fused folds' value planes) and the
    pre-shaded rows, summed over the march in both packages."""
    spec, jspec, cam, jc = _specs(EYE, (32,) * 3)
    vol, jv = scene["vol"], scene["jvol"]
    axcam = tsl.make_axis_camera(vol, cam, spec)
    jaxcam = jsl.make_axis_camera(jv, jc, jspec)
    got = tsl.slice_march(vol, scene["tf"], axcam, spec,
                          lambda acc, val, sk: acc + val.sum(0),
                          torch.zeros((spec.nj, spec.ni)), raw=True,
                          raw_full_skip=True)
    want = jax.jit(lambda v: jsl.slice_march(
        v, scene["jtf"], jaxcam, jspec,
        lambda acc, val, sk: acc + val.sum(0),
        jnp.zeros((jspec.nj, jspec.ni)), raw=True, raw_full_skip=True))(jv)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0,
                               atol=16 * ATOL)
    # the pre-shaded march: the port's shaded volume given to both
    shaded = tao.shade_volume_ao(vol, scene["tf"], 2, 0.5)
    jshaded = jvol.Volume(jnp.asarray(np_(shaded.data)),
                          jnp.asarray(np_(shaded.origin)),
                          jnp.asarray(np_(shaded.spacing)))
    got = tsl.raycast_mxu(shaded, None, cam, 48, 40, spec)
    want = jsl.raycast_mxu(jshaded, None, jc, 48, 40, jspec)
    np.testing.assert_allclose(np_(got.image), np.asarray(want.image),
                               rtol=0, atol=IMAGE_ATOL)


@pytest.fixture(scope="module")
def novel():
    """tests/test_vdi_novel.py's VDI of the 32^3 blobs (made by the
    reference), depth-scaled off the slice planes, in both packages, with
    the generating camera and a bf16 spec."""
    vol = jvol.procedural_volume(32, kind="blobs", seed=3)
    jc = jcam.Camera.create((0.1, 0.3, 2.8), fov_y_deg=45.0, near=0.3,
                            far=10.0)
    spec = jsl.make_spec(jc, vol.data.shape, jcfg.SliceMarchConfig(
        matmul_dtype="f32", scale=1.5))
    vdi, meta, axcam = jsl.generate_vdi_mxu(
        vol, jtf.for_dataset("procedural"), jc, spec,
        jcfg.VDIConfig(max_supersegments=8, adaptive_iters=3))
    off = jvdi.VDI(vdi.color, vdi.depth * jnp.float32(SHIFT))
    jspec = _mm(spec, "bf16")
    return dict(joff=off, jaxcam=axcam, jspec=jspec,
                off=convert.vdi(off, device=CPU),
                axcam=convert.axis_camera(axcam, device=CPU),
                spec=convert.axis_spec(jspec))


def test_bf16_proxy_and_sweep_match_reference(novel):
    """``vdi_to_rgba_volume`` and the same-regime plane sweep
    ``render_vdi_mxu`` with a bf16 spec (``ops/vdi_novel.py:199, 245,
    743`` of the reference)."""
    n = novel
    assert n["spec"].matmul_dtype == "bf16"
    proxy = tnv.vdi_to_rgba_volume(n["off"], n["axcam"], n["spec"],
                                   num_slices=48)
    jproxy = jnv.vdi_to_rgba_volume(n["joff"], n["jaxcam"], n["jspec"],
                                    num_slices=48)
    np.testing.assert_allclose(np_(proxy.data), np.asarray(jproxy.data),
                               rtol=0, atol=ATOL)
    cam, jc = (tcam.Camera.create((0.45, 0.55, 2.6), fov_y_deg=45.0,
                                  near=0.3, far=10.0, device=CPU),
               jcam.Camera.create((0.45, 0.55, 2.6), fov_y_deg=45.0,
                                  near=0.3, far=10.0))
    got = tnv.render_vdi_mxu(n["off"], n["axcam"], n["spec"], cam, 40, 32,
                             num_slices=48)
    want = jnv.render_vdi_mxu(n["joff"], n["jaxcam"], n["jspec"], jc, 40,
                              32, num_slices=48)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0,
                               atol=IMAGE_ATOL)
    f32 = tnv.render_vdi_mxu(n["off"], n["axcam"],
                             _mm(n["spec"], "f32"), cam,
                             40, 32, num_slices=48)
    assert float((got - f32).abs().max()) > 0.0
