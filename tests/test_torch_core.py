"""Parity of the PyTorch port's geometry, transfer-function and slicer
set-up functions with the JAX package, on the CPU.

Both packages get the same inputs (numpy, seeded) and must agree to
atol 1e-6 unless a test states otherwise."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.core import volume as jvol
from scenery_insitu_tpu.ops import sampling as jsamp
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.ops import sampling as tsamp
from scenery_insitu_tpu_torch.ops import slicer as tsl
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

# the package re-exports a function of the same name over the module
jraycast = importlib.import_module("scenery_insitu_tpu.ops.raycast")

ATOL = 1e-6
CPU = "cpu"
EYES = [(0.35, 0.55, 2.7), (0.1, -0.4, -2.9), (2.6, 0.3, 0.5),
        (-2.4, 0.9, -0.2), (0.3, 2.8, 0.4), (0.2, -2.5, -0.6)]


def close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("cls", ["VDIConfig", "SliceMarchConfig",
                                 "CompositeConfig", "SimConfig"])
def test_config_fields_and_defaults_match(cls):
    """Every field of the port's copy exists in the reference with the
    same default."""
    ref = {f.name: f.default for f in dataclasses.fields(getattr(jcfg, cls))}
    for f in dataclasses.fields(getattr(tcfg, cls)):
        assert f.name in ref, f"{cls}.{f.name} is not a reference field"
        assert f.default == ref[f.name], f"{cls}.{f.name} default"


def test_config_validation_messages_match():
    for kw in ({"adaptive_mode": "nope"},):
        with pytest.raises(ValueError) as a:
            jcfg.VDIConfig(**kw)
        with pytest.raises(ValueError) as b:
            tcfg.VDIConfig(**kw)
        assert str(a.value) == str(b.value)
    # the ring is ported: an unknown exchange gives the reference's
    # message
    with pytest.raises(ValueError) as a:
        jcfg.CompositeConfig(exchange="mesh")
    with pytest.raises(ValueError) as b:
        tcfg.CompositeConfig(exchange="mesh")
    assert str(a.value) == str(b.value)
    assert tcfg.CompositeConfig(exchange="ring").exchange == "ring"


@pytest.mark.parametrize("eye", EYES[:3])
def test_camera_view_projection_orbit(eye):
    jc = jcam.Camera.create(eye, fov_y_deg=45.0, near=0.3, far=20.0)
    tc = tcam.Camera.create(eye, fov_y_deg=45.0, near=0.3, far=20.0,
                            device=CPU)
    for f in jc._fields:
        close(getattr(tc, f), getattr(jc, f))
    close(tcam.look_at(tc.eye, tc.target, tc.up),
          jcam.look_at(jc.eye, jc.target, jc.up))
    close(tcam.perspective(tc.fov_y, 1.5, 0.3, 20.0),
          jcam.perspective(jc.fov_y, 1.5, 0.3, 20.0), rtol=1e-6)
    args = [np.float32(x) for x in (-0.4, 0.5, -0.3, 0.35, 0.8, 9.0)]
    close(tcam.frustum(*(torch.tensor(a) for a in args)),
          jcam.frustum(*(jnp.float32(a) for a in args)), rtol=1e-6)
    for yaw, pitch in ((0.3, 0.0), (-1.1, 0.2)):
        close(tcam.orbit(tc, yaw, pitch).eye, jcam.orbit(jc, yaw, pitch).eye)


def test_volume_geometry_and_procedural():
    rng = np.random.default_rng(0)
    data = rng.random((12, 20, 16), dtype=np.float32)
    jv = jvol.Volume.centered(jnp.asarray(data), extent=2.0)
    tv = tvol.Volume.centered(data, extent=2.0, device=CPU)
    assert tv.dims_xyz == jv.dims_xyz
    for name in ("origin", "spacing", "world_min", "world_max"):
        close(getattr(tv, name), getattr(jv, name))
    jv2 = jvol.Volume.create(jnp.asarray(data), (0.1, 0.2, 0.3),
                             (0.5, 0.25, 1.0))
    tv2 = tvol.Volume.create(data, (0.1, 0.2, 0.3), (0.5, 0.25, 1.0),
                             device=CPU)
    close(tv2.world_max, jv2.world_max)
    for kind in ("blobs", "shell", "gradient"):
        close(tvol.procedural_volume(20, seed=3, kind=kind, device=CPU).data,
              jvol.procedural_volume(20, seed=3, kind=kind).data)


@pytest.mark.parametrize("name", sorted(ttf.DATASET_TRANSFER_FUNCTIONS))
def test_transfer_function_knots_and_eval(name):
    jt = jtf.for_dataset(name)
    tt = ttf.for_dataset(name, device=CPU)
    for f in jt._fields:
        np.testing.assert_array_equal(convert.to_numpy(getattr(tt, f)),
                                      np.asarray(getattr(jt, f)))
    x = np.linspace(-0.1, 1.1, 301, dtype=np.float32).reshape(7, 43)
    (jrgb, ja), (trgb, ta) = jt(jnp.asarray(x)), tt(torch.from_numpy(x))
    close(trgb, jrgb)
    close(ta, ja)
    rng = np.random.default_rng(1)
    lo = rng.random(200, dtype=np.float32)
    hi = np.minimum(lo + rng.random(200, dtype=np.float32) * 0.4, 1.0)
    close(tt.max_alpha_in(torch.from_numpy(lo), torch.from_numpy(hi)),
          jt.max_alpha_in(jnp.asarray(lo), jnp.asarray(hi)))


def test_transfer_function_convert_roundtrip():
    jt = jtf.TransferFunction.ramp(0.1, 0.7, 0.6, "jet")
    tt = convert.transfer_function([np.asarray(x) for x in jt], device=CPU)
    x = np.linspace(0, 1, 64, dtype=np.float32)
    close(tt(torch.from_numpy(x))[1], jt(jnp.asarray(x))[1])


def test_adjust_opacity_and_nominal_step():
    rng = np.random.default_rng(2)
    a = rng.random((5, 9), dtype=np.float32)
    r = (0.2 + 2.0 * rng.random((5, 9))).astype(np.float32)
    close(tsamp.adjust_opacity(torch.from_numpy(a), torch.from_numpy(r)),
          jsamp.adjust_opacity(jnp.asarray(a), jnp.asarray(r)))
    data = np.zeros((10, 14, 8), np.float32)
    jv = jvol.Volume.create(jnp.asarray(data), spacing=(0.3, 0.2, 0.5))
    tv = tvol.Volume.create(data, spacing=(0.3, 0.2, 0.5), device=CPU)
    close(tsamp.nominal_step(tv, 0.75), jraycast.nominal_step(jv, 0.75))


def _pair(eye, shape=(24, 20, 28), seed=4):
    data = np.random.default_rng(seed).random(shape, dtype=np.float32)
    jv = jvol.Volume.centered(jnp.asarray(data), extent=2.0)
    tv = tvol.Volume.centered(data, extent=2.0, device=CPU)
    jc = jcam.Camera.create(eye, fov_y_deg=50.0, near=0.3, far=20.0)
    tc = tcam.Camera.create(eye, fov_y_deg=50.0, near=0.3, far=20.0,
                            device=CPU)
    return jv, tv, jc, tc


@pytest.mark.parametrize("eye", EYES)
def test_make_spec_axis_camera_and_permute(eye):
    jv, tv, jc, tc = _pair(eye)
    assert tsl.choose_axis(tc) == jsl.choose_axis(jc)
    for cfg_kw in ({}, {"scale": 1.5, "chunk": 8}, {"occupancy_vtiles": 4}):
        js = jsl.make_spec(jc, jv.data.shape,
                           jcfg.SliceMarchConfig(fold="xla", **cfg_kw))
        ts = tsl.make_spec(tc, tuple(tv.data.shape),
                           tcfg.SliceMarchConfig(fold="xla", **cfg_kw))
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    jax_cam = jsl.make_axis_camera(jv, jc, js)
    t_cam = tsl.make_axis_camera(tv, tc, ts)
    for f in jax_cam._fields:
        close(getattr(t_cam, f), getattr(jax_cam, f), atol=2e-6, rtol=1e-6)
    close(t_cam.ray_lengths(), jax_cam.ray_lengths(), rtol=1e-6)
    np.testing.assert_array_equal(convert.to_numpy(tsl.permute_volume(tv, ts)),
                                  np.asarray(jsl.permute_volume(jv, js)))


def test_make_spec_off_tpu_rules_and_folds():
    jv, tv, jc, tc = _pair(EYES[0])
    shape = tuple(tv.data.shape)
    ts = tsl.make_spec(tc, shape, tcfg.SliceMarchConfig(matmul_dtype="bf16"))
    assert ts.matmul_dtype == "f32" and ts.vtiles == 0
    assert ts.fold == "xla"            # "auto" on a CPU camera
    for fold in ("pallas", "pallas_fused", "fused_stream"):
        ts = tsl.make_spec(tc, shape, tcfg.SliceMarchConfig(fold=fold))
        js = jsl.make_spec(jc, jv.data.shape, jcfg.SliceMarchConfig(
            matmul_dtype="f32", fold=fold))
        assert ts.fold == fold
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    with pytest.raises(ValueError):
        tsl.make_spec(tc, shape, tcfg.SliceMarchConfig(fold="bogus"))


def test_interp_matrix_matches():
    rng = np.random.default_rng(5)
    pos = (rng.random((3, 37), dtype=np.float32) * 2.6 - 1.3)
    # (origin, spacing, n): a grid inside the sample span, one that
    # covers it, and a coarse one
    for origin, spacing, n in ((-1.0, 0.1, 20), (-1.5, 0.05, 60),
                               (-0.7, 0.35, 4)):
        close(tsl._interp_matrix(torch.from_numpy(pos),
                                 torch.tensor(origin), torch.tensor(spacing),
                                 n),
              jsl._interp_matrix(jnp.asarray(pos), jnp.float32(origin),
                                 jnp.float32(spacing), n))
