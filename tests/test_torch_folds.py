"""Parity of the port's kernel fold schedules ``pallas`` (kernel B7),
``pallas_fused`` (B5) and ``fused_stream`` (B6) with the JAX package's
same folds (its Pallas kernels in interpret mode), on the CPU, where the
port's wrappers run their plain versions: whole marches, the raw march
with in-plane tiles, the temporal frame step and the distributed
temporal step.

Tolerances: the marches' VDIs within rtol 1e-5, atol 1e-5 and the
carried thresholds within 1e-6 (they bisect from integer counts); the
frame steps at the bar of ``tests/test_torch_pipeline.py`` (rtol 1e-4,
atol 1e-5) and the distributed step at the bar of
``tests/test_torch_parallel.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.core import volume as jvol
from scenery_insitu_tpu.models import pipelines as jpipe
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.parallel import pipeline as jdist
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.models import pipelines as tpipe
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.parallel import pipeline as tdist
from scenery_insitu_tpu_torch.sim import grayscott as tgs
from tests.test_torch_parallel import N, _args, _setup
from tests.test_torch_pipeline import (  # noqa: F401
    _gs_state, assert_vdi_close, np_, one_torch_thread)

CPU = "cpu"
FOLDS = ("pallas", "pallas_fused", "fused_stream")


def _pair(data, eye, fov=45.0, near=0.3, far=10.0):
    """The same volume (centred, extent 2) and camera in both packages."""
    jv = jvol.Volume.centered(jnp.asarray(data), extent=2.0)
    tv = tvol.Volume.centered(torch.from_numpy(np.array(data)), extent=2.0)
    jc = jcam.Camera.create(eye, fov_y_deg=fov, near=near, far=far)
    tc = tcam.Camera.create(eye, fov_y_deg=fov, near=near, far=far,
                            device=CPU)
    return jv, tv, jc, tc


def _specs(jv, jc, tc, fold, **cfg):
    jspec = jsl.make_spec(jc, jv.data.shape, jcfg.SliceMarchConfig(
        matmul_dtype="f32", fold=fold, **cfg))
    tspec = tsl.make_spec(tc, tuple(jv.data.shape),
                          tcfg.SliceMarchConfig(fold=fold, **cfg))
    assert tspec.fold == jspec.fold == fold
    assert (tspec.ni, tspec.nj, tspec.vtiles) == \
        (jspec.ni, jspec.nj, jspec.vtiles)
    return jspec, tspec


def _vdi_close(t, j, tol=1e-5):
    np.testing.assert_allclose(np_(t.color), np.asarray(j.color), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(np_(t.depth), np.asarray(j.depth), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("fold", FOLDS)
def test_whole_march_matches_reference_fold(fold):
    """generate_vdi_mxu (histogram, K=6, 8 bins), then initial_threshold
    and two temporal frames with the thresholds carried, against the
    reference's same fold on a 24^3 blob volume."""
    data = np.asarray(jvol.procedural_volume(24, kind="blobs", seed=7).data)
    jv, tv, jc, tc = _pair(data, (0.25, 0.5, 2.6))
    jspec, tspec = _specs(jv, jc, tc, fold, scale=1.5)
    jtf_ = jtf.for_dataset("procedural")
    ttf_ = ttf.for_dataset("procedural", device=CPU)
    kw = dict(max_supersegments=6, histogram_bins=8)
    jvdi, _, _ = jsl.generate_vdi_mxu(
        jv, jtf_, jc, jspec, jcfg.VDIConfig(adaptive_mode="histogram", **kw))
    tvdi, _, _ = tsl.generate_vdi_mxu(
        tv, ttf_, tc, tspec, tcfg.VDIConfig(adaptive_mode="histogram", **kw))
    _vdi_close(tvdi, jvdi)
    assert np.isfinite(np_(tvdi.depth)[:, 0]).sum() > 100

    jcfg_t = jcfg.VDIConfig(adaptive_mode="temporal", **kw)
    tcfg_t = tcfg.VDIConfig(adaptive_mode="temporal", **kw)
    jthr = jsl.initial_threshold(jv, jtf_, jc, jspec, jcfg_t)
    tthr = tsl.initial_threshold(tv, ttf_, tc, tspec, tcfg_t)
    for a, b in zip(tthr, jthr):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    for _ in range(2):
        jvdi, _, _, jthr = jsl.generate_vdi_mxu_temporal(
            jv, jtf_, jc, jspec, jthr, jcfg_t)
        tvdi, _, _, tthr = tsl.generate_vdi_mxu_temporal(
            tv, ttf_, tc, tspec, tthr, tcfg_t)
        _vdi_close(tvdi, jvdi)
        for a, b in zip(tthr, jthr):
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


def test_fused_fold_with_vtiles_matches_reference():
    """fold='pallas_fused' with 4 in-plane occupancy tiles on a sparse
    32^3 blob: the gated row blocks feed the raw -1 sentinel. Held
    against the reference's same fold and tiles, and against the port's
    sequential machine without tiles."""
    data = np.zeros((32, 32, 32), np.float32)
    data[4:12, 5:14, 6:16] = 0.8
    jv, tv, jc, tc = _pair(data, (0.2, 0.3, 2.8))
    jspec, tspec = _specs(jv, jc, tc, "pallas_fused", scale=1.0,
                          occupancy_vtiles=4)
    assert tspec.vtiles == 4
    kw = dict(max_supersegments=5, adaptive=False, threshold=0.3)
    jvdi, _, _ = jsl.generate_vdi_mxu(jv, jtf.for_dataset("procedural"), jc,
                                      jspec, jcfg.VDIConfig(**kw))
    ttf_ = ttf.for_dataset("procedural", device=CPU)
    tvdi, _, _ = tsl.generate_vdi_mxu(tv, ttf_, tc, tspec,
                                      tcfg.VDIConfig(**kw))
    _vdi_close(tvdi, jvdi)
    xspec = tsl.make_spec(tc, (32,) * 3, tcfg.SliceMarchConfig(
        scale=1.0, fold="xla", occupancy_vtiles=0))
    xvdi, _, _ = tsl.generate_vdi_mxu(tv, ttf_, tc, xspec,
                                      tcfg.VDIConfig(**kw))
    _vdi_close(tvdi, xvdi.__class__(*(np_(x) for x in xvdi)))
    assert np.isfinite(np_(tvdi.depth)[:, 0]).any()


@pytest.mark.parametrize("fold", ["fused_stream", "pallas"])
def test_frame_step_matches_reference_fold(fold):
    """The seed and 2 temporal frames of ``grayscott_vdi_frame_step`` at
    16^3 against the reference's step with the same fold, the threshold
    state carried on both sides."""
    n, k = 16, 6
    u, v, params = _gs_state(n)
    eyes = [(0.3 * np.sin(0.7 * i), 0.6, 3.0) for i in range(3)]
    kw = dict(sim_steps=2, grid_shape=(n,) * 3, sim_fused=False,
              fov_y_deg=50.0, axis_sign=(2, -1), engine="mxu")
    jstep = jpipe.grayscott_vdi_frame_step(
        64, 48, vdi_cfg=jcfg.VDIConfig(max_supersegments=k,
                                       adaptive_mode="temporal",
                                       histogram_bins=8),
        comp_cfg=jcfg.CompositeConfig(max_output_supersegments=k),
        slicer_cfg=jcfg.SliceMarchConfig(matmul_dtype="f32", fold=fold),
        params=jpipe.gs.GrayScottParams(*(jnp.asarray(p) for p in params)),
        **kw)
    tstep = tpipe.grayscott_vdi_frame_step(
        vdi_cfg=tcfg.VDIConfig(max_supersegments=k, adaptive_mode="temporal",
                               histogram_bins=8),
        comp_cfg=tcfg.CompositeConfig(max_output_supersegments=k),
        slicer_cfg=tcfg.SliceMarchConfig(fold=fold),
        params=tgs.GrayScottParams(*(torch.from_numpy(np.array(p))
                                     for p in params)), device=CPU, **kw)
    assert tstep.spec.fold == fold
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    tu, tv = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
    jthr = jstep.init_threshold(ju, jv, jnp.asarray(eyes[0], jnp.float32))
    tthr = tstep.init_threshold(tu, tv, torch.tensor(eyes[0]))
    for a, b in zip(tthr, jthr):
        np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-6)
    for i in range(1, 3):
        jc, jd, ju, jv, jthr = jstep(ju, jv, jnp.asarray(eyes[i],
                                                          jnp.float32), jthr)
        tc, td, tu, tv, tthr = tstep(tu, tv, torch.tensor(eyes[i]), tthr)
        assert_vdi_close(tc, td, jc, jd, 1e-4, 1e-5)
        np.testing.assert_allclose(np_(tv), np.asarray(jv), atol=1e-5)
        for a, b in zip(tthr, jthr):
            np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-6)
    assert np.isfinite(np_(td)[:, 0]).any(), "the frame has live slots"


@pytest.mark.parametrize("eye", [(0.0, 0.2, 4.0), (3.8, 0.3, 0.6)])
def test_distributed_temporal_step_fused_matches_reference(eye):
    """The 4-rank distributed seed and 2 temporal frames with
    fold='pallas_fused' against the reference's shard_map step with the
    same fold, in the z march (each rank its own slices) and the x
    march (halo rows and ownership bounds, where the raw planes carry
    -1 outside a rank's rows)."""
    s = _setup(eye)
    jspec = jsl.make_spec(s["jc"], s["data"].shape, jcfg.SliceMarchConfig(
        matmul_dtype="f32", scale=1.5, fold="pallas_fused"), multiple_of=N)
    tspec = tsl.make_spec(s["tc"], s["data"].shape, tcfg.SliceMarchConfig(
        scale=1.5, fold="pallas_fused"), multiple_of=N)
    assert tspec.fold == jspec.fold == "pallas_fused"
    vcfg = dict(max_supersegments=10, adaptive_mode="temporal")
    ccfg = dict(max_output_supersegments=16)
    jthr = jdist.distributed_initial_threshold_mxu(
        s["jmesh"], s["jtf"], jspec, jcfg.VDIConfig(**vcfg))(*_args(s, "j"))
    tthr = tdist.distributed_initial_threshold_mxu(
        s["tmesh"], s["ttf"], tspec, tcfg.VDIConfig(**vcfg))(*_args(s, "t"))
    jstep = jdist.distributed_vdi_step_mxu_temporal(
        s["jmesh"], s["jtf"], jspec, jcfg.VDIConfig(**vcfg),
        jcfg.CompositeConfig(**ccfg))
    tstep = tdist.distributed_vdi_step_mxu_temporal(
        s["tmesh"], s["ttf"], tspec, tcfg.VDIConfig(**vcfg),
        tcfg.CompositeConfig(**ccfg))
    for _ in range(2):
        (jvdi, _), jthr = jstep(*_args(s, "j"), jthr)
        (tvdi, _), tthr = tstep(*_args(s, "t"), tthr)
        assert_vdi_close(tvdi.color, tvdi.depth, jvdi.color, jvdi.depth,
                         1e-4, 1e-5)
        for a, b in zip(tthr, jthr):
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)
    assert np.isfinite(np_(tvdi.depth)[:, 0]).any(), "live slots"
    # the converter carries the reference's threshold state over
    assert convert.threshold_state(
        {f: np.asarray(x) for f, x in zip(jthr._fields, jthr)},
        device=CPU).thr.shape == tthr.thr.shape
