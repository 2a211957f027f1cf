"""Parity of the port's distributed sort-last frame with the JAX package,
on the CPU: the halo exchange, the sharding, and the distributed
histogram step, threshold seed and temporal step against the reference's
shard_map functions on its virtual CPU mesh, in both march regimes.

Both packages get the same volume (numpy, seeded) and camera. The VDI
arrays and the threshold maps themselves are compared at the ``xla``
fold bar of ``tests/test_torch_pipeline.py`` (rtol 1e-4, atol 1e-5);
the halo exchange and the sharding exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.core import volume as jvol
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.parallel import mesh as jmesh
from scenery_insitu_tpu.parallel import pipeline as jpipe
from scenery_insitu_tpu.utils.compat import shard_map
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from tests.test_torch_pipeline import (  # noqa: F401
    assert_vdi_close, np_, one_torch_thread)

CPU = "cpu"
N = 4
RTOL, ATOL = 1e-4, 1e-5
# march axis z (the sharded axis), and march axis x (z in-plane: halo
# rows and ownership bounds)
EYES = [(0.0, 0.2, 4.0), (3.8, 0.3, 0.6)]


def _halo_ref(data, h):
    f = jax.jit(shard_map(
        lambda x: jmesh.halo_exchange_z(x, h=h),
        mesh=jmesh.make_mesh(N), in_specs=P("ranks", None, None),
        out_specs=P("ranks", None, None), check_vma=False))
    return np.asarray(f(jnp.asarray(data)))


@pytest.mark.parametrize("h", [1, 2])
def test_halo_exchange_matches_reference(h):
    rng = np.random.default_rng(3)
    data = rng.random((4 * N, 3, 5), dtype=np.float32)
    want = _halo_ref(data, h).reshape(N, 4 + 2 * h, 3, 5)
    mesh = tmesh.make_mesh(N, device=CPU)
    got = tmesh.halo_exchange_z(tmesh.shard_volume(torch.from_numpy(data),
                                                   mesh), h=h)
    np.testing.assert_array_equal(np_(got), want)


def test_halo_deeper_than_slab_raises():
    slabs = torch.zeros((N, 2, 3, 3))
    with pytest.raises(ValueError, match="exceeds"):
        tmesh.halo_exchange_z(slabs, h=3)


def test_shard_volume_and_mesh():
    mesh = tmesh.make_mesh(N, device=CPU)
    assert (mesh.n, mesh.axis_names) == (N, ("ranks",))
    data = torch.arange(8 * 2 * 3, dtype=torch.float32).reshape(8, 2, 3)
    sh = tmesh.shard_volume(data, mesh)
    assert sh.shape == (N, 2, 2, 3)
    for r in range(N):
        torch.testing.assert_close(sh[r], data[2 * r:2 * r + 2], rtol=0,
                                   atol=0)
    with pytest.raises(ValueError, match="divisible"):
        tmesh.shard_volume(torch.zeros((6, 2, 2)), mesh)
    with pytest.raises(ValueError):
        tmesh.make_mesh(0, device=CPU)


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(N)


def _setup(eye):
    jv = jvol.procedural_volume(16, kind="blobs")
    data = np.array(jv.data)
    jc = jcam.Camera.create(eye, fov_y_deg=50.0, near=0.5, far=20.0)
    tc = tcam.Camera.create(eye, fov_y_deg=50.0, near=0.5, far=20.0,
                            device=CPU)
    jspec = jsl.make_spec(jc, data.shape, jcfg.SliceMarchConfig(
        matmul_dtype="f32", scale=1.5), multiple_of=N)
    tspec = tsl.make_spec(tc, data.shape, tcfg.SliceMarchConfig(scale=1.5),
                          multiple_of=N)
    assert (tspec.axis, tspec.sign, tspec.ni, tspec.nj) == \
        (jspec.axis, jspec.sign, jspec.ni, jspec.nj)
    return dict(
        data=data, jc=jc, tc=tc, jspec=jspec, tspec=tspec,
        jmesh=jmesh.make_mesh(N), tmesh=tmesh.make_mesh(N, device=CPU),
        jtf=jtf.TransferFunction.ramp(0.05, 0.8, 0.7),
        ttf=ttf.TransferFunction.ramp(0.05, 0.8, 0.7, device=CPU),
        origin=np.array(jv.origin), spacing=np.array(jv.spacing))


def _args(s, side):
    if side == "j":
        return (jpipe.shard_volume(jnp.asarray(s["data"]), s["jmesh"]),
                jnp.asarray(s["origin"]), jnp.asarray(s["spacing"]), s["jc"])
    return (tmesh.shard_volume(torch.from_numpy(s["data"]),
                               s["tmesh"]),
            torch.from_numpy(s["origin"]), torch.from_numpy(s["spacing"]),
            s["tc"])


def _check_meta(tmeta, jmeta):
    for name, a, b in zip(jmeta._fields, tmeta, jmeta):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("eye", EYES)
def test_distributed_histogram_step_matches_reference(eye):
    """The histogram-mode step: the assembled global VDI and its
    metadata."""
    s = _setup(eye)
    vcfg = dict(max_supersegments=10, adaptive_mode="histogram")
    jstep = jpipe.distributed_vdi_step_mxu(
        s["jmesh"], s["jtf"], s["jspec"], jcfg.VDIConfig(**vcfg),
        jcfg.CompositeConfig(max_output_supersegments=16))
    tstep = tpipe.distributed_vdi_step_mxu(
        s["tmesh"], s["ttf"], s["tspec"], tcfg.VDIConfig(**vcfg),
        tcfg.CompositeConfig(max_output_supersegments=16))
    jvdi, jmeta = jstep(*_args(s, "j"))
    tvdi, tmeta = tstep(*_args(s, "t"))
    assert tvdi.color.shape == (16, 4, s["tspec"].nj, s["tspec"].ni)
    assert_vdi_close(tvdi.color, tvdi.depth, jvdi.color, jvdi.depth, RTOL,
                     ATOL)
    _check_meta(tmeta, jmeta)
    assert np.isfinite(np_(tvdi.depth)[:, 0]).any(), "live slots"


@pytest.mark.parametrize("eye", EYES)
def test_distributed_temporal_steps_match_reference(eye):
    """The threshold seed and 3 temporal frames, the rank-stacked
    threshold maps carried frame to frame on both sides; every frame's
    VDI and maps are compared."""
    s = _setup(eye)
    vcfg = dict(max_supersegments=10, adaptive_mode="temporal")
    jseed = jpipe.distributed_initial_threshold_mxu(
        s["jmesh"], s["jtf"], s["jspec"], jcfg.VDIConfig(**vcfg))
    tseed = tpipe.distributed_initial_threshold_mxu(
        s["tmesh"], s["ttf"], s["tspec"], tcfg.VDIConfig(**vcfg))
    jthr = jseed(*_args(s, "j"))
    tthr = tseed(*_args(s, "t"))
    assert tthr.thr.shape == (N * s["tspec"].nj, s["tspec"].ni)
    for a, b in zip(tthr, jthr):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    # the converter carries the reference's rank-stacked state over
    tthr = convert.threshold_state(
        {f: np.asarray(x) for f, x in zip(jthr._fields, jthr)}, device=CPU)
    jstep = jpipe.distributed_vdi_step_mxu_temporal(
        s["jmesh"], s["jtf"], s["jspec"], jcfg.VDIConfig(**vcfg),
        jcfg.CompositeConfig(max_output_supersegments=16))
    tstep = tpipe.distributed_vdi_step_mxu_temporal(
        s["tmesh"], s["ttf"], s["tspec"], tcfg.VDIConfig(**vcfg),
        tcfg.CompositeConfig(max_output_supersegments=16))
    for _ in range(3):
        (jvdi, jmeta), jthr = jstep(*_args(s, "j"), jthr)
        (tvdi, tmeta), tthr = tstep(*_args(s, "t"), tthr)
        assert_vdi_close(tvdi.color, tvdi.depth, jvdi.color, jvdi.depth,
                         RTOL, ATOL)
        for a, b in zip(tthr, jthr):
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
    _check_meta(tmeta, jmeta)
    # a reference global VDI carried over renders as the port's own
    jv = convert.vdi({"color": np.asarray(jvdi.color),
                      "depth": np.asarray(jvdi.depth)}, device=CPU)
    np.testing.assert_allclose(np_(render_vdi_same_view(jv)),
                               np_(render_vdi_same_view(tvdi)), atol=1e-4)


@pytest.mark.parametrize("eye", EYES)
def test_distributed_image_equals_single_device(eye):
    """Sort-last invariance inside the port: the 4-rank histogram frame
    renders, from the generating view, the image of the single-device
    march of the same volume (within 1e-6)."""
    s = _setup(eye)
    vcfg = tcfg.VDIConfig(max_supersegments=10, adaptive_mode="histogram")
    vdi, _ = tpipe.distributed_vdi_step_mxu(
        s["tmesh"], s["ttf"], s["tspec"], vcfg,
        tcfg.CompositeConfig(max_output_supersegments=16))(*_args(s, "t"))
    vol = tvol.Volume(*(torch.from_numpy(s[k]) for k in
                        ("data", "origin", "spacing")))
    single, _, _ = tsl.generate_vdi_mxu(vol, s["ttf"], s["tc"], s["tspec"],
                                        vcfg)
    np.testing.assert_allclose(np_(render_vdi_same_view(vdi)),
                               np_(render_vdi_same_view(single)), atol=1e-6)


def test_width_divisibility_check():
    s = _setup(EYES[0])
    spec = tsl.make_spec(s["tc"], s["data"].shape,
                         tcfg.SliceMarchConfig(scale=1.5))
    spec = spec.__class__(**{**spec.__dict__, "ni": 18})
    with pytest.raises(ValueError, match="not divisible by mesh size"):
        tpipe.distributed_vdi_step_mxu(s["tmesh"], s["ttf"], spec)
    assert tsl.make_spec(s["tc"], (16, 16, 16), tcfg.SliceMarchConfig(
        scale=1.25), multiple_of=3).ni % 3 == 0


def test_unported_topology_raises():
    """A two-host topology on a flat mesh is a caller's bug: it raises
    the reference's message (the two-level mesh comes from
    ``topology.make_topology_mesh``)."""
    mesh = tmesh.make_mesh(N, device=CPU)
    s = _setup(EYES[0])
    with pytest.raises(ValueError, match="flat 1-D") as e:
        tpipe.distributed_vdi_step_mxu(
            mesh, s["ttf"], s["tspec"],
            topology=tcfg.TopologyConfig(num_hosts=2))
    assert "make_topology_mesh" in str(e.value)
