"""Parity of the port's vortex flow and hybrid volume + particle frames
with the JAX package's, on the CPU.

The vortex sim (``sim/vortex.py``): the ring, its field and the flow
after 3 steps within 1e-4 * max|u| (pocketfft against XLA's FFT), the
tracers' sampling exact, and the reference tests' physics on the port.
The hybrid composite (``ops/hybrid.py``) within 1e-6. The single-chip
hybrid frame step within 1e-5 with ``sim_steps=0`` and >= 60 dB after 3
steps. The distributed hybrid step (8 ranks, the reference tests' blob
scene and 64 particles) against the reference's same step within 1e-5
on the frame schedule, a render plan, a 2 x 4 topology and 3 temporal
frames; the ring, tile waves and lossy wires at the reference tests'
own bars inside the port (the ring within 1e-6 of the all_to_all, the
waves within 1e-5 of the frame, a lossy wire >= 40 dB from the f32
frame and not equal to it); the topology within 1e-5 of the flat frame,
the histogram frame >= 35 dB from the
single-device hybrid image and the temporal frames >= 27 dB from the
histogram frame (the reference tests' bars). The temporal vortex and
hybrid sessions run against the reference's from a state handed to both (the VDI sessions' bar of
``tests/test_torch_session.py``, the hybrid images within 1e-5), cross
checkpoints both ways, and keep their ``("hybrid", axis, sign)``
threshold keys apart. Reference runs are shared through module
fixtures."""

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
from scenery_insitu_tpu.core.vdi import VDI as JVDI
from scenery_insitu_tpu.models import pipelines as jpipes
from scenery_insitu_tpu.ops import hybrid as jhyb
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.ops import splat as jsplat
from scenery_insitu_tpu.parallel import mesh as jmesh
from scenery_insitu_tpu.parallel import particles as jpar
from scenery_insitu_tpu.parallel import pipeline as jpipe
from scenery_insitu_tpu.parallel import topology as jtop
from scenery_insitu_tpu.runtime import checkpoint as jck
from scenery_insitu_tpu.runtime import session as jses
from scenery_insitu_tpu.sim import vortex as jvx
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import convert
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.core.vdi import VDI as TVDI
from scenery_insitu_tpu_torch.models import pipelines as tpipes
from scenery_insitu_tpu_torch.ops import composite as tcomp
from scenery_insitu_tpu_torch.ops import hybrid as thyb
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.ops import splat as tsplat
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import particles as tpar
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from scenery_insitu_tpu_torch.parallel import topology as ttop
from scenery_insitu_tpu_torch.runtime import checkpoint as tck
from scenery_insitu_tpu_torch.runtime import session as tses
from scenery_insitu_tpu_torch.sim import vortex as tvx
from scenery_insitu_tpu_torch.utils.image import psnr
from tests.test_torch_pipeline import (  # noqa: F401
    assert_vdi_close, np_, one_torch_thread)

CPU = "cpu"
GRID = (16, 16, 16)
N = 8
T = 2
GATE = 1e-5                 # port against reference, the lossless steps
WIRE_FLOOR_DB = 40.0        # the reference's lossy-wire floor against f32
PLAN = (3, 1, 2, 2, 2, 2, 2, 2)
EYE = (0.0, 0.2, 4.0)
RADIUS, STAMP = 0.05, 3


def _np(x):
    return np.array(x, dtype=np.float32)


# ----------------------------------------------------------- the vortex


@pytest.fixture(scope="module")
def flows():
    """The reference's ring and its flow after 3 steps from the port's
    ring (the ring itself is held against the reference's below)."""
    t0 = tvx.VortexFlow.init_ring(GRID, device=CPU)
    j0 = jvx.VortexFlow(jnp.asarray(np_(t0.u)), jvx.VortexParams.create())
    return dict(t0=t0, jring=jvx.VortexFlow.init_ring(GRID),
                j3=jvx.multi_step(j0, 3))


def test_vortex_ring_and_steps_match_reference(flows):
    t0, jring = flows["t0"], flows["jring"]
    scale = float(np.abs(np.asarray(jring.u)).max())
    np.testing.assert_allclose(np_(t0.u), np.asarray(jring.u), rtol=0,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(np_(t0.field), np.asarray(jring.field),
                               atol=1e-6)
    t3 = tvx.multi_step(t0, 3)
    want = np.asarray(flows["j3"].u)
    np.testing.assert_allclose(np_(t3.u), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(np_(tvx.vorticity(t3.u)),
                               np.asarray(jvx.vorticity(jnp.asarray(want))),
                               atol=1e-4 * np.abs(want).max())
    got = convert.vortex_flow(want, flows["j3"].params, CPU)
    np.testing.assert_array_equal(np_(got.u), want)
    assert float(got.params.dt) == float(flows["j3"].params.dt)


def test_tracers_match_reference(flows):
    u = _np(flows["j3"].u)
    pos = tvx.seed_tracers(GRID, 256, seed=3, device=CPU)
    assert pos.shape == (256, 3)
    p = np_(pos)
    assert (p >= 4.0).all() and (p < 12.0).all()
    jp = jnp.asarray(p)
    np.testing.assert_array_equal(
        np_(tvx.tracer_velocities(torch.from_numpy(u), pos)),
        np.asarray(jvx.tracer_velocities(jnp.asarray(u), jp)))
    np.testing.assert_array_equal(
        np_(tvx.advect_tracers(torch.from_numpy(u), pos, torch.tensor(0.7))),
        np.asarray(jvx.advect_tracers(jnp.asarray(u), jp, jnp.float32(0.7))))
    origin, spacing = np.full(3, -1.0, np.float32), np.full(3, 0.125,
                                                             np.float32)
    np.testing.assert_array_equal(
        np_(tvx.tracers_to_world(pos, torch.from_numpy(origin),
                                 torch.from_numpy(spacing))),
        np.asarray(jvx.tracers_to_world(jp, origin, spacing)))
    np.testing.assert_array_equal(np_(convert.tracers(p, CPU)), p)


def test_vortex_physics():
    """The reference tests' physics on the port: the field normalised and
    ring shaped, the flow divergence-free in the solver's spectral sense
    after 10 steps, energy decaying under viscosity, the advection
    periodic across the low boundary."""
    fl = tvx.VortexFlow.init_ring(GRID, device=CPU)
    f = np_(fl.field)
    assert 0.99 <= f.max() <= 1.01 and f.min() >= 0.0
    assert f[8, 8, 8] < 0.5 * f.max()
    u = np_(tvx.multi_step(fl, 10).u)
    assert np.isfinite(u).all()
    kz, ky, kx = (np_(a) for a in tvx._grad_axes(u.shape[1:]))
    div_hat = (kx * np.fft.rfftn(u[0]) + ky * np.fft.rfftn(u[1])
               + kz * np.fft.rfftn(u[2]))
    scale = np.abs(np.fft.rfftn(u[0])).max() + 1e-9
    assert np.abs(div_hat).max() < 1e-4 * scale
    fl = tvx.VortexFlow.init_ring(GRID, tvx.VortexParams.create(
        viscosity=5e-2, device=CPU))
    assert float((tvx.multi_step(fl, 20).u ** 2).sum()) < \
        float((fl.u ** 2).sum())
    d = 8
    plane = torch.zeros((d, d, d))
    plane[:, :, 0] = 1.0
    same = tvx.advect_semilagrangian(torch.stack([plane] * 3),
                                     torch.tensor(0.0))
    np.testing.assert_allclose(np_(same[0]), np_(plane), atol=1e-6)
    moved = np_(tvx.advect_semilagrangian(torch.stack(
        [torch.full((d, d, d), 0.5), plane, torch.zeros((d, d, d))]),
        torch.tensor(1.0)))[1]
    np.testing.assert_allclose(moved[:, :, 0], 0.5, atol=1e-5)
    np.testing.assert_allclose(moved[:, :, 1], 0.5, atol=1e-5)
    np.testing.assert_allclose(moved[:, :, 2], 0.0, atol=1e-5)


# ---------------------------------------------------- the hybrid composite


def _one_seg(h, w, rgba, t0, t1, k=3):
    color = torch.zeros((k, 4, h, w))
    depth = torch.full((k, 2, h, w), float("inf"))
    color[0] = torch.tensor(rgba)[:, None, None]
    depth[0, 0], depth[0, 1] = t0, t1
    return TVDI(color, depth)


def test_hybrid_composite_semantics():
    """The reference's insertion tests on the port: no particle decodes
    the VDI, a particle in front hides it, one inside a slab sees its
    traversed fraction."""
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view

    vdi = _one_seg(4, 8, (0.2, 0.1, 0.0, 0.4), 2.0, 3.0)
    empty = tsplat.SplatOutput(torch.zeros((4, 4, 8)),
                               torch.full((4, 8), float("inf")))
    np.testing.assert_allclose(
        np_(thyb.composite_vdi_with_particles(vdi, empty)),
        np_(render_vdi_same_view(vdi)), atol=1e-6)
    vdi = _one_seg(4, 8, (0.2, 0.1, 0.0, 0.9), 2.0, 3.0)
    red = torch.zeros((4, 4, 8))
    red[0] = red[3] = 1.0
    out = np_(thyb.composite_vdi_with_particles(
        vdi, tsplat.SplatOutput(red, torch.full((4, 8), 1.0))))
    np.testing.assert_allclose(out[0], 1.0, atol=1e-6)
    np.testing.assert_allclose(out[1], 0.0, atol=1e-6)
    a = 0.6
    vdi = _one_seg(1, 1, (0.0, a, 0.0, a), 2.0, 4.0)
    out = np_(thyb.composite_vdi_with_particles(
        vdi, tsplat.SplatOutput(red[:, :1, :1], torch.full((1, 1), 3.0))))
    a_half = 1.0 - (1.0 - a) ** 0.5
    np.testing.assert_allclose(out[0, 0, 0], 1.0 - a_half, atol=1e-6)
    np.testing.assert_allclose(out[1, 0, 0], a_half, atol=1e-5)
    np.testing.assert_allclose(out[3, 0, 0], 1.0, atol=1e-6)


def test_hybrid_composite_matches_reference():
    rng = np.random.default_rng(1)
    k, h, w = 6, 12, 16
    col = rng.uniform(0, 1, (k, 4, h, w)).astype(np.float32)
    col[:, 3] = rng.uniform(0, 0.9, (k, h, w))
    t0 = np.sort(rng.uniform(1, 4, (k, h, w)), axis=0).astype(np.float32)
    t1 = (t0 + rng.uniform(0, 0.3, (k, h, w))).astype(np.float32)
    dep = np.stack([t0, t1], 1)
    dead = rng.random((k, h, w)) < 0.3
    dep[:, 0][dead] = dep[:, 1][dead] = np.inf
    img = rng.uniform(0, 1, (4, h, w)).astype(np.float32)
    img[3] = 1.0
    tp = rng.uniform(0.5, 5, (h, w)).astype(np.float32)
    tp[rng.random((h, w)) < 0.3] = np.inf
    want = jhyb.composite_vdi_with_particles(
        JVDI(jnp.asarray(col), jnp.asarray(dep)),
        jsplat.SplatOutput(jnp.asarray(img), jnp.asarray(tp)))
    got = thyb.composite_vdi_with_particles(
        TVDI(torch.from_numpy(col), torch.from_numpy(dep)),
        tsplat.SplatOutput(torch.from_numpy(img), torch.from_numpy(tp)))
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0,
                               atol=1e-6)


# ------------------------------------------------ the single-chip frame


@pytest.mark.parametrize("sim_steps", [0, 3])
def test_hybrid_frame_step_matches_reference(sim_steps, flows):
    u0 = np_(flows["t0"].u)
    pos = tvx.seed_tracers(GRID, 64, device=CPU)
    eye = (0.0, 0.5, 2.8)
    kw = dict(sim_steps=sim_steps, radius=0.05)
    want = jax.jit(jpipes.hybrid_vortex_frame_step(
        48, 40, GRID, axis_sign=(2, -1),
        vdi_cfg=jcfg.VDIConfig(max_supersegments=4, adaptive_iters=2),
        slicer_cfg=jcfg.SliceMarchConfig(matmul_dtype="f32"), **kw))(
        jnp.asarray(u0), jnp.asarray(np_(pos)), jnp.asarray(eye, jnp.float32))
    step = tpipes.hybrid_vortex_frame_step(
        48, 40, GRID, axis_sign=(2, -1),
        vdi_cfg=tcfg.VDIConfig(max_supersegments=4, adaptive_iters=2),
        device=CPU, **kw)
    img, u2, pos2 = step(torch.from_numpy(u0), pos, torch.tensor(eye))
    assert img.shape == (4, 40, 48) and np.isfinite(np_(img)).all()
    assert np_(img)[3].max() > 0.9         # the opaque spheres
    if sim_steps == 0:
        np.testing.assert_allclose(np_(img), np.asarray(want[0]), rtol=0,
                                   atol=1e-5)
    else:
        assert psnr(np_(img), np.asarray(want[0])) >= 60.0
        assert not torch.equal(pos2, pos)
        np.testing.assert_allclose(np_(pos2), np.asarray(want[2]),
                                   atol=1e-4)


# ------------------------------------------------ the distributed frame


def _scene():
    """The reference tests' blob scene, 64 particles and the spec."""
    vol = jvol.procedural_volume(16, kind="blobs")
    rng = np.random.default_rng(7)
    pos = rng.uniform(-0.8, 0.8, (64, 3)).astype(np.float32)
    vel = (rng.normal(0.0, 1.0, (64, 3)) * 0.1).astype(np.float32)
    return dict(data=_np(vol.data), origin=_np(vol.origin),
                spacing=_np(vol.spacing), pos=pos, vel=vel)


def _pkg(name):
    if name == "jax":
        return dict(cfg=jcfg, cam=jcam, tf=jtf, sl=jsl, mesh=jmesh,
                    pipe=jpipe, top=jtop, par=jpar, arr=jnp.asarray,
                    kw={}, spec_cfg=dict(matmul_dtype="f32"))
    return dict(cfg=tcfg, cam=tcam, tf=ttf, sl=tsl, mesh=tmesh, pipe=tpipe,
                top=ttop, par=tpar, arr=lambda x: torch.from_numpy(_np(x)),
                kw={"device": CPU}, spec_cfg={})


CONFIGS = {
    "frame": {},
    "ring": dict(exchange="ring"),
    "waves": dict(schedule="waves", wave_tiles=T),
    "bf16": dict(wire="bf16"),
    "qpack8": dict(exchange="ring", wire="qpack8"),
    "plan": dict(rebalance="occupancy"),
    "hier": {},
    "temporal": {},
}


def _run(name, config, scene):
    """One package's hybrid image (the temporal config: its seed and 3
    frames) on the scene."""
    p = _pkg(name)
    cam = p["cam"].Camera.create(EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                                 **p["kw"])
    tf = p["tf"].TransferFunction.ramp(0.05, 0.8, 0.7, **p["kw"])
    spec = p["sl"].make_spec(cam, GRID, p["cfg"].SliceMarchConfig(
        scale=2.0, **p["spec_cfg"]), multiple_of=N)
    topology = None
    if config == "hier":
        topology = p["cfg"].TopologyConfig(num_hosts=2)
        mesh, _ = p["top"].make_topology_mesh(
            topology, p["cfg"].MeshConfig(num_devices=N), **p["kw"])
    else:
        mesh = p["mesh"].make_mesh(N, **p["kw"])
    temporal = config == "temporal"
    vcfg = p["cfg"].VDIConfig(
        max_supersegments=6, adaptive_iters=2,
        adaptive_mode="temporal" if temporal else "histogram")
    ccfg = p["cfg"].CompositeConfig(max_output_supersegments=8,
                                    adaptive_iters=2, **CONFIGS[config])
    plan = PLAN if config == "plan" else None
    step = p["pipe"].distributed_hybrid_step_mxu(
        mesh, tf, spec, vcfg, ccfg, radius=RADIUS, stamp=STAMP,
        temporal=temporal, plan=plan, topology=topology)
    data = p["pipe"].shard_volume(p["arr"](scene["data"]), mesh) \
        if name == "jax" else tmesh.shard_volume(p["arr"](scene["data"]),
                                                 mesh)
    if name == "jax":
        from jax.sharding import NamedSharding, PartitionSpec as P

        axes = (mesh.axis_names if len(mesh.axis_names) > 1
                else mesh.axis_names[0])
        sh = NamedSharding(mesh, P(axes, None))
        pos = jax.device_put(jnp.asarray(scene["pos"]), sh)
        vel = jax.device_put(jnp.asarray(scene["vel"]), sh)
    else:
        pos = tpar.shard_particles(p["arr"](scene["pos"]), mesh)
        vel = tpar.shard_particles(p["arr"](scene["vel"]), mesh)
    args = (data, p["arr"](scene["origin"]), p["arr"](scene["spacing"]),
            pos, vel, cam)
    if not temporal:
        img, meta = step(*args)
        return dict(img=np_(img) if name == "port" else np.asarray(img),
                    spec=spec)
    thr = p["pipe"].distributed_initial_threshold_mxu(mesh, tf, spec, vcfg)(
        *args[:3], cam)
    for _ in range(3):
        (img, meta), thr = step(*args, thr)
    to_np = np_ if name == "port" else (lambda x: np.asarray(x))
    return dict(img=to_np(img), thr=[to_np(x) for x in thr], spec=spec)


LOSSY = ("bf16", "qpack8")
# held inside the port at the reference tests' own equalities (the ring
# to the all_to_all, the waves to the frame), which the reference's
# tests hold for the reference
INTERNAL = ("ring", "waves") + LOSSY


@pytest.fixture(scope="module")
def dist():
    """Every configuration in the port; the others in the reference too
    (a lossy wire is held at the reference tests' own bar, against the
    f32 frame)."""
    scene = _scene()
    return dict(scene=scene,
                ref={c: _run("jax", c, scene) for c in CONFIGS
                     if c not in INTERNAL},
                port={c: _run("port", c, scene) for c in CONFIGS})


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_distributed_hybrid_matches_reference(config, dist):
    got = dist["port"][config]["img"]
    assert np.isfinite(got).all()
    if config in LOSSY:
        frame = dist["port"]["frame" if config == "bf16" else "ring"]["img"]
        assert got.shape == frame.shape
        assert not np.array_equal(got, frame), "the wire did not engage"
        assert psnr(got, frame) >= WIRE_FLOOR_DB
        return
    if config in INTERNAL:
        frame = dist["port"]["frame"]["img"]
        np.testing.assert_allclose(got, frame, rtol=0,
                                   atol=1e-6 if config == "ring" else GATE)
        return
    want = dist["ref"][config]["img"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=GATE)
    if config == "temporal":
        for a, b in zip(dist["port"][config]["thr"],
                        dist["ref"][config]["thr"]):
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_distributed_hybrid_schedules_inside_the_port(dist):
    """The reference tests' equalities inside the port: the 2 x 4
    topology within 1e-5 of the flat frame; the frame >= 35 dB from the
    single-device hybrid image and the temporal frames >= 27 dB from the
    histogram frame."""
    port, scene = dist["port"], dist["scene"]
    frame = port["frame"]["img"]
    np.testing.assert_allclose(port["hier"]["img"], frame, atol=GATE,
                               rtol=0)
    assert psnr(port["temporal"]["img"], frame) > 27.0
    # the single-device reference image: march, composite, splat, merge
    cam = tcam.Camera.create(EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                             device=CPU)
    tf = ttf.TransferFunction.ramp(0.05, 0.8, 0.7, device=CPU)
    spec = port["frame"]["spec"]
    vol = tvol.Volume(*(torch.from_numpy(scene[k])
                        for k in ("data", "origin", "spacing")))
    vdi, _, axcam = tsl.generate_vdi_mxu(vol, tf, cam, spec, tcfg.VDIConfig(
        max_supersegments=6, adaptive_iters=2))
    comp = tcomp.composite_vdis(vdi.color[None], vdi.depth[None],
                                tcfg.CompositeConfig(
                                    max_output_supersegments=8,
                                    adaptive_iters=2))
    sp = tsplat.splat_particles(
        torch.from_numpy(scene["pos"]),
        tsplat.speed_colors(torch.from_numpy(scene["vel"])), RADIUS, None,
        spec.ni, spec.nj, STAMP, view=axcam.view, proj=axcam.proj)
    one = np_(thyb.composite_vdi_with_particles(comp, sp))
    assert psnr(frame, one) > 35.0


def test_distributed_hybrid_knobs_and_geometry():
    """A brick map and fragment reuse are inert on the ledger, as the
    reference's step records them; a width the ranks do not split
    raises at build."""
    from scenery_insitu_tpu_torch.parallel.bricks import BrickMap

    scene = _scene()
    cam = tcam.Camera.create(EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                             device=CPU)
    tf = ttf.TransferFunction.ramp(0.05, 0.8, 0.7, device=CPU)
    spec = tsl.make_spec(cam, GRID, tcfg.SliceMarchConfig(scale=2.0),
                         multiple_of=N)
    mesh = tmesh.make_mesh(4, device=CPU)
    tobs.clear_ledger()
    bm = BrickMap.contiguous(16, 4, 8)
    step = tpipe.distributed_hybrid_step_mxu(
        mesh, tf, spec, tcfg.VDIConfig(max_supersegments=6),
        tcfg.CompositeConfig(max_output_supersegments=8,
                             temporal_reuse="ranges"), bricks=bm)
    comps = {e["component"] for e in tobs.ledger()}
    assert {"bricks.partition", "delta.reuse"} <= comps
    img, meta = step(tmesh.shard_volume(torch.from_numpy(scene["data"]),
                                        mesh),
                     torch.from_numpy(scene["origin"]),
                     torch.from_numpy(scene["spacing"]),
                     tpar.shard_particles(torch.from_numpy(scene["pos"]),
                                          mesh),
                     tpar.shard_particles(torch.from_numpy(scene["vel"]),
                                          mesh), cam)
    assert img.shape == (4, spec.nj, spec.ni)
    odd = dataclasses.replace(spec, ni=spec.ni + 1)
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.distributed_hybrid_step_mxu(mesh, tf, odd)


# ------------------------------------------------------------ the sessions


def _overrides(kind, mode="histogram", **extra):
    over = {"render.width": "32", "render.height": "24",
            "slicer.engine": "mxu", "slicer.scale": "1.0",
            "vdi.max_supersegments": "6", "vdi.adaptive_iters": "2",
            "composite.max_output_supersegments": "8",
            "composite.adaptive_iters": "2", "sim.grid": "[16,16,16]",
            "sim.steps_per_frame": "2", "sim.kind": kind,
            "sim.num_particles": "64", "sim.particle_radius": "0.8",
            "vdi.adaptive_mode": mode, "mesh.num_devices": "2"}
    over.update(extra)
    return [f"{k}={v}" for k, v in over.items()]


def _start(kind):
    """The port's start state of a session: the ring (and tracers)."""
    u = np_(tvx.VortexFlow.init_ring(GRID, tvx.VortexParams.create(
        dt=1.0, device=CPU)).u)
    return u, np_(tvx.seed_tracers(GRID, 64, seed=5, device=CPU))


def jax_session(kind, mode="histogram", state=True, **extra):
    sess = jses.InSituSession(jcfg.FrameworkConfig().with_overrides(
        *_overrides(kind, mode, **extra)))
    if state:
        u, tr = _start(kind)
        if kind == "hybrid":
            sess.sim.flow = sess.sim.flow._replace(u=jnp.asarray(u))
            sess.sim.tracers = jnp.asarray(tr)
        else:
            sess.sim.state = sess.sim.state._replace(u=jnp.asarray(u))
    return sess


def port_session(kind, mode="histogram", state=True, **extra):
    sess = tses.InSituSession(tcfg.FrameworkConfig().with_overrides(
        *_overrides(kind, mode, **extra)), device=CPU)
    if state:
        u, tr = _start(kind)
        if kind == "hybrid":
            sess.sim.flow = sess.sim.flow._replace(u=torch.from_numpy(u))
            sess.sim.tracers = torch.from_numpy(tr)
        else:
            sess.sim.state = sess.sim.state._replace(u=torch.from_numpy(u))
    return sess


def _capture(store):
    def sink(index, payload):
        store[index] = payload
    return sink


SESSIONS = [("vortex", "temporal"), ("hybrid", "temporal")]


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """Per case: the reference session's frames 0..3 and its checkpoint
    after frame 1."""
    out = {}
    for kind, mode in SESSIONS:
        frames = {}
        sess = jax_session(kind, mode)
        sess.sinks.append(_capture(frames))
        sess.run(2)
        path = str(tmp_path_factory.mktemp("jhck") / f"{kind}_{mode}.npz")
        jck.save_session(sess, path)
        sess.run(2)
        out[(kind, mode)] = dict(frames=frames, ckpt=path, sess=sess)
    return out


def _frames_close(got, want, frames):
    for i in frames:
        g, w = got[i], want[i]
        assert g["frame"] == w["frame"] == i
        if "vdi_color" in w:
            assert_vdi_close(g["vdi_color"], g["vdi_depth"], w["vdi_color"],
                             w["vdi_depth"], 1e-4, 1e-5)
        else:
            np.testing.assert_allclose(g["image"], np.asarray(w["image"]),
                                       rtol=0, atol=GATE)
        for f in ("view", "projection", "volume_dims", "nw"):
            np.testing.assert_allclose(np_(getattr(g["meta"], f)),
                                       np.asarray(getattr(w["meta"], f)),
                                       atol=1e-6, err_msg=f)
        assert int(g["meta"].index) == i


@pytest.mark.parametrize("kind,mode", SESSIONS)
def test_session_matches_reference(kind, mode, sessions, tmp_path):
    ref = sessions[(kind, mode)]
    got = {}
    sess = port_session(kind, mode)
    sess.sinks.append(_capture(got))
    assert sess.mode == ("hybrid" if kind == "hybrid" else "vdi")
    last = sess.run(4)
    key = "image" if kind == "hybrid" else "vdi_color"
    assert np.isfinite(last[key]).all()
    _frames_close(got, ref["frames"], range(4))
    if mode == "temporal":
        assert set(sess._mxu_thr) == set(ref["sess"]._mxu_thr)
    # the reference's checkpoint resumes in the port ...
    c = port_session(kind, mode, state=False)
    tck.load_session(c, ref["ckpt"])
    tail = {}
    c.sinks.append(_capture(tail))
    c.run(2)
    _frames_close(tail, ref["frames"], (2, 3))
    # ... the port's resumes bit for bit in the port and in the reference
    b = port_session(kind, mode)
    b.run(2)
    path = str(tmp_path / "h.npz")
    tck.save_session(b, path)
    r = port_session(kind, mode, state=False)
    tck.load_session(r, path)
    np.testing.assert_array_equal(r.run(2)[key], got[3][key])
    j = jax_session(kind, mode, state=False)
    jck.load_session(j, path)
    jt = {}
    j.sinks.append(_capture(jt))
    j.run(2)
    _frames_close(got, jt, (2, 3))


def test_hybrid_session_keys_prewarm_and_ledger(tmp_path):
    """Hybrid threshold keys are ("hybrid", axis, sign): both signs of an
    axis checkpoint under distinct tags; a prewarm restores the state; a
    rebalance replans the hybrid step's bands; reuse is inert."""
    sess = port_session("hybrid", "temporal")
    sess.run(1)
    (key,) = list(sess._mxu_thr)
    assert key[0] == "hybrid" and len(key) == 3
    other = (key[0], key[1], -key[2])
    sess._mxu_thr[other] = tuple(x + 0.125 for x in sess._mxu_thr[key])
    sess._mxu_thr[other] = type(sess._mxu_thr[key])(*sess._mxu_thr[other])
    path = str(tmp_path / "k.npz")
    tck.save_session(sess, path)
    b = port_session("hybrid", "temporal", state=False)
    tck.load_session(b, path)
    assert set(b._mxu_thr) == {key, other}
    for k in (key, other):
        assert torch.equal(b._mxu_thr[k].thr, sess._mxu_thr[k].thr)
    thr0 = {k: v for k, v in b._mxu_thr.items()}
    times = b.prewarm_regimes([(2, -1), (0, 1)])
    assert set(times) == {(2, -1), (0, 1)} and b._mxu_thr == thr0
    tobs.clear_ledger()
    s = port_session("hybrid", "histogram", **{
        "composite.temporal_reuse": "ranges",
        "composite.rebalance": "occupancy",
        "composite.rebalance_period": "1", "mesh.num_devices": "4"})
    s.run(2)
    assert any(e["component"] == "delta.reuse" for e in tobs.ledger())


def test_hybrid_entry_points_without_cuda_raise(monkeypatch):
    """``device=None`` means CUDA: the new vortex and hybrid entry points
    raise without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tvx.VortexParams.create(),
        lambda: tvx.VortexFlow.init_ring(GRID),
        lambda: tvx.seed_tracers(GRID, 8),
        lambda: tpipes.hybrid_vortex_frame_step(32, 24, GRID, (2, -1)),
        lambda: tpar.shard_particles(torch.zeros(8, 3),
                                     tmesh.make_mesh(2)),
        lambda: tses.InSituSession(tcfg.FrameworkConfig().with_overrides(
            *_overrides("hybrid"))),
        lambda: tses.InSituSession(tcfg.FrameworkConfig().with_overrides(
            *_overrides("vortex"))),
        lambda: convert.vortex_flow(np.zeros((3, 2, 2, 2)), (1e-3, 0.1)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
