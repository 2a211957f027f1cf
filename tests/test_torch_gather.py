"""Parity of the port's gather engine with the JAX package, on the CPU:
the volume's voxel map, the camera's rays and projection, trilinear
sampling and the ray/box intersection, the plain raycast (clip and
sample boxes, early exit, AO), the AO fields, VDI generation in every
adaptive mode and the occupancy grid, the gather frame step, and the
gather ``distributed_vdi_step`` over 4 ranks under every exchange
schedule the port composites (all_to_all and ring; f32, bf16 and qpack8
wires; frame and waves; a plan, a brick map, the 2 x 2 topology).

Both packages get the same numpy-seeded volumes and cameras. Colours and
live depths agree within 1e-5 absolute, with the same live slots; a
lossy wire's image within 60 dB of the reference's. The committed
``golden_raycast_gather.png`` and ``golden_vdi_gather_decode.png`` are
reproduced at ``tests/test_golden.py``'s bar. Each reference run is
shared through a module-scoped fixture."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from scenery_insitu_tpu import config as jcfg
from scenery_insitu_tpu.core import camera as jcam
from scenery_insitu_tpu.core import transfer as jtf
from scenery_insitu_tpu.core import volume as jvol
from scenery_insitu_tpu.core.vdi import render_vdi_same_view as jrender
from scenery_insitu_tpu.models import pipelines as jpipes
from scenery_insitu_tpu.ops import ao as jao
from scenery_insitu_tpu.ops import sampling as jsmp
from scenery_insitu_tpu.ops import vdi_gen as jgen
from scenery_insitu_tpu.ops.raycast import raycast as jraycast
from scenery_insitu_tpu.parallel import bricks as jbricks
from scenery_insitu_tpu.parallel import mesh as jmesh
from scenery_insitu_tpu.parallel import pipeline as jpipe
from scenery_insitu_tpu.parallel import topology as jtopo
from scenery_insitu_tpu.sim import grayscott as jgs
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.core.vdi import VDI, render_vdi_same_view
from scenery_insitu_tpu_torch.models import pipelines as tpipes
from scenery_insitu_tpu_torch.ops import ao as tao
from scenery_insitu_tpu_torch.ops import raycast as trc
from scenery_insitu_tpu_torch.ops import sampling as tsmp
from scenery_insitu_tpu_torch.ops import vdi_gen as tgen
from scenery_insitu_tpu_torch.parallel import bricks as tbricks
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from scenery_insitu_tpu_torch.parallel import topology as ttopo
from scenery_insitu_tpu_torch.utils.image import psnr, to_display
from tests.golden import make_golden as mg
from tests.test_torch_pipeline import np_, one_torch_thread  # noqa: F401

CPU = "cpu"
ATOL = 1e-5
N = 4
W, H, STEPS = 32, 24, 40           # the distributed steps' image
EYE = (0.3, 0.2, 4.0)


def t_(x):
    return torch.from_numpy(np.array(x))


def assert_close_vdi(got, want, atol=ATOL):
    """Colours within ``atol``, the same live slots, live depths within
    ``atol``."""
    gc, gd = np_(got.color), np_(got.depth)
    wc, wd = np.asarray(want.color), np.asarray(want.depth)
    np.testing.assert_allclose(gc, wc, rtol=0, atol=atol)
    live = np.isfinite(wd)
    assert (np.isfinite(gd) == live).all(), "live slots differ"
    np.testing.assert_allclose(gd[live], wd[live], rtol=0, atol=atol)


def golden_gap(img, name):
    """Max 8-bit difference of a render against its committed PNG."""
    want = np.asarray(Image.open(os.path.join(
        mg.GOLDEN_DIR, f"golden_{name}.png")), np.float32)
    got = to_display(np_(img)).astype(np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max())


@pytest.fixture(scope="module")
def golden_scene():
    """The golden configs' scene in both packages."""
    return dict(
        vol=tvol.procedural_volume(mg.GRID, kind="blobs", seed=mg.SEED,
                                   device=CPU),
        jvol=jvol.procedural_volume(mg.GRID, kind="blobs", seed=mg.SEED),
        tf=ttf.for_dataset("procedural", device=CPU),
        jtf=jtf.for_dataset("procedural"),
        cam=tcam.Camera.create(mg.EYE, fov_y_deg=50.0, near=0.3, far=20.0,
                               device=CPU),
        jcam=jcam.Camera.create(mg.EYE, fov_y_deg=50.0, near=0.3,
                                far=20.0))


# ------------------------------------------------------ core and sampling


def test_world_to_voxel():
    rng = np.random.default_rng(0)
    data = rng.random((5, 6, 7), dtype=np.float32)
    p = rng.uniform(-1.5, 1.5, (10, 3)).astype(np.float32)
    got = tvol.Volume.centered(data, device=CPU).world_to_voxel(t_(p))
    want = jvol.Volume.centered(data).world_to_voxel(jnp.asarray(p))
    np.testing.assert_array_equal(np_(got), np.asarray(want))


@pytest.mark.parametrize("eye,size", [(mg.EYE, (mg.W, mg.H)),
                                      ((3.8, 0.3, 0.6), (17, 9))])
def test_pixel_rays_and_world_to_ndc(eye, size):
    cam = tcam.Camera.create(eye, fov_y_deg=40.0, device=CPU)
    jc = jcam.Camera.create(eye, fov_y_deg=40.0)
    o, d = tcam.pixel_rays(cam, *size)
    jo, jd = jcam.pixel_rays(jc, *size)
    np.testing.assert_array_equal(np_(o), np.asarray(jo))
    # proj @ view and its f32 inverse differ in the last bits between
    # the two linear-algebra libraries
    np.testing.assert_allclose(np_(d), np.asarray(jd), rtol=0, atol=5e-6)
    np.testing.assert_allclose(np.linalg.norm(np_(d), axis=0), 1.0,
                               atol=1e-6)
    pts = np.random.default_rng(1).uniform(-1, 1, (6, 3)).astype(np.float32)
    view, proj = tcam.view_matrix(cam), tcam.projection_matrix(cam, *size)
    want = jcam.world_to_ndc(jnp.asarray(pts), jcam.view_matrix(jc),
                             jcam.projection_matrix(jc, *size))
    np.testing.assert_allclose(np_(tcam.world_to_ndc(t_(pts), view, proj)),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,dtype", [((6, 5, 7), "f32"),
                                         ((6, 5, 7), "bf16"),
                                         ((1, 4, 1), "f32")])
def test_sample_trilinear(shape, dtype):
    """Clamp-to-edge, centres at +0.5, gathers in the storage dtype and
    the lerp in f32; thin axes take one corner."""
    rng = np.random.default_rng(2)
    data = rng.random(shape, dtype=np.float32)
    pos = rng.uniform(-2.0, 9.0, (40, 3)).astype(np.float32)
    tdata, jdata = t_(data), jnp.asarray(data)
    if dtype == "bf16":
        tdata, jdata = tdata.to(torch.bfloat16), jdata.astype(jnp.bfloat16)
    got = tsmp.sample_trilinear(tdata, t_(pos))
    assert got.dtype == torch.float32
    want = jsmp.sample_trilinear(jdata, jnp.asarray(pos))
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_intersect_aabb():
    """Hits, misses, axis-parallel components (the 1e-12 guard), the
    eye inside the box (tnear clamped to 0)."""
    rng = np.random.default_rng(3)
    dirs = rng.normal(size=(3, 5, 6)).astype(np.float32)
    dirs[0, 0] = 0.0
    dirs[1, 1] = -0.0
    dirs[:, 2, :2] = [[0.0, 0.0], [0.0, 0.0], [1.0, -1.0]]
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    lo = np.array([-0.5, -0.4, -0.3], np.float32)
    hi = np.array([0.6, 0.5, 0.4], np.float32)
    for origin in ((0.2, 0.1, 3.0), (0.0, 0.0, 0.0)):
        o = np.asarray(origin, np.float32)
        got = tsmp.intersect_aabb(t_(o), t_(dirs), t_(lo), t_(hi))
        want = jsmp.intersect_aabb(jnp.asarray(o), jnp.asarray(dirs),
                                   jnp.asarray(lo), jnp.asarray(hi))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np_(g), np.asarray(w))


# ------------------------------------------------------------- raycast

RAYCASTS = {
    "golden": dict(cfg=dict(max_steps=mg.STEPS,
                            background=(1.0, 1.0, 1.0, 1.0))),
    "boxes": dict(cfg=dict(max_steps=48), boxes=True),
    "early_exit": dict(cfg=dict(max_steps=48, early_exit_alpha=0.3)),
    "ao": dict(cfg=dict(max_steps=48, ao_strength=0.8, ao_radius=2)),
}


def _boxes(vol):
    """A clip box (the lower half in z) and the global sample box."""
    mid = float(np.asarray(vol.origin)[2]) + 0.5 * float(
        np.asarray(vol.spacing)[2]) * vol.data.shape[0]
    lo, hi = np.asarray(vol.world_min), np.asarray(vol.world_max)
    return (lo, np.array([hi[0], hi[1], mid], np.float32), lo, hi)


@pytest.mark.parametrize("case", sorted(RAYCASTS))
def test_raycast_matches_reference(case, golden_scene):
    s = golden_scene
    spec = RAYCASTS[case]
    kw, jkw = {}, {}
    if spec.get("boxes"):
        cmin, cmax, smin, smax = _boxes(s["jvol"])
        kw = dict(clip_min=t_(cmin), clip_max=t_(cmax), sample_min=t_(smin),
                  sample_max=t_(smax))
        jkw = {k: jnp.asarray(np_(v)) for k, v in kw.items()}
    got = trc.raycast(s["vol"], s["tf"], s["cam"], mg.W, mg.H,
                      tcfg.RenderConfig(**spec["cfg"]), **kw)
    want = jax.jit(lambda v, c, kw_: jraycast(
        v, s["jtf"], c, mg.W, mg.H,
        jcfg.RenderConfig(**spec["cfg"]), **kw_))(s["jvol"], s["jcam"], jkw)
    np.testing.assert_allclose(np_(got.image), np.asarray(want.image),
                               rtol=0, atol=ATOL)
    live = np.isfinite(np.asarray(want.depth))
    assert (np.isfinite(np_(got.depth)) == live).all() and live.any()
    np.testing.assert_allclose(np_(got.depth)[live],
                               np.asarray(want.depth)[live], rtol=0,
                               atol=ATOL)
    if case == "golden":
        assert golden_gap(got.image, "raycast_gather") <= 3.0
        assert trc.raycast_image(s["vol"], s["tf"], s["cam"], mg.W, mg.H,
                                 tcfg.RenderConfig(**spec["cfg"])
                                 ).shape == (4, mg.H, mg.W)


def test_ao_fields(golden_scene):
    s = golden_scene
    got = tao.ao_field_volume(s["vol"], s["tf"], 3, 0.7)
    want = jax.jit(lambda v: jao.ao_field_volume(v, s["jtf"], 3, 0.7))(
        s["jvol"])
    np.testing.assert_allclose(np_(got.data), np.asarray(want.data),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np_(got.origin), np.asarray(want.origin))
    alpha = np.random.default_rng(4).random((5, 9, 4), dtype=np.float32)
    for r in (0, 1, 4):
        np.testing.assert_allclose(
            np_(tao.occlusion_field(t_(alpha), r, 0.9)),
            np.asarray(jax.jit(lambda a: jao.occlusion_field(a, r, 0.9))(
                jnp.asarray(alpha))), rtol=0, atol=1e-6)
    got = tao.shade_volume_ao(s["vol"], s["tf"], 3, 0.7)
    want = jax.jit(lambda v: jao.shade_volume_ao(v, s["jtf"], 3, 0.7))(
        s["jvol"])
    assert tuple(got.data.shape) == (4,) + tuple(s["vol"].data.shape)
    np.testing.assert_allclose(np_(got.data), np.asarray(want.data),
                               rtol=0, atol=1e-6)


# ------------------------------------------------------- VDI generation

GEN_MODES = {
    "golden": dict(max_supersegments=mg.K, adaptive_iters=4),
    "histogram": dict(max_supersegments=5, adaptive_mode="histogram",
                      histogram_bins=8),
    "fixed": dict(max_supersegments=4, adaptive=False, threshold=0.05),
}


@pytest.fixture(scope="module")
def generated(golden_scene):
    """Each mode's reference VDI and metadata."""
    s = golden_scene
    return {m: jax.jit(lambda v, cam, c=c: jgen.generate_vdi(
        v, s["jtf"], cam, mg.W, mg.H, jcfg.VDIConfig(**c),
        max_steps=mg.STEPS, frame_index=3))(s["jvol"], s["jcam"])
        for m, c in GEN_MODES.items()}


@pytest.mark.parametrize("mode", sorted(GEN_MODES))
def test_generate_vdi_matches_reference(mode, golden_scene, generated):
    s = golden_scene
    vdi, meta = tgen.generate_vdi(s["vol"], s["tf"], s["cam"], mg.W, mg.H,
                                  tcfg.VDIConfig(**GEN_MODES[mode]),
                                  max_steps=mg.STEPS, frame_index=3)
    jv, jmeta = generated[mode]
    assert_close_vdi(vdi, jv)
    for f in ("projection", "view", "model", "volume_dims", "window_dims",
              "nw", "index"):
        np.testing.assert_allclose(np_(getattr(meta, f)),
                                   np.asarray(getattr(jmeta, f)), atol=1e-6,
                                   err_msg=f)
    if mode == "golden":
        img = render_vdi_same_view(vdi, background=(1.0, 1.0, 1.0, 1.0))
        assert golden_gap(img, "vdi_gather_decode") <= 3.0
    if mode == "histogram":
        tnear = torch.full((mg.H, mg.W), 2.0)
        tfar = torch.full((mg.H, mg.W), 3.5)
        tfar[0, 0] = torch.inf
        for cell, bins in ((8, None), (4, 3)):
            got = tgen.occupancy_grid(vdi, tnear, tfar, cell, bins)
            want = jgen.occupancy_grid(jv, jnp.asarray(np_(tnear)),
                                       jnp.asarray(np_(tfar)), cell, bins)
            np.testing.assert_array_equal(np_(got), np.asarray(want))


def test_generate_vdi_temporal_raises(golden_scene):
    s = golden_scene
    with pytest.raises(ValueError, match="temporal"):
        tgen.generate_vdi(s["vol"], s["tf"], s["cam"], 8, 6,
                          tcfg.VDIConfig(adaptive_mode="temporal"))


def test_gather_frame_step_matches_reference():
    """Two frames of the gather frame step (16^3 Gray-Scott, histogram)
    against the reference's."""
    grid, w, h = 16, 24, 18
    kw = dict(sim_steps=2, max_steps=32,
              fov_y_deg=50.0, engine="gather")
    vc = dict(max_supersegments=6, adaptive_mode="histogram",
              histogram_bins=8)
    cc = dict(max_output_supersegments=8)
    step = tpipes.grayscott_vdi_frame_step(
        width=w, height=h, vdi_cfg=tcfg.VDIConfig(**vc),
        comp_cfg=tcfg.CompositeConfig(**cc), device=CPU, **kw)
    jstep = jax.jit(jpipes.grayscott_vdi_frame_step(
        w, h, vdi_cfg=jcfg.VDIConfig(**vc),
        comp_cfg=jcfg.CompositeConfig(**cc), **kw))
    st = jgs.GrayScott.init((grid,) * 3, seed=0)
    rng = np.random.default_rng(5)
    u = (np.asarray(st.u) + rng.normal(0, 1e-3, st.u.shape)).astype(
        np.float32)
    v = (np.asarray(st.v) + rng.normal(0, 1e-3, st.v.shape)).astype(
        np.float32)
    tu, tv, ju, jv = t_(u), t_(v), jnp.asarray(u), jnp.asarray(v)
    for yaw in (0.0, 0.2):
        eye = np.array([3.0 * np.sin(yaw), 0.6, 3.0 * np.cos(yaw)],
                       np.float32)
        c, d, tu, tv = step(tu, tv, t_(eye))
        jc, jd, ju, jv = jstep(ju, jv, jnp.asarray(eye))
        assert_close_vdi(VDI(c, d), VDI(jc, jd))
        np.testing.assert_allclose(np_(tv), np.asarray(jv), rtol=0,
                                   atol=1e-6)
    assert torch.isfinite(d[:, 0]).any()


# ------------------------------------------- the distributed gather step

VC = dict(max_supersegments=6, adaptive_mode="histogram", histogram_bins=8)
PLAN = (6, 2, 4, 4)
# against the reference; the lossless ring and the waves alone equal the
# all_to_all frame inside the port (test_distributed_vdi_schedules_...)
DIST = {
    "a2a": dict(),
    "ring_cap_waves": dict(exchange="ring", ring_slots=8, schedule="waves",
                           wave_tiles=2),
    "bf16": dict(wire="bf16"),
    "qpack8": dict(wire="qpack8", exchange="ring"),
    "plan": dict(rebalance="occupancy"),
    "bricks": dict(rebalance="bricks"),
    "hier": dict(),
}
LOSSY = ("bf16", "qpack8")


def _dist_args(name):
    if name == "plan":
        return dict(plan=PLAN), dict(plan=PLAN)
    if name == "bricks":
        owner, level = (0, 3, 1, 2, 2, 0, 3, 1), (1, 0, 0, 0, 0, 0, 0, 0)
        return (dict(bricks=tbricks.BrickMap(16, N, owner, level)),
                dict(bricks=jbricks.BrickMap(16, N, owner, level)))
    if name == "hier":
        return (dict(topology=tcfg.TopologyConfig(num_hosts=2)),
                dict(topology=jcfg.TopologyConfig(num_hosts=2)))
    return {}, {}


@pytest.fixture(scope="module")
def dist_scene():
    data = jvol.procedural_volume(16, kind="blobs", seed=3)
    vol = tvol.procedural_volume(16, kind="blobs", seed=3, device=CPU)
    jm = jmesh.make_mesh(N)
    return dict(
        vol=vol, jvol=data, tf=ttf.TransferFunction.ramp(0.05, 0.8, 0.7,
                                                         device=CPU),
        jtf=jtf.TransferFunction.ramp(0.05, 0.8, 0.7),
        cam=tcam.Camera.create(EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                               device=CPU),
        jcam=jcam.Camera.create(EYE, fov_y_deg=50.0, near=0.5, far=20.0),
        mesh=tmesh.make_mesh(N, device=CPU), jmesh=jm,
        jhier=jtopo.make_topology_mesh(jcfg.TopologyConfig(num_hosts=2),
                                       jcfg.MeshConfig(num_devices=N))[0],
        thier=ttopo.make_topology_mesh(tcfg.TopologyConfig(num_hosts=2),
                                       tcfg.MeshConfig(num_devices=N),
                                       device=CPU)[0],
        cache={})


def _reference_vdi(s, name):
    if name not in s["cache"]:
        _, jkw = _dist_args(name)
        jm = s["jhier"] if name == "hier" else s["jmesh"]
        step = jpipe.distributed_vdi_step(
            jm, s["jtf"], W, H, jcfg.VDIConfig(**VC),
            jcfg.CompositeConfig(max_output_supersegments=8,
                                 **DIST[name]), max_steps=STEPS, **jkw)
        out = step(jpipe.shard_volume(s["jvol"].data, jm), s["jvol"].origin,
                   s["jvol"].spacing, s["jcam"])
        s["cache"][name] = jax.tree_util.tree_map(np.asarray, out)
    return s["cache"][name]


def _port_vdi(s, name, **over):
    kw, _ = _dist_args(name)
    m = s["thier"] if name == "hier" else s["mesh"]
    step = tpipe.distributed_vdi_step(
        m, s["tf"], W, H, tcfg.VDIConfig(**VC),
        tcfg.CompositeConfig(max_output_supersegments=8,
                             **{**DIST[name], **over}),
        max_steps=STEPS, **kw)
    return step(tmesh.shard_volume(s["vol"].data, m), s["vol"].origin,
                s["vol"].spacing, s["cam"])


@pytest.mark.parametrize("name", list(DIST))
def test_distributed_vdi_step_matches_reference(name, dist_scene):
    s = dist_scene
    tobs.clear_ledger()
    got = _port_vdi(s, name)
    assert got.color.shape == (8, 4, H, W)
    want = _reference_vdi(s, name)
    if name in LOSSY:
        q = psnr(np_(render_vdi_same_view(got)),
                 np.asarray(jrender(VDI(*want))))
        assert q >= 60.0, q
    else:
        assert_close_vdi(got, want)
    assert np.isfinite(np_(got.depth)[:, 0]).any()
    if name == "bricks":
        # the level map samples at level 0, on the ledger
        assert any(e["component"] == "lod.engine" for e in tobs.ledger())


def test_distributed_vdi_schedules_equal_the_frame(dist_scene):
    """Inside the port the lossless ring and the waves equal the
    all_to_all frame bit for bit, and the even-convex map and the even
    plan take the slab path."""
    s = dist_scene
    base = _port_vdi(s, "a2a")
    for over in (dict(exchange="ring"),
                 dict(schedule="waves", wave_tiles=2)):
        got = _port_vdi(s, "a2a", **over)
        for a, b in zip(got, base):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    even = tpipe.distributed_vdi_step(
        s["mesh"], s["tf"], W, H, tcfg.VDIConfig(**VC),
        tcfg.CompositeConfig(max_output_supersegments=8,
                             rebalance="bricks"), max_steps=STEPS,
        bricks=tbricks.BrickMap.contiguous(16, N, 8))
    got = even(tmesh.shard_volume(s["vol"].data, s["mesh"]),
               s["vol"].origin, s["vol"].spacing, s["cam"])
    for a, b in zip(got, base):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_distributed_vdi_brick_ownership_invariance(dist_scene):
    """A brick's fragments do not depend on which rank owns it: a map
    in which rank 3 owns no brick (its slots absent) gives the frame of
    a map that spreads the same bricks over every rank, bit for bit,
    under a transfer function opaque at 0, which an absent slot's
    zero-filled band would add again if it were marched."""
    s = dist_scene
    tf0 = ttf.TransferFunction.points([(0.0, 0.05), (0.8, 0.7)],
                                      colormap="viridis", device=CPU)
    args = (tmesh.shard_volume(s["vol"].data, s["mesh"]), s["vol"].origin,
            s["vol"].spacing, s["cam"])
    outs = []
    for owner in ((0, 3, 1, 2, 2, 0, 3, 1), (0, 1, 1, 2, 2, 0, 1, 1)):
        step = tpipe.distributed_vdi_step(
            s["mesh"], tf0, W, H, tcfg.VDIConfig(**VC),
            tcfg.CompositeConfig(max_output_supersegments=8,
                                 rebalance="bricks"), max_steps=STEPS,
            bricks=tbricks.BrickMap(16, N, owner))
        outs.append(step(*args))
    assert (np_(outs[0].color)[:, 3] > 0).any()
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_distributed_vdi_step_knobs_and_geometry(dist_scene):
    """The K budget and fragment reuse are inert here, on the ledger as
    the reference records them; a width the ranks cannot split raises;
    the build markers count as the mxu step's."""
    s = dist_scene
    tobs.clear_ledger()
    rec = tobs.Recorder(enabled=True)
    prev = tobs.set_recorder(rec)
    try:
        tpipe.distributed_vdi_step(
            s["mesh"], s["tf"], W, H, tcfg.VDIConfig(**VC),
            tcfg.CompositeConfig(k_budget="occupancy",
                                 temporal_reuse="ranges", exchange="ring",
                                 wire="qpack8", schedule="waves",
                                 wave_tiles=2))
    finally:
        tobs.set_recorder(prev)
    comps = {e["component"] for e in tobs.ledger()}
    assert {"occupancy.k_budget", "delta.reuse"} <= comps
    assert rec.counters["wave_schedule_builds"] == 1
    assert rec.counters["ring_exchange_builds"] == 1
    assert rec.counters["ring_steps_built"] == N - 1
    assert rec.counters["wire_encode_builds"] == 1
    with pytest.raises(ValueError, match="divisible"):
        tpipe.distributed_vdi_step(s["mesh"], s["tf"], 30, H)
