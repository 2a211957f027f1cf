"""Parity of the port's plain-image engines with the JAX package, on the
CPU: the plain-image composites, the slice-march pieces of the plain
render (the engine resolution, chunk occupancy, the hittable mask,
``render_slices``, the bilinear sampler, the homography warp with its
nearest-sample depth, ``raycast_mxu``), the distributed plain steps of
both engines over 4 ranks (all_to_all and ring, f32/bf16/qpack8 wires,
frame and waves, a plan, the 2 x 2 topology, the gather step's AO on the
radius-deep halo), the session's gather and plain modes, and the bench
twin on the gather engine.

Both packages get the same numpy-seeded volumes and cameras. Images and
live depths agree within 1e-5 absolute (a lossy wire's image within
60 dB); the committed ``golden_raycast_mxu.png`` is reproduced at
``tests/test_golden.py``'s bar. Each reference run is shared through a
module-scoped fixture."""

import io
import json
import os
import struct
import zlib

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
from scenery_insitu_tpu.ops import composite as jcomp
from scenery_insitu_tpu.ops import slicer as jsl
from scenery_insitu_tpu.parallel import mesh as jmesh
from scenery_insitu_tpu.parallel import pipeline as jpipe
from scenery_insitu_tpu.parallel import topology as jtopo
from scenery_insitu_tpu_torch import bench
from scenery_insitu_tpu_torch import config as tcfg
from scenery_insitu_tpu_torch import obs as tobs
from scenery_insitu_tpu_torch.core import camera as tcam
from scenery_insitu_tpu_torch.core import transfer as ttf
from scenery_insitu_tpu_torch.core import volume as tvol
from scenery_insitu_tpu_torch.io import vdi_io as tio
from scenery_insitu_tpu_torch.models import pipelines as tpipes
from scenery_insitu_tpu_torch.ops import composite as tcomp
from scenery_insitu_tpu_torch.ops import slicer as tsl
from scenery_insitu_tpu_torch.parallel import bricks as tbricks
from scenery_insitu_tpu_torch.parallel import mesh as tmesh
from scenery_insitu_tpu_torch.parallel import pipeline as tpipe
from scenery_insitu_tpu_torch.parallel import topology as ttopo
from scenery_insitu_tpu_torch.runtime import checkpoint as tck
from scenery_insitu_tpu_torch.runtime import session as tses
from scenery_insitu_tpu_torch.utils.image import (decode_png, load_png, psnr,
                                                  to_display)
from tests.golden import make_golden as mg
from tests.test_torch_gather import golden_gap, t_
from tests.test_torch_pipeline import np_
from tests.test_torch_session import _capture, jax_session, port_session

CPU = "cpu"
ATOL = 1e-5
N = 4
W, H, STEPS = 32, 24, 40
BG = (1.0, 0.2, 0.1, 1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs here are loops of small operations: with the
    suite's workers sharing the host, torch's intra-op threads would
    oversubscribe it and every parallel region would wait on them. One
    thread for this module's tests, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_image_close(got, want, atol=ATOL):
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0,
                               atol=atol)


# ------------------------------------------------------------ composites


def test_composite_plain_and_depth_min():
    """Nearest-first alpha-under with the background once, and the
    sort-first pick; empty ranks tie at +inf, two ranks tie at a finite
    depth, so the stable order decides."""
    rng = np.random.default_rng(0)
    img = rng.random((5, 4, 6, 7), dtype=np.float32) * 0.5
    dep = rng.uniform(1.0, 3.0, (5, 6, 7)).astype(np.float32)
    dep[1:3, :2] = np.inf
    dep[3, 3:] = dep[0, 3:]
    dep[:, 5, 6] = np.inf
    got = tcomp.composite_plain(t_(img), t_(dep), BG)
    want = jcomp.composite_plain(jnp.asarray(img), jnp.asarray(dep), BG)
    assert_image_close(got, want, 1e-6)
    gi, gd = tcomp.composite_depth_min(t_(img), t_(dep))
    wi, wd = jcomp.composite_depth_min(jnp.asarray(img), jnp.asarray(dep))
    np.testing.assert_array_equal(np_(gi), np.asarray(wi))
    np.testing.assert_array_equal(np_(gd), np.asarray(wd))


# ------------------------------------------------------------- the slicer


def test_resolve_engine():
    """"auto" is the slice march on every device (the reference picks
    the gather engine off its TPU: a known difference)."""
    assert tsl.resolve_engine("auto") == "mxu"
    assert tsl.resolve_engine("gather") == "gather"
    assert jsl.resolve_engine("gather") == "gather"
    with pytest.raises(ValueError, match="unknown render engine"):
        tsl.resolve_engine("gathr")


@pytest.fixture(scope="module")
def scene():
    """The golden scene in both packages, with the slice-march spec
    (four in-plane tiles) and the reference's plain render."""
    vol = tvol.procedural_volume(mg.GRID, kind="blobs", seed=mg.SEED,
                                 device=CPU)
    jv = jvol.procedural_volume(mg.GRID, kind="blobs", seed=mg.SEED)
    cam = tcam.Camera.create(mg.EYE, fov_y_deg=50.0, near=0.3, far=20.0,
                             device=CPU)
    jc = jcam.Camera.create(mg.EYE, fov_y_deg=50.0, near=0.3, far=20.0)
    sc = dict(matmul_dtype="f32", fold="xla", occupancy_vtiles=4)
    spec = tsl.make_spec(cam, vol.data.shape, tcfg.SliceMarchConfig(**sc))
    jspec = jsl.make_spec(jc, jv.data.shape, jcfg.SliceMarchConfig(**sc))
    jt = jtf.for_dataset("procedural")

    @jax.jit
    def reference(data, eye):
        """Every reference render of the scene, in one compile."""
        v, c = jvol.Volume(data, jv.origin, jv.spacing), jc._replace(eye=eye)
        ax = jsl.make_axis_camera(v, c, jspec)
        inter = jsl.render_slices(v, jt, ax, jspec)
        return dict(
            axcam=ax, inter=inter,
            inter_04=jsl.render_slices(v, jt, ax, jspec, 0.4),
            mxu=jsl.raycast_mxu(v, jt, c, mg.W, mg.H, jspec,
                                background=(1.0, 1.0, 1.0, 1.0)),
            hit=jsl.hittable_mask(v, ax, jspec),
            warp=[jsl.warp_to_camera(inter.image, ax, jspec, c, mg.W, mg.H,
                                     bg)
                  for bg in ((1.0, 1.0, 1.0, 1.0), None)])

    return dict(vol=vol, jvol=jv, cam=cam, jcam=jc, spec=spec, jspec=jspec,
                tf=ttf.for_dataset("procedural", device=CPU), jtf=jt,
                axcam=tsl.make_axis_camera(vol, cam, spec),
                ref=reference(jv.data, jc.eye))


def test_chunk_occupancy_and_hittable_mask(scene):
    s = scene
    assert s["spec"].vtiles == s["jspec"].vtiles == 4
    got = tsl.chunk_occupancy(s["vol"], s["tf"], s["spec"])
    want = jsl.chunk_occupancy(s["jvol"], s["jtf"], s["jspec"])
    np.testing.assert_array_equal(np_(got), np.asarray(want))
    got = tsl.chunk_occupancy_vtiles(s["vol"], s["tf"], s["spec"])
    want = jsl.chunk_occupancy_vtiles(s["jvol"], s["jtf"], s["jspec"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_(g), np.asarray(w))
    mask = tsl.hittable_mask(s["vol"], s["axcam"], s["spec"])
    jmask = np.asarray(s["ref"]["hit"])
    np.testing.assert_array_equal(np_(mask), jmask)
    assert jmask.any() and not jmask.all()


@pytest.mark.parametrize("exit_alpha", [0.999, 0.4])
def test_render_slices_matches_reference(exit_alpha, scene):
    """The chunk-parallel alpha-under with the per-pixel gate, the
    first-hit depth and the occupancy skips (four tiles)."""
    s = scene
    got = tsl.render_slices(s["vol"], s["tf"], s["axcam"], s["spec"],
                            exit_alpha)
    want = s["ref"]["inter" if exit_alpha == 0.999 else "inter_04"]
    assert_image_close(got.image, want.image)
    live = np.isfinite(np.asarray(want.depth))
    assert (np.isfinite(np_(got.depth)) == live).all() and live.any()
    np.testing.assert_allclose(np_(got.depth)[live],
                               np.asarray(want.depth)[live], rtol=0,
                               atol=ATOL)


def test_warp_and_raycast_mxu_match_reference(scene):
    """The bilinear sampler, the homography warp (bilinear, with and
    without the background; nearest for the depth with its -1
    sentinel) and the whole plain render, against the committed golden
    image too."""
    s = scene
    rng = np.random.default_rng(1)
    img = rng.random((3, 5, 6), dtype=np.float32)
    gy = rng.uniform(-1.0, 5.5, (4, 7)).astype(np.float32)
    gx = rng.uniform(-1.0, 6.5, (4, 7)).astype(np.float32)
    assert_image_close(tsl.bilinear_image_sample(t_(img), t_(gy), t_(gx),
                                                 -2.0),
                       jsl.bilinear_image_sample(
                           jnp.asarray(img), jnp.asarray(gy),
                           jnp.asarray(gx), -2.0), 1e-6)
    inter = np.asarray(s["ref"]["inter"].image)
    for bg, want in zip(((1.0, 1.0, 1.0, 1.0), None), s["ref"]["warp"]):
        got = tsl.warp_to_camera(t_(inter), s["axcam"], s["spec"], s["cam"],
                                 mg.W, mg.H, bg)
        assert_image_close(got, want)
    got = tsl.raycast_mxu(s["vol"], s["tf"], s["cam"], mg.W, mg.H,
                          s["spec"], background=(1.0, 1.0, 1.0, 1.0))
    jmxu = s["ref"]["mxu"]
    assert_image_close(got.image, jmxu.image)
    live = np.isfinite(np.asarray(jmxu.depth))
    assert (np.isfinite(np_(got.depth)) == live).all() and live.any()
    np.testing.assert_allclose(np_(got.depth)[live],
                               np.asarray(jmxu.depth)[live], rtol=0,
                               atol=ATOL)
    # the golden config: the default spec (chunk skipping only)
    spec = tsl.make_spec(s["cam"], s["vol"].data.shape,
                         tcfg.SliceMarchConfig(matmul_dtype="f32",
                                               fold="xla"))
    golden = tsl.raycast_mxu(s["vol"], s["tf"], s["cam"], mg.W, mg.H, spec,
                             background=(1.0, 1.0, 1.0, 1.0))
    assert golden_gap(golden.image, "raycast_mxu") <= 3.0


# ------------------------------------------------ the distributed plain steps

PLAN = (6, 2, 4, 4)
GATHER = {
    "a2a": dict(),
    "ring_bf16": dict(exchange="ring", wire="bf16"),
    "qpack8_waves": dict(wire="qpack8", schedule="waves", wave_tiles=2),
    "plan": dict(rebalance="occupancy"),
    "hier_ring": dict(exchange="ring"),
    "ao": dict(),
}
MXU = {
    "a2a": dict(),
    "x_march": dict(),
    "ring_qpack8_waves": dict(exchange="ring", wire="qpack8",
                              schedule="waves", wave_tiles=2),
    "plan": dict(rebalance="occupancy"),
    "hier": dict(),
}
LOSSY = ("ring_bf16", "qpack8_waves", "ring_qpack8_waves")
EYES = {"x_march": (3.8, 0.3, 0.6)}


@pytest.fixture(scope="module")
def dist():
    jv = jvol.procedural_volume(16, kind="blobs", seed=3)
    vol = tvol.procedural_volume(16, kind="blobs", seed=3, device=CPU)
    return dict(
        vol=vol, jvol=jv,
        tf=ttf.TransferFunction.ramp(0.05, 0.8, 0.7, device=CPU),
        jtf=jtf.TransferFunction.ramp(0.05, 0.8, 0.7),
        mesh=tmesh.make_mesh(N, device=CPU), jmesh=jmesh.make_mesh(N),
        thier=ttopo.make_topology_mesh(tcfg.TopologyConfig(num_hosts=2),
                                       tcfg.MeshConfig(num_devices=N),
                                       device=CPU)[0],
        jhier=jtopo.make_topology_mesh(jcfg.TopologyConfig(num_hosts=2),
                                       jcfg.MeshConfig(num_devices=N))[0])


def _cams(name):
    eye = EYES.get(name, (0.3, 0.2, 4.0))
    return (tcam.Camera.create(eye, fov_y_deg=50.0, near=0.5, far=20.0,
                               device=CPU),
            jcam.Camera.create(eye, fov_y_deg=50.0, near=0.5, far=20.0))


def _build(d, name, knobs, port: bool):
    """(mesh, kwargs) of a configuration for one package: the
    reference's plain steps take the composite knobs loose, the port's a
    CompositeConfig."""
    kw = dict(comp_cfg=tcfg.CompositeConfig(**knobs)) if port else \
        dict(knobs)
    if name == "plan":
        kw["plan"] = PLAN
    if name.startswith("hier"):
        kw["topology"] = (tcfg if port else jcfg).TopologyConfig(num_hosts=2)
        return d["thier" if port else "jhier"], kw
    return d["mesh" if port else "jmesh"], kw


def _run_gather(d, name, port: bool):
    m, kw = _build(d, name, GATHER[name], port)
    cfgm = tcfg if port else jcfg
    rc = cfgm.RenderConfig(max_steps=STEPS, background=BG,
                           **(dict(ao_strength=0.8, ao_radius=1)
                              if name == "ao" else {}))
    cam, jc = _cams(name)
    if port:
        step = tpipe.distributed_plain_step(m, d["tf"], W, H, rc, **kw)
        return step(tmesh.shard_volume(d["vol"].data, m), d["vol"].origin,
                    d["vol"].spacing, cam)
    step = jpipe.distributed_plain_step(m, d["jtf"], W, H, rc, **kw)
    return np.asarray(step(jpipe.shard_volume(d["jvol"].data, m),
                           d["jvol"].origin, d["jvol"].spacing, jc))


def _run_mxu(d, name, port: bool):
    m, kw = _build(d, name, MXU[name], port)
    cam, jc = _cams(name)
    sc = dict(matmul_dtype="f32", scale=1.5, fold="xla")
    if port:
        spec = tsl.make_spec(cam, d["vol"].data.shape,
                             tcfg.SliceMarchConfig(**sc), multiple_of=N)
        img, axcam = tpipe.distributed_plain_step_mxu(
            m, d["tf"], spec, **kw)(tmesh.shard_volume(d["vol"].data, m),
                                    d["vol"].origin, d["vol"].spacing, cam)
        return img, tsl.warp_to_camera(img, axcam, spec, cam, W, H, BG)
    spec = jsl.make_spec(jc, d["jvol"].data.shape,
                         jcfg.SliceMarchConfig(**sc), multiple_of=N)
    img, axcam = jpipe.distributed_plain_step_mxu(m, d["jtf"], spec, **kw)(
        jpipe.shard_volume(d["jvol"].data, m), d["jvol"].origin,
        d["jvol"].spacing, jc)
    return np.asarray(img), np.asarray(jsl.warp_to_camera(
        img, axcam, spec, jc, W, H, BG))


def _check(name, got, want):
    if name in LOSSY:
        assert psnr(np_(got), want) >= 60.0, psnr(np_(got), want)
    else:
        assert_image_close(got, want)


@pytest.mark.parametrize("name", list(GATHER))
def test_distributed_plain_step_matches_reference(name, dist):
    got = _run_gather(dist, name, port=True)
    assert got.shape == (4, H, W)
    _check(name, got, _run_gather(dist, name, port=False))


@pytest.mark.parametrize("name", list(MXU))
def test_distributed_plain_step_mxu_matches_reference(name, dist):
    img, warped = _run_mxu(dist, name, port=True)
    jimg, jwarped = _run_mxu(dist, name, port=False)
    _check(name, img, jimg)
    _check(name, warped, jwarped)


def test_plain_schedules_knobs_and_ao(dist):
    """Inside the port the ring and the waves equal the all_to_all frame
    bit for bit; bricks and reuse are inert on the ledger; the mxu plain
    AO needs the pre-shaded march and raises naming A6."""
    d = dist
    cam, _ = _cams("a2a")
    spec = tsl.make_spec(cam, d["vol"].data.shape, tcfg.SliceMarchConfig(
        matmul_dtype="f32", scale=1.5, fold="xla"), multiple_of=N)
    args = (tmesh.shard_volume(d["vol"].data, d["mesh"]), d["vol"].origin,
            d["vol"].spacing, cam)
    rc = tcfg.RenderConfig(max_steps=STEPS)
    base = tpipe.distributed_plain_step(d["mesh"], d["tf"], W, H, rc)(*args)
    base_mxu, _ = tpipe.distributed_plain_step_mxu(d["mesh"], d["tf"],
                                                   spec)(*args)
    for knobs in (dict(exchange="ring"), dict(schedule="waves",
                                              wave_tiles=2)):
        got = tpipe.distributed_plain_step(
            d["mesh"], d["tf"], W, H, rc,
            tcfg.CompositeConfig(**knobs))(*args)
        torch.testing.assert_close(got, base, rtol=0, atol=0)
    got, _ = tpipe.distributed_plain_step_mxu(
        d["mesh"], d["tf"], spec, comp_cfg=tcfg.CompositeConfig(
            exchange="ring", schedule="waves", wave_tiles=2))(*args)
    torch.testing.assert_close(got, base_mxu, rtol=0, atol=0)
    bmap = tbricks.BrickMap(16, N, (0, 3, 1, 2, 2, 0, 3, 1))
    for build in (lambda **k: tpipe.distributed_plain_step(
                      d["mesh"], d["tf"], W, H, **k),
                  lambda **k: tpipe.distributed_plain_step_mxu(
                      d["mesh"], d["tf"], spec, **k)):
        tobs.clear_ledger()
        build(bricks=bmap,
              comp_cfg=tcfg.CompositeConfig(temporal_reuse="ranges"))
        comps = [e["component"] for e in tobs.ledger()]
        assert "bricks.partition" in comps and "delta.reuse" in comps
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tpipe.distributed_plain_step_mxu(
            d["mesh"], d["tf"], spec, tcfg.RenderConfig(ao_strength=0.5))
    assert [tpipe._out_block_index(None, r) for r in range(4)] == \
        [0, 1, 2, 3]
    topo = ttopo.Topology(2, 2, "hosts", "ranks")
    assert [tpipe._out_block_index(topo, r) for r in range(4)] == \
        [0, 2, 1, 3]


# ----------------------------------------------------------- the session

SESSIONS = {
    "gather_vdi": dict(mode="histogram", **{"slicer.engine": "gather"}),
    "plain_mxu": dict(mode="temporal", **{"runtime.generate_vdis": "false"}),
    "plain_gather": dict(mode="histogram", **{
        "runtime.generate_vdis": "false", "slicer.engine": "gather"}),
}
RENDER = {"render.width": "32", "render.height": "24",
          "render.max_steps": "32", "render.background": "[1,1,1,1]"}


def _session_over(name):
    extra = dict(SESSIONS[name])
    return extra.pop("mode"), {**RENDER, **extra}


@pytest.fixture(scope="module")
def sessions():
    """Each mode's reference payloads of frames 0 and 1 over 4 ranks."""
    out = {}
    for name in SESSIONS:
        mode, over = _session_over(name)
        frames = {}
        sess = jax_session(N, mode, **over)
        sess.sinks.append(_capture(frames))
        sess.run(2)
        out[name] = (frames, sess.mode, sess.engine)
    return out


@pytest.mark.parametrize("name", list(SESSIONS))
def test_session_modes_match_reference(name, sessions, tmp_path):
    """Two frames of each mode against the reference's session; the
    plain payload through the PNG, VDI and checkpoint sinks."""
    want, jmode, jengine = sessions[name]
    mode, over = _session_over(name)
    got = {}
    d = str(tmp_path)
    sess = port_session(N, mode, sinks=[_capture(got), tses.png_sink(d),
                                        tses.vdi_sink(d, codec="zlib")],
                        **over)
    sess.sinks.append(tck.checkpoint_sink(d, every=1).bind(sess))
    sess.run(2)
    assert (sess.mode, sess.engine) == (jmode, jengine)
    assert sess.prewarm_regimes([(2, -1)]) == (
        {} if sess.engine == "gather" else {(2, -1): pytest.approx(
            sess.prewarm_regimes([(2, -1)])[(2, -1)], abs=1e9)})
    for i in (0, 1):
        assert sorted(got[i]) == sorted(want[i])
        assert int(got[i]["meta"].index) == i
        if sess.mode == "plain":
            assert_image_close(got[i]["image"], want[i]["image"])
            png = load_png(os.path.join(d, f"frame{i:05d}.png"))
            np.testing.assert_array_equal(png, to_display(got[i]["image"]))
            assert not os.path.exists(tio.dump_path(d, "session", i, "vdi"))
        else:
            np.testing.assert_allclose(got[i]["vdi_color"],
                                       want[i]["vdi_color"], rtol=0,
                                       atol=ATOL)
            live = np.isfinite(want[i]["vdi_depth"])
            assert (np.isfinite(got[i]["vdi_depth"]) == live).all()
            np.testing.assert_allclose(got[i]["vdi_depth"][live],
                                       want[i]["vdi_depth"][live], rtol=0,
                                       atol=ATOL)
            vdi, _ = tio.load_vdi(tio.dump_path(d, "session", i, "vdi"))
            np.testing.assert_array_equal(np.asarray(vdi.color),
                                          got[i]["vdi_color"])
    # the checkpoint of the last frame resumes the same mode
    fresh = port_session(N, mode, state=False, **over)
    tck.load_session(fresh, os.path.join(d, "ckpt_00002.npz"))
    assert fresh.frame_index == 2 and fresh.mode == sess.mode


def test_session_temporal_needs_the_slice_march():
    with pytest.raises(ValueError, match="temporal"):
        port_session(1, "temporal", state=False,
                     **{"slicer.engine": "gather", **RENDER})


# ------------------------------------------- the bench twin, PNGs, devices


def test_bench_gather_engine(monkeypatch, capsys):
    """``SITPU_BENCH_ENGINE=gather`` at a 32^3 grid: the ray march at
    WIDTH x HEIGHT with STEPS samples, the temporal mode downgraded to
    histogram on the ledger as the reference's bench does."""
    tobs.clear_ledger()
    for name, value in (("GRID", "32"), ("ENGINE", "gather"),
                        ("FRAMES", "1"), ("K", "6"), ("WIDTH", "24"),
                        ("HEIGHT", "16"), ("STEPS", "24")):
        monkeypatch.setenv(f"SITPU_BENCH_{name}", value)
    assert bench.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "gray_scott_32c_vdi_fps_24x16_cpu_1chip"
    cfg = out["config"]
    assert (cfg["engine"], cfg["image"], cfg["steps"],
            cfg["adaptive_mode"]) == ("gather", [24, 16], 24, "histogram")
    assert out["occupancy"] is None and out["value"] > 0
    assert any(e["component"] == "bench.adaptive_mode"
               for e in tobs.ledger())
    defaults = bench.bench_config({"SITPU_BENCH_ENGINE": "gather"},
                                  on_card=True)
    assert (defaults["steps"], defaults["width"], defaults["height"]) == \
        (256, 1280, 720)
    with pytest.raises(ValueError, match="unknown render engine"):
        bench.bench_config({"SITPU_BENCH_ENGINE": "nope"}, on_card=False)


def _png_bytes(rows: np.ndarray, kinds, bpp: int) -> bytes:
    """An RGBA PNG whose scanline r is filtered with ``kinds[r]``."""
    h, n = rows.shape
    raw = rows.astype(np.int64)
    out = []
    for y in range(h):
        prior = raw[y - 1] if y else np.zeros(n, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), raw[y, :-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        p = left + prior - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prior, ul))
        pred = [0, left, prior, (left + prior) // 2, paeth][kinds[y]]
        out.append(bytes([kinds[y]]) + bytes(((raw[y] - pred) & 0xFF)
                                            .astype(np.uint8)))
    w = n // bpp
    chunk = lambda k, b: (struct.pack(">I", len(b)) + k + b + struct.pack(
        ">I", zlib.crc32(k + b) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


def test_png_reader():
    """The card's machine has no imaging package: the port reads PNGs
    itself, every scanline filter, the same pixels PIL reads."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (5, 6, 4), dtype=np.uint8)
    data = _png_bytes(img.reshape(5, 24), [0, 1, 2, 3, 4], 4)
    np.testing.assert_array_equal(decode_png(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    for name in ("raycast_gather", "raycast_mxu", "vdi_gather_decode"):
        path = os.path.join(mg.GOLDEN_DIR, f"golden_{name}.png")
        np.testing.assert_array_equal(load_png(path),
                                      np.asarray(Image.open(path)))


def test_entry_points_without_cuda_raise(monkeypatch):
    """``device=None`` means CUDA: the gather frame step and the gather
    and plain sessions raise without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tpipes.grayscott_vdi_frame_step(engine="gather", width=8,
                                                height=8),
        lambda: tses.InSituSession(tcfg.FrameworkConfig().with_overrides(
            "slicer.engine=gather", "vdi.adaptive_mode=histogram")),
        lambda: tses.InSituSession(tcfg.FrameworkConfig().with_overrides(
            "runtime.generate_vdis=false")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
