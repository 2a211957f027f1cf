"""Parity of the port's edge-serving tier (``serve/``) with the JAX
package, on the CPU: the served pixels of every tier against the
reference's independent single-camera renders, the server's behaviours
of the reference's ``tests/test_serve.py:94-758`` (the camera-delta
cache, admission and queue sheds, bounded staleness through tile frames
and resync drops, a publisher restart, malformed and garbage clients,
unknown tiers, the derived plane count) with either package's publisher
and client on the wire, viewer-side reprojection, and the entry point.

The scene is ``tests/test_vdi_novel.py``'s: the reference's VDI of the
32^3 blobs, every depth scaled by 1.0007 (``tests/test_torch_novel.py``:
a slab edge on a slice plane flips a sample between the packages). The
server rebuilds the generating camera from the metadata alone; the
reference renders from the same rebuilt camera (the two packages'
rebuilds agree within 1e-6, ``tests/test_torch_novel.py``).
Tolerances: proxy answers within 1e-5 absolute of the reference's
renders; exact answers too, but for at most 0.2 % of the values, with
the image >= 90 dB from the reference's (the port's pixel rays are
within 5e-6 of JAX's, ``tests/test_torch_novel.py``, and on those pixels
the closed-form renderer moves a crossing time across a slab edge: 5 to
7 of 7,680 values here, by up to 6.5e-4, 99.97-115.07 dB); wire answers within one u8 step of the reference's proxy render;
the server's own batches bit for bit its single-camera renders. Not
bitwise across the packages: on this JAX the reference's batched render
is not bitwise its own independent renders (ROADMAP §C). Sockets bind to
random loopback ports; every wait has a deadline."""

import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("zmq")
pytest.importorskip("msgpack")

from scenery_insitu_tpu import config as jcfg  # noqa: E402
from scenery_insitu_tpu.core import camera as jcam  # noqa: E402
from scenery_insitu_tpu.core import transfer as jtf  # noqa: E402
from scenery_insitu_tpu.core import vdi as jvdi  # noqa: E402
from scenery_insitu_tpu.core import volume as jvol  # noqa: E402
from scenery_insitu_tpu.ops import slicer as jsl  # noqa: E402
from scenery_insitu_tpu.ops import vdi_novel as jnv  # noqa: E402
from scenery_insitu_tpu.runtime import streaming as jst  # noqa: E402
from scenery_insitu_tpu.serve import ViewerClient as JClient  # noqa: E402
from scenery_insitu_tpu.serve import ViewerServer as JServer  # noqa: E402
from scenery_insitu_tpu.serve import reproject_planar as jreproject  # noqa
from scenery_insitu_tpu_torch import obs as tobs  # noqa: E402
from scenery_insitu_tpu_torch.config import (FaultConfig,  # noqa: E402
                                             FrameworkConfig, ServeConfig)
from scenery_insitu_tpu_torch.core import camera as tcam  # noqa: E402
from scenery_insitu_tpu_torch.runtime import streaming as tst  # noqa: E402
from scenery_insitu_tpu_torch.serve import (ServeDrop,  # noqa: E402
                                            ViewerClient, ViewerFrame,
                                            ViewerServer, reproject_planar)
from scenery_insitu_tpu_torch.utils.image import psnr  # noqa: E402
from tests.test_torch_pipeline import np_, one_torch_thread  # noqa: E402,F401

CPU = "cpu"
ATOL = 1e-5
EXACT_EDGE_SHARE = 2e-3     # see the module docstring
EXACT_EDGE_DB = 90.0
W, H, NS = 48, 40, 24
SHIFT = 1.0007
EYE0 = (0.1, 0.3, 2.8)
DEADLINE_S = 20.0
SERVE = (f"serve.width={W}", f"serve.height={H}", f"serve.num_slices={NS}",
         "serve.batch_size=8", "serve.buckets=[1,2,4,8]")


def _orbit(yaw, pitch=0.0):
    """A viewer camera about the generating one, in both packages."""
    c = tcam.orbit(tcam.Camera.create(EYE0, fov_y_deg=45.0, near=0.3,
                                      far=10.0, device=CPU), yaw, pitch)
    j = jcam.Camera(*(jnp.asarray(np_(x)) for x in c))
    return c, j


@pytest.fixture(scope="module")
def scene():
    """The reference's VDI (depth-scaled) and metadata as host arrays,
    the spec and camera the reference rebuilds from the metadata, and a
    cache of the reference's renders."""
    vol = jvol.procedural_volume(32, kind="blobs", seed=3)
    jc = jcam.Camera.create(EYE0, fov_y_deg=45.0, near=0.3, far=10.0)
    spec = jsl.make_spec(jc, vol.data.shape, jcfg.SliceMarchConfig(
        matmul_dtype="f32", scale=1.5))
    vdi, meta, _ = jsl.generate_vdi_mxu(
        vol, jtf.for_dataset("procedural"), jc, spec,
        jcfg.VDIConfig(max_supersegments=8, adaptive_iters=2))
    vdi = jvdi.VDI(np.asarray(vdi.color),
                   np.asarray(vdi.depth) * np.float32(SHIFT))
    meta = jvdi.VDIMetadata(*(np.asarray(x) for x in meta))
    jspec = jnv.axis_spec_from_meta(meta, matmul_dtype="f32")
    # the generating camera as the port's server rebuilds it from the
    # metadata (within 1e-6 of the reference's rebuild,
    # tests/test_torch_novel.py), so both packages render from one camera
    axcam = _offline(dict(vdi=vdi, meta=meta)).frame["axcam0"]
    assert axcam._fields == jnv.axis_camera_from_meta(meta, jspec)._fields
    jaxcam = type(jnv.axis_camera_from_meta(meta, jspec))(
        *(jnp.asarray(np_(x)) for x in axcam))
    jproxy = jnv.vdi_to_rgba_volume(jvdi.VDI(jnp.asarray(vdi.color),
                                             jnp.asarray(vdi.depth)),
                                    jaxcam, jspec, num_slices=NS)
    return dict(vdi=vdi, meta=meta, jspec=jspec, jaxcam=jaxcam,
                jproxy=jproxy, ref={})


def _reference(scene, tier, yaw):
    """The reference's independent single-camera render of ``tier``
    (wire: its proxy render), run eagerly."""
    key = ("exact" if tier == "exact" else "proxy", yaw)
    if key not in scene["ref"]:
        _, jc = _orbit(yaw)
        s = scene
        if key[0] == "exact":
            vdi = jvdi.VDI(jnp.asarray(s["vdi"].color),
                           jnp.asarray(s["vdi"].depth))
            fn = lambda c: jnv.render_vdi_exact(   # noqa: E731
                vdi, s["jaxcam"], s["jspec"], c, W, H)
        else:
            spec_new = jsl.make_spec(
                jc, s["jproxy"].data.shape[-3:],
                jcfg.SliceMarchConfig(matmul_dtype="f32", scale=1.0),
                axis_sign=jsl.choose_axis(jc))
            fn = lambda c: jnv.render_vdi_proxy(   # noqa: E731
                s["jproxy"], c, W, H, spec_new)
        s["ref"][key] = np.asarray(fn(jc))
    return scene["ref"][key]


def _offline(scene, *overrides):
    srv = ViewerServer.without_sockets(
        FrameworkConfig().with_overrides(*SERVE, *overrides), device=CPU)
    srv.adopt(scene["vdi"], scene["meta"])
    return srv


YAWS = (0.15, 0.05, -0.1)


@pytest.mark.parametrize("tier", ["exact", "proxy", "wire"])
def test_served_pixels_match_reference_renders(tier, scene):
    """``render_views`` (the render half of ``answer_pending``) of three
    viewers in one batch (a bucket of 4): each answer against the
    reference's independent render of its camera, and bit for bit the
    server's own answer for that camera alone."""
    srv = _offline(scene)
    views = [(tier, _orbit(y)[0]) for y in YAWS]
    out = srv.render_views(views)
    assert srv.stats["batches"] == 1 and srv.stats["batch_cameras"] == 3
    for (got_tier, img), yaw, view in zip(out, YAWS, views):
        assert got_tier == tier
        want = _reference(scene, tier, yaw)
        if tier == "wire":
            assert img.dtype == np.uint8 and img.shape == (4, H, W)
            assert np.abs(img.astype(np.float32) / 255.0 - want).max() \
                <= 1.0 / 255.0 + 1e-6
        elif tier == "exact":
            gap = np.abs(img - want)
            assert (gap > ATOL).mean() <= EXACT_EDGE_SHARE, \
                (gap > ATOL).mean()
            assert psnr(want, img) >= EXACT_EDGE_DB
        else:
            np.testing.assert_allclose(img, want, rtol=0, atol=ATOL)
        alone = srv.render_views([view])[0][1]
        np.testing.assert_array_equal(alone, img)
    assert srv.stats["proxy_builds"] == (0 if tier == "exact" else 1)


def test_socket_free_server_answers_and_caches(scene):
    """A server without sockets takes viewer messages through ``handle``
    and answers into ``outbox``: one batch for 3 viewers whose pixels
    are ``render_views``'s, then the unchanged cameras answered from the
    cache with no render; a hello's welcome and a shed land there too."""
    srv = _offline(scene, "serve.max_viewers=3")
    cams = [tst.make_camera_message(_orbit(y)[0]) for y in YAWS]
    for i, msg in enumerate(cams):
        srv.handle(b"v%d" % i, dict(msg, seq=1, tier="proxy"))
    srv.handle(b"late", {"type": "hello", "tier": "proxy"})
    assert srv.answer_pending() == 3
    assert srv.stats["batches"] == 1 and srv.stats["batch_cameras"] == 3
    shed, *answers = srv.outbox
    assert shed[1]["type"] == "shed" and shed[1]["reason"] == "max_viewers"
    want = srv.render_views([("proxy", _orbit(y)[0]) for y in YAWS])
    for (ident, fields, blob), (_, pix) in zip(answers, want):
        assert fields["type"] == "frame" and not fields["cached"]
        assert blob == pix.tobytes()
    srv.outbox.clear()
    for i, msg in enumerate(cams):
        srv.handle(b"v%d" % i, dict(msg, seq=2))
    assert srv.answer_pending() == 3
    assert srv.stats["cache_hits"] == 3 and srv.stats["batches"] == 2
    assert [f["cached"] and f["seq"] == 2 for _, f, _ in srv.outbox] == \
        [True] * 3
    assert [b for _, _, b in srv.outbox] == [b for _, _, b in answers]


def test_derived_plane_count_matches_reference_server(scene):
    """``serve.num_slices=0`` derives the plane count from the frame's
    own depths: the port's server and the reference's agree, on the
    slice-march VDI and on a gather VDI whose ladder starts far before
    the content (the reference's regression), and the gather VDI is
    served with content."""
    from scenery_insitu_tpu.ops.vdi_gen import generate_vdi

    vol = jvol.procedural_volume(32, kind="blobs", seed=3)
    jc = jcam.Camera.create(EYE0, fov_y_deg=45.0, near=0.3, far=10.0)
    gvdi, gmeta = generate_vdi(vol, jtf.for_dataset("procedural"), jc, 64,
                               48, jcfg.VDIConfig(max_supersegments=6,
                                                  adaptive_iters=2),
                               max_steps=96)
    cfg_over = ("serve.num_slices=0",)
    jsrv = JServer(jcfg.FrameworkConfig().with_overrides(
        *SERVE[:2], *cfg_over), connect="tcp://127.0.0.1:1",
        bind="tcp://127.0.0.1:0")
    try:
        for vdi, meta in ((scene["vdi"], scene["meta"]), (gvdi, gmeta)):
            vdi = jvdi.VDI(np.asarray(vdi.color), np.asarray(vdi.depth))
            meta = jvdi.VDIMetadata(*(np.asarray(x) for x in meta))
            srv = _offline(dict(vdi=vdi, meta=meta), *cfg_over)
            jsrv._adopt(vdi, meta)
            assert srv.frame["num_slices"] == jsrv.frame["num_slices"]
        assert srv.frame["num_slices"] > 24
        img = srv.render_views([("proxy", _orbit(0.1)[0])])[0][1]
        assert float(img[3].max()) > 0.05, "blank proxy frame"
    finally:
        jsrv.close()


# ------------------------------------------------------------ loopback


def _until(fn, srv=None, secs=DEADLINE_S):
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        if srv is not None:
            srv.run_once(timeout_ms=10)
        got = fn()
        if got is not None and got is not False:
            return got
    return None


class _Lost:
    """A publisher socket on which every message is lost."""

    def send_multipart(self, parts):
        pass


class _Loop:
    """A publisher of ``pub_pkg`` feeding the port's server over real
    sockets, with the server's first frame adopted."""

    def __init__(self, scene, *overrides, pub_pkg="ref", publish=True,
                 **pub_kw):
        mod = jst if pub_pkg == "ref" else tst
        self.scene = scene
        self.pub = mod.VDIPublisher("tcp://127.0.0.1:0", codec="zlib",
                                    **pub_kw)
        self.port_pub = pub_pkg == "port"
        self.srv = ViewerServer(
            FrameworkConfig().with_overrides(*SERVE, *overrides),
            connect=self.pub.endpoint, bind="tcp://127.0.0.1:0",
            device=CPU)
        self.clients = []
        if publish:
            assert _until(self.adopt_first), "server never adopted a frame"

    def adopt_first(self, index=0):
        """One attempt at the first frame: a fresh I-frame (a P-frame
        stream's first records go out before the subscription joins)."""
        self.pub.force_iframe()
        self.publish(index)
        return self.srv.pump_stream(50) or None

    def meta(self, i):
        m = self.scene["meta"]._replace(index=np.int32(i))
        return tuple(torch.tensor(np.asarray(x)) for x in m) \
            if self.port_pub else m

    def vdi(self, cols=None):
        v = self.scene["vdi"]
        c, d = (v.color, v.depth) if cols is None else \
            (np.ascontiguousarray(v.color[..., cols]),
             np.ascontiguousarray(v.depth[..., cols]))
        return (torch.tensor(c), torch.tensor(d)) \
            if self.port_pub else jvdi.VDI(c, d)

    def publish(self, i):
        from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata

        if self.port_pub:
            return self.pub.publish(VDI(*self.vdi()),
                                    VDIMetadata(*self.meta(i)))
        return self.pub.publish(self.vdi(), self.meta(i))

    def client(self, tier, pkg="port", **kw):
        c = (ViewerClient if pkg == "port" else JClient)(
            self.srv.endpoint, tier=tier, **kw)
        self.clients.append(c)
        return c

    def answer(self, c):
        return _until(lambda: c.poll(timeout_ms=0), self.srv)

    def close(self):
        for c in self.clients:
            c.close()
        self.srv.close()
        self.pub.close()


def test_loopback_tiers_cache_and_both_clients(scene):
    """A reference publisher feeds the port's server; the port's and the
    reference's clients on three tiers get the server's own renders
    (cached answers bit for bit the first), a sub-tolerance nudge
    re-serves the cache, a move or a tier change re-renders, and the
    wire tier ships 4x fewer bytes."""
    loop = _Loop(scene, "serve.cam_tol=1e-4")
    try:
        cams = {t: _orbit(0.15) for t in ("proxy", "exact", "wire")}
        cs = {t: loop.client(t, pkg="ref" if t == "exact" else "port")
              for t in cams}
        for t, c in cs.items():
            c.hello(timeout_ms=0)
            c.request(cams[t][1] if t == "exact" else cams[t][0])
        def answered():
            for c in cs.values():
                if c.last is None:
                    c.poll(timeout_ms=0)
            return all(c.last is not None for c in cs.values()) or None
        _until(answered, loop.srv)
        frames = {t: c.last for t, c in cs.items()}
        assert all(f is not None for f in frames.values()), frames
        own = loop.srv.render_views([(t, cams[t][0]) for t in cams])
        for (t, f), (_, pix) in zip(frames.items(), own):
            assert f.tier == t and not f.cached
            want = pix.astype(np.float32) / 255.0 if t == "wire" else pix
            np.testing.assert_array_equal(f.image, want)
        assert frames["proxy"].wire_bytes == 4 * frames["wire"].wire_bytes
        c = cs["proxy"]
        cam = cams["proxy"][0]
        c.request(cam)
        f2 = loop.answer(c)
        assert f2.cached and np.array_equal(f2.image, frames["proxy"].image)
        c.request(cam._replace(eye=cam.eye + 5e-5))
        assert loop.answer(c).cached
        c.request(_orbit(0.3)[0])
        f4 = loop.answer(c)
        assert not f4.cached and loop.srv.stats["cache_hits"] == 2
        c.tier = "wire"
        c.hello(timeout_ms=0)
        assert loop.answer(c)["tier"] == "wire"
        c.request(_orbit(0.3)[0])
        f5 = loop.answer(c)
        assert f5.tier == "wire" and not f5.cached
        assert f5.wire_bytes == f4.wire_bytes // 4
    finally:
        loop.close()


def test_admission_queue_sheds_and_garbage_clients(scene):
    """max_viewers sheds a second viewer as a typed answer (ledgered
    ``serve.shed``); requests coalesce latest-wins and a second client
    beyond queue_cap sheds; garbage cameras and malformed messages drop
    on ``serve.client`` without occupying admission; an unknown tier
    degrades to the default on ``serve.tier``."""
    tobs.clear_ledger()
    loop = _Loop(scene, "serve.max_viewers=2", "serve.queue_cap=1")
    try:
        junk = loop.client("proxy")
        junk.sock.send(tst._msgpack().packb(
            {"type": "camera", "eye": "junk", "seq": 1}))
        junk.sock.send(tst._msgpack().packb(
            {"type": "camera", "eye": [0.0, 0.0, 3.0], "fov_y": 0.0,
             "near": 0.0, "far": -1.0, "seq": 2}))
        junk.sock.send(b"\xc1\x00\xff not msgpack")
        junk.sock.send(b"\x00" * (loop.srv.fault.max_message_bytes + 1))
        assert _until(lambda: loop.srv.stats["client_drops"] >= 4 or None,
                      loop.srv)
        assert len(loop.srv.clients) == 0, "junk sender occupies a slot"
        def clients_only(fn):
            """Pump the client socket alone (nothing is answered)."""
            def step():
                loop.srv.pump_clients()
                return fn()
            return step
        c1, c2, c3 = (loop.client(t) for t in ("proxy", "hologram",
                                               "proxy"))
        c1.request(_orbit(0.1)[0])
        c1.request(_orbit(0.2)[0])
        assert _until(clients_only(
            lambda: loop.srv.stats["coalesced"] >= 1 or None))
        assert len(loop.srv.queue) == 1
        c2.hello(timeout_ms=0)
        w = _until(clients_only(lambda: c2.poll(timeout_ms=0)))
        assert isinstance(w, dict) and w["tier"] == "proxy"
        c2.request(_orbit(0.3)[0])
        shed = _until(clients_only(lambda: c2.poll(timeout_ms=0)))
        assert isinstance(shed, ServeDrop) and shed.reason == "queue_cap"
        f = loop.answer(c1)
        assert isinstance(f, ViewerFrame) and f.seq == 2
        c3.hello(timeout_ms=0)
        shed = loop.answer(c3)
        assert isinstance(shed, ServeDrop) and shed.reason == "max_viewers"
        comps = {e["component"] for e in tobs.ledger()}
        assert {"serve.shed", "serve.client", "serve.tier"} <= comps
    finally:
        loop.close()


def test_staleness_tiles_resync_and_restart(scene):
    """Tiles of newer frames that never complete advance the stream head
    (the answer is stamped stale, its cache hit too, ledgered
    ``serve.stale``); a tile frame joined mid-frame is adopted only
    whole; P-frame records the server cannot patch (resync drops) also
    advance the head; a publisher restart (a new epoch, indices from 1)
    resets the head and the cache. The port's publisher feeds it."""
    tobs.clear_ledger()
    loop = _Loop(scene, "serve.staleness_frames=2", pub_pkg="port",
                 precision="qpack8",
                 delta=tst.DeltaConfig(enabled=True, iframe_period=64))
    try:
        from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata

        srv, pub = loop.srv, loop.pub
        half = VDI(*loop.vdi(slice(0, scene["vdi"].color.shape[-1] // 2)))
        for f in range(1, 6):
            pub.publish_tile(half, VDIMetadata(*loop.meta(f)), 0, 2, 0)
        assert _until(lambda: (srv.newest or 0) >= 5 or None, srv)
        c = loop.client("proxy")
        c.request(_orbit(0.12)[0])
        f1 = loop.answer(c)
        assert isinstance(f1, ViewerFrame) and f1.stale
        c.request(_orbit(0.12)[0])
        f2 = loop.answer(c)
        assert f2.cached and f2.stale
        assert "serve.stale" in {e["component"] for e in tobs.ledger()}
        # a resync stretch: one lost record orphans every later P/SKIP
        sock, pub.sock = pub.sock, _Lost()
        loop.publish(6)
        pub.sock = sock
        for f in range(7, 10):
            loop.publish(f)
        assert _until(lambda: (srv.newest or 0) >= 9 or None, srv)
        assert srv.stats["stream_drops"] >= 1
        # restart: a new epoch, indices from 1, on the same socket
        pub.epoch, pub.seq = pub.epoch ^ 0x5A5A, 0
        assert _until(lambda: loop.adopt_first(1))
        assert srv.frame["index"] == 1 and srv.newest == 1
        c.request(_orbit(0.12)[0])
        f3 = loop.answer(c)
        assert not f3.stale and not f3.cached
    finally:
        loop.close()


def test_client_refuses_bad_answers_and_paces_heartbeats():
    """A frame answer missing its fields, or failing its CRC, is a typed
    drop; ``maybe_heartbeat`` fires only after the period."""
    zmq = tst._zmq()
    router = zmq.Context.instance().socket(zmq.ROUTER)
    port = router.bind_to_random_port("tcp://127.0.0.1")
    c = ViewerClient(f"tcp://127.0.0.1:{port}", tier="proxy",
                     fault=FaultConfig(heartbeat_period_s=0.2))
    try:
        assert not c.maybe_heartbeat()
        time.sleep(0.25)
        assert c.maybe_heartbeat()
        assert router.poll(5000)
        ident, _ = router.recv_multipart()
        blob = np.zeros((4, 2, 2), np.float32).tobytes()
        pack = tst._msgpack().packb
        router.send_multipart([ident, pack(
            {"type": "frame", "shape": [4, 2, 2], "dtype": "f32"}), blob])
        router.send_multipart([ident, pack(
            {"type": "frame", "shape": [4, 2, 2], "dtype": "f32",
             "frame": 0, "seq": 1, "tier": "proxy", "stale": False,
             "cached": False, "crc": 1}), blob])
        kinds = [c.poll(timeout_ms=5000) for _ in range(2)]
        assert [k.kind for k in kinds] == ["malformed", "integrity"]
        assert c.stats["drops"] == 2
    finally:
        c.close()
        router.close(linger=0)


def test_reproject_matches_reference(scene):
    """The viewer-side warp against the reference's on the same image
    and cameras; the identity warp is a no-op."""
    srv = _offline(scene)
    cam0, jc0 = _orbit(0.0)
    img = srv.render_views([("exact", cam0)])[0][1]
    shift = np.float32([0.1, 0.0, 0.0])
    cam1 = cam0._replace(eye=cam0.eye + torch.from_numpy(shift),
                         target=cam0.target + torch.from_numpy(shift))
    jc1 = jc0._replace(eye=jc0.eye + shift, target=jc0.target + shift)
    got = reproject_planar(img, cam0, cam1)
    want = jreproject(img, jc0, jc1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(reproject_planar(img, cam0, cam0), img,
                               atol=1e-3)


def test_serve_config_and_entry_point():
    """An inconsistent buckets/batch_size pair is refused by the server;
    ``python -m scenery_insitu_tpu_torch.serve --device cpu`` serves and
    prints its final stats."""
    bad = FrameworkConfig().with_overrides("serve.buckets=[1,2,4]")
    with pytest.raises(ValueError, match="batch_size"):
        ViewerServer.without_sockets(bad, device=CPU)
    with pytest.raises(ValueError, match="default_tier"):
        ServeConfig(default_tier="fast")
    out = subprocess.run(
        [sys.executable, "-m", "scenery_insitu_tpu_torch.serve",
         "--device", "cpu", "--seconds", "0.3", "--connect",
         "tcp://127.0.0.1:1", "--bind", "tcp://127.0.0.1:0"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "device cpu" in out.stdout and '"final": true' in out.stdout
