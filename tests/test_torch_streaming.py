"""Parity of the port's streaming edges with the JAX package, on the CPU:
the VDI stream (``runtime/streaming``) both ways across the packages,
the steering endpoint, publisher and relay, the sessions' steering drain,
the video sinks with the I_PCM H.264 writer (``io/h264``), the head node
(``runtime/head``) and the render benchmark tools (``runtime/benchmark``).

The wire cases (the reference's ``tests/test_streaming.py`` and
``tests/test_delta.py:264-438``) hand each publisher's exact multipart
messages to the other package's subscriber, so they need no socket
timing: plain and qpack8 frames, tiles through the assembler, P-frame
sequences, a mid-stream join, corrupt, truncated, malformed and stale
messages. Lossless codecs decode bit for bit across the packages, and
the publishers' blobs are byte-identical. One loopback each way crosses
real sockets. Sockets bind to random loopback ports and every receive
has a deadline."""

import os
import time

import numpy as np
import pytest
import torch

pytest.importorskip("zmq")
pytest.importorskip("msgpack")

from scenery_insitu_tpu.config import DeltaConfig as JDelta  # noqa: E402
from scenery_insitu_tpu.core import camera as jcam  # noqa: E402
from scenery_insitu_tpu.core import vdi as jvdi  # noqa: E402
from scenery_insitu_tpu.io import h264 as jh264  # noqa: E402
from scenery_insitu_tpu.runtime import benchmark as jbench  # noqa: E402
from scenery_insitu_tpu.runtime import head as jhead  # noqa: E402
from scenery_insitu_tpu.runtime import streaming as jst  # noqa: E402
from scenery_insitu_tpu_torch.config import DeltaConfig  # noqa: E402
from scenery_insitu_tpu_torch.core import camera as tcam  # noqa: E402
from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata  # noqa: E402
from scenery_insitu_tpu_torch.io import h264 as th264  # noqa: E402
from scenery_insitu_tpu_torch.ops.composite import \
    composite_depth_min  # noqa: E402
from scenery_insitu_tpu_torch.ops.wire import (  # noqa: E402
    qpack8_dequantize_np, qpack8_quantize_np)
from scenery_insitu_tpu_torch.runtime import benchmark as tbench  # noqa: E402
from scenery_insitu_tpu_torch.runtime import head as thead  # noqa: E402
from scenery_insitu_tpu_torch.runtime import streaming as tst  # noqa: E402
from tests.test_torch_pipeline import one_torch_thread  # noqa: E402,F401

K, H, W = 3, 12, 16
DEADLINE_S = 10.0


def _frames(n=6, seed=3):
    """Seeded VDI frames: 1-2 repeat 0 (SKIP), 3 changes a corner."""
    rng = np.random.default_rng(seed)
    c = rng.random((K, 4, H, W), dtype=np.float32)
    d = np.sort(rng.random((K, 2, H, W), dtype=np.float32), axis=1)
    d[:, :, :2, :3] = np.inf
    out = []
    for i in range(n):
        ci = c.copy()
        if i >= 3:
            ci[:, :, :4, :4] = 0.9
        out.append((ci, d.copy()))
    return out


def _meta(i, port=True):
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = -3.0
    if port:
        return VDIMetadata.create(torch.eye(4), torch.from_numpy(view),
                                  volume_dims=(8, 8, 8), window_dims=(W, H),
                                  nw=0.1, index=i)
    return jvdi.VDIMetadata.create(np.eye(4), view, volume_dims=(8, 8, 8),
                                   window_dims=(W, H), nw=0.1, index=i)


def _vdi(c, d, port=True):
    return VDI(torch.from_numpy(c), torch.from_numpy(d)) if port \
        else jvdi.VDI(c, d)


class _Capture:
    """Stands in for a publisher's socket: keeps each multipart message
    (the exact wire bytes) instead of sending it."""

    def __init__(self):
        self.sent = []

    def send_multipart(self, parts):
        self.sent.append([bytes(p) for p in parts])

    def send(self, data):
        self.sent.append([bytes(data)])

    def close(self, linger=0):
        pass


PKG = {"port": (tst, DeltaConfig, True), "ref": (jst, JDelta, False)}
DIRECTIONS = [("port", "ref"), ("ref", "port")]


def _pub(name, **kw):
    mod, delta_cls, _ = PKG[name]
    if "delta" in kw:
        kw["delta"] = delta_cls(enabled=True, iframe_period=kw["delta"])
    pub = mod.VDIPublisher("tcp://127.0.0.1:0", **kw)
    pub.sock.close(linger=0)
    pub.sock = _Capture()
    return pub


def _sub(name):
    return PKG[name][0].VDISubscriber("tcp://127.0.0.1:1")


def _publish(pub, name, i, c, d, tiles=None):
    port = PKG[name][2]
    if tiles is None:
        pub.publish(_vdi(c, d, port), _meta(i, port))
        return
    wb = W // tiles
    for t in range(tiles):
        sl = slice(t * wb, (t + 1) * wb)
        pub.publish_tile(_vdi(np.ascontiguousarray(c[..., sl]),
                              np.ascontiguousarray(d[..., sl]), port),
                         _meta(i, port), t, tiles, t * wb)


def _decoded(got):
    assert got is not None and not hasattr(got, "kind"), got
    vdi, meta = got[0], got[1]
    return (np.asarray(vdi.color), np.asarray(vdi.depth),
            int(np.asarray(meta.index)))


def _qpack(c, d):
    qc, qd, near, far = qpack8_quantize_np(c, d)
    return qpack8_dequantize_np(qc, qd, near, far)


@pytest.mark.parametrize("src,dst", DIRECTIONS)
@pytest.mark.parametrize("case", ["f32", "qpack8", "tiles", "delta",
                                  "delta_tiles"])
def test_stream_wire_parity(src, dst, case):
    """Each publisher's messages decode in the other package's subscriber
    to the frames sent (f32: bit for bit; qpack8 and its P-frames: bit
    for bit the quantize-dequantize of the frame), tile streams through
    the subscriber's assembler; the two publishers' blobs are the same
    bytes, and a second subscriber of the sender's own package decodes
    the same arrays."""
    kw = dict(codec="zlib", epoch=5)
    if case != "f32":
        kw["precision"] = "qpack8"
    if case.startswith("delta"):
        kw["delta"] = 2
    tiles = 4 if case.endswith("tiles") else None
    pub, twin = _pub(src, **kw), _pub(dst, **kw)
    sub, own = _sub(dst), _sub(src)
    frames = _frames()
    try:
        for i, (c, d) in enumerate(frames):
            _publish(pub, src, i, c, d, tiles)
            _publish(twin, dst, i, c, d, tiles)
        assert len(pub.sock.sent) == len(twin.sock.sent)
        for a, b in zip(pub.sock.sent, twin.sock.sent):
            assert a[1:] == b[1:]                 # the blobs, byte for byte
        asm = [PKG[n][0].FrameAssembler(window=4) for n in (dst, src)]
        got = []
        for parts in pub.sock.sent:
            out, mine = (_assembled(a, s_._decode(parts))
                         for a, s_ in zip(asm, (sub, own)))
            if out is not None:
                got.append((_decoded(out), _decoded(mine)))
        assert [g[0][2] for g in got] == list(range(len(frames)))
        for (c, d), (theirs, mine) in zip(frames, got):
            want = (c, d) if case == "f32" else _qpack(c, d) if not tiles \
                else tuple(np.concatenate(p, axis=-1) for p in zip(*(
                    _qpack(np.ascontiguousarray(c[..., t * 4:t * 4 + 4]),
                           np.ascontiguousarray(d[..., t * 4:t * 4 + 4]))
                    for t in range(tiles))))
            for x, y, z in zip(theirs[:2], mine[:2], want):
                np.testing.assert_array_equal(x, z)
                np.testing.assert_array_equal(y, z)
        if case.startswith("delta"):
            assert pub.delta_stats["skip"] >= 2
            assert pub.delta_stats == twin.delta_stats
    finally:
        for s in (pub, twin, sub, own):
            s.close()


def _assembled(asm, got):
    """A subscriber's decode through an assembler (what ``receive``
    does): a whole frame, or None while a tile frame is incomplete."""
    if got is None or hasattr(got, "kind"):
        return got
    return asm.add(*got)


def test_socket_free_publisher_outbox():
    """A publisher made without a socket keeps each message's header
    fields and blobs in ``outbox``: packed as the socket would send them,
    the reference's subscriber decodes them (P-frames too) to the
    frames' qpack8 codes, and the heartbeat keeps its place in the
    sequence."""
    import msgpack

    pub = tst.VDIPublisher(None, codec="zlib", epoch=4, precision="qpack8",
                           delta=DeltaConfig(enabled=True, iframe_period=3))
    frames = _frames()
    for i, (c, d) in enumerate(frames):
        _publish(pub, "port", i, c, d)
    pub.heartbeat()
    sub = _sub("ref")
    try:
        assert pub.endpoint is None and len(pub.outbox) == len(frames) + 1
        for i, (fields, cb, db) in enumerate(pub.outbox[:-1]):
            assert fields["seq"] == i + 1
            got = _decoded(sub._decode([msgpack.packb(fields), cb, db]))
            for x, z in zip(got[:2], _qpack(*frames[i])):
                np.testing.assert_array_equal(x, z)
        hb = pub.outbox[-1]
        assert hb[0]["hb"] == 1 and hb[0]["seq"] == len(frames) + 1
        assert sub._decode([msgpack.packb(hb[0])]) is jst._HEARTBEAT
        assert pub.delta_stats["skip"] >= 2
    finally:
        pub.close()
        sub.close()


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_stream_typed_drops_and_mid_stream_join(src, dst):
    """A join at a P record is a ``resync`` drop until the next I-tile;
    a flipped byte is an ``integrity`` drop, a missing part a truncated
    one, a garbage header ``malformed``, a replayed message ``stale``;
    a heartbeat never surfaces. The subscriber's verdicts and stats are
    the other package's."""
    pub = _pub(src, codec="zlib", epoch=9, precision="qpack8", delta=3)
    frames = _frames(n=9)
    try:
        for i, (c, d) in enumerate(frames[:7]):
            _publish(pub, src, i, c, d)
        pub.heartbeat()
        for i, (c, d) in enumerate(frames[7:], start=7):
            _publish(pub, src, i, c * (0.5 + 0.1 * i), d)
        msgs = pub.sock.sent
        corrupt = list(msgs[8])
        corrupt[1] = bytes(b ^ 0xFF if k == 3 else b
                           for k, b in enumerate(corrupt[1]))
        bad = [corrupt, msgs[9][:2], [b"\xc1junk", b"", b""], msgs[4]]
        verdicts = {}
        for name in (dst, src):
            sub = _sub(name)
            try:
                out = []
                # join after the first I (frame 0): 1, 2 are SKIP/P
                for parts in msgs[1:8] + bad:
                    got = sub._decode(parts)
                    out.append("hb" if got is jst._HEARTBEAT
                               or got is tst._HEARTBEAT
                               else got.kind if hasattr(got, "kind")
                               else int(np.asarray(got[1].index)))
                verdicts[name] = (out, dict(sub.stats))
            finally:
                sub.close()
        assert verdicts[dst] == verdicts[src]
        out = verdicts[dst][0]
        assert out[:2] == ["resync", "resync"] and 3 in out, out
        assert out[-5:] == ["hb", "integrity", "integrity", "malformed",
                            "stale"], out
    finally:
        pub.close()


def _until(fn, deadline_s=DEADLINE_S):
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        got = fn()
        if got:
            return got
    return None


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_stream_loopback_over_sockets(src, dst):
    """Real PUB/SUB sockets, each way: the frame arrives bit for bit."""
    smod, port_src = PKG[src][0], PKG[src][2]
    pub = smod.VDIPublisher("tcp://127.0.0.1:0", codec="zstd")
    sub = PKG[dst][0].VDISubscriber(pub.endpoint)
    c, d = _frames(n=1)[0]
    try:
        def once():
            pub.publish(_vdi(c, d, port_src), _meta(7, port_src))
            return sub.receive(timeout_ms=100)
        got = _until(once)
        color, depth, idx = _decoded(got)
        np.testing.assert_array_equal(color, c)
        np.testing.assert_array_equal(depth, d)
        assert idx == 7
    finally:
        pub.close()
        sub.close()


def test_steering_endpoint_publisher_and_relay():
    """The port's relay fans a viewer's messages out to a renderer's
    endpoint; a reference viewer talks to a port endpoint; oversized and
    unparseable messages drop on the ``stream.steering`` ledger."""
    relay = tst.SteeringRelay("tcp://127.0.0.1:0", "tcp://127.0.0.1:0")
    viewer = tst.SteeringPublisher(relay.upstream)
    renderer = tst.SteeringEndpoint(relay.downstream, bind=False)
    ep = tst.SteeringEndpoint("tcp://127.0.0.1:0")
    jviewer = jst.SteeringPublisher(ep.endpoint)
    try:
        kinds = set()

        def relayed():
            viewer.send(tst.make_camera_message(
                tcam.Camera.create((9.0, 0.0, 0.0), device="cpu")))
            viewer.send({"type": "record", "on": True})
            time.sleep(0.02)
            relay.pump()
            kinds.update(g["type"] for g in renderer.drain())
            return kinds == {"camera", "record"}
        assert _until(relayed)

        got = []

        def direct():
            jviewer.send(jst.make_camera_message(
                jcam.Camera.create((0.0, 0.0, 9.0))))
            jviewer.send({"hb": 1})
            jviewer.sock.send(b"\xc1")                       # unparseable
            jviewer.sock.send(b"\x01" * (ep.fault.max_message_bytes + 1))
            time.sleep(0.02)
            got.extend(ep.drain())
            return got and ep.stats["dropped"] >= 2
        assert _until(direct)
        assert got[0]["eye"] == [0.0, 0.0, 9.0]
        assert ep.stats["heartbeats"] >= 1
    finally:
        for s in (viewer, renderer, relay, ep, jviewer):
            s.close()


def test_session_drains_steering_endpoint():
    """The session's ``drain_steering`` applies a viewer's camera and
    hands other kinds to ``on_steer``: the reference's
    ``test_session_applies_steering`` on the port's session."""
    from tests.test_torch_session import port_session

    sess = port_session(1, "temporal", state=False)
    sess.orbit_rate = 0.0
    ep = tst.SteeringEndpoint("tcp://127.0.0.1:0")
    viewer = tst.SteeringPublisher(ep.endpoint)
    sess.steering = ep
    seen = []
    sess.on_steer.append(seen.append)
    try:
        def steered():
            viewer.send(tst.make_camera_message(
                tcam.Camera.create((0.0, 0.0, 9.0), device="cpu")))
            viewer.send({"type": "record", "on": True})
            time.sleep(0.05)
            sess.run(1)
            return float(sess.camera.eye[2]) == 9.0
        assert _until(steered)
        assert any(m.get("type") == "record" for m in seen)
    finally:
        viewer.close()
        ep.close()


def test_stream_sinks_publish_session_frames():
    """``stream_sink`` and ``stream_tile_sink`` publish the session's
    payloads; the reference's subscriber decodes them to the payload's
    arrays."""
    from tests.test_torch_session import port_session

    frames = []
    sess = port_session(1, "temporal", state=False)
    sess.sinks.append(lambda i, p: frames.append(p))
    pub = _pub("port", codec="zlib", epoch=3)
    sess.sinks.append(tst.stream_sink(pub))
    tile = tst.stream_tile_sink(pub)
    sess.run(2)
    p = frames[-1]
    tile(1, dict(p, tile=0, tiles=1, col0=0))
    sub = _sub("ref")
    try:
        got = [sub._decode(m) for m in pub.sock.sent]
        assert len(got) == 3
        color, depth, idx = _decoded(got[1])
        np.testing.assert_array_equal(color, np.asarray(p["vdi_color"]))
        np.testing.assert_array_equal(depth, np.asarray(p["vdi_depth"]))
        assert idx == 1 and got[2][2] == {"tile": 0, "tiles": 1, "col0": 0}
    finally:
        pub.close()
        sub.close()


# ------------------------------------------------------------- video


def _rgb_frames(n=3, h=34, w=46):
    return [np.random.default_rng(i).random((4, h, w), dtype=np.float32)
            for i in range(n)]


def test_h264_sink_matches_reference_and_decodes(tmp_path):
    """The port's I_PCM stream is the reference's byte for byte, its
    size is the I_PCM formula, and cv2's H.264 decoder reads it
    (``tests/test_h264.py``'s decode check); ``video_sink`` with
    ``codec="h264_ipcm"`` writes the same stream from session payloads
    (tensors included)."""
    cv2 = pytest.importorskip("cv2")
    frames = _rgb_frames()
    paths = {k: str(tmp_path / f"{k}.h264") for k in ("port", "ref",
                                                      "video")}
    with th264.h264_sink(paths["port"]) as s:
        for f in frames:
            s(torch.from_numpy(f))
    with jh264.h264_sink(paths["ref"]) as s:
        for f in frames:
            s(f)
    sink = tst.video_sink(paths["video"], codec="h264_ipcm")
    for i, f in enumerate(frames):
        sink(i, {"image": torch.from_numpy(f), "frame": i})
    sink.release()
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["port"] == data["ref"] == data["video"]
    assert len(data["port"]) == th264.ipcm_stream_bytes(46, 34, 3)
    assert sink.codec == "h264_ipcm"
    cap = cv2.VideoCapture(paths["port"])
    ok, img = cap.read() if cap.isOpened() else (False, None)
    cap.release()
    if not ok:
        pytest.skip("this cv2 build cannot decode raw H264")
    assert img.shape[:2] == (34, 46)
    y, _, _ = jh264.rgb_to_yuv420(np.clip(np.moveaxis(
        frames[0][:3], 0, -1), 0, 1) ** (1 / 2.2))
    luma = img.astype(np.float32) @ np.array([0.114, 0.587, 0.299])
    assert np.abs(luma - (y.astype(np.float32) - 16) * 255 / 219).mean() \
        < 6.0


def test_video_sink_and_live_stream(tmp_path):
    """cv2's movie writer from VDI payloads, and the UDP stream's
    chunked JPEG frames through the reference's receiver."""
    pytest.importorskip("cv2")
    path = str(tmp_path / "out.mp4")
    sink = tst.video_sink(path, fps=10.0)
    c, d = _frames(n=1)[0]
    for i in range(3):
        sink(i, {"vdi_color": torch.from_numpy(c),
                 "vdi_depth": torch.from_numpy(d), "frame": i})
    sink.release()
    assert os.path.getsize(path) > 0
    assert sink.codec in ("avc1", "H264", "mp4v")
    rx = jst.VideoReceiver(port=0, timeout_s=3.0)
    tx = tst.VideoStreamer(port=rx.port, quality=90)
    try:
        img = torch.zeros((4, 48, 64))
        img[0, 8:24, 8:24] = 0.9
        img[3] = 1.0
        tx.CHUNK = 512
        assert tst.live_video_sink(tx) is not None
        assert tx.send_frame(img) > 0
        frame = rx.receive_frame()
        assert frame is not None and frame.shape == (48, 64, 3)
        assert frame[16, 16, 0] > 120 and frame[40, 40, 0] < 60
    finally:
        tx.close()
        rx.close()
    assert tst.seq_delta(1, 0xFFFFFFFF) == jst.seq_delta(1, 0xFFFFFFFF) == 2


# --------------------------------------------------------------- head


def _rank_images(n=8, h=10, w=14, seed=4):
    rng = np.random.default_rng(seed)
    imgs = [rng.random((4, h, w), dtype=np.float32) for _ in range(n)]
    deps = [rng.random((h, w), dtype=np.float32) * 3 for _ in range(n)]
    deps[-1][:, :3] = np.inf
    return imgs, deps


def test_head_depth_min_matches_reference_and_composite():
    """``depth_min_composite_np`` equals the reference's and the port's
    ``ops/composite.composite_depth_min`` bit for bit."""
    imgs, deps = _rank_images()
    got = thead.depth_min_composite_np(imgs, deps)
    want = jhead.depth_min_composite_np(imgs, deps)
    dev = composite_depth_min(torch.from_numpy(np.stack(imgs)),
                              torch.from_numpy(np.stack(deps)))
    for a, b, c in zip(got, want, dev):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c.numpy())


@pytest.mark.parametrize("head_pkg", ["port", "ref"])
def test_head_node_against_reference(head_pkg):
    """Rank senders of the other package push a frame set and a frame
    with rank 1 silent; the head composites both (the second degraded
    once rank 1 is past ``stale_frames``) and its payloads equal the
    reference head's composite of the same sets."""
    hmod = thead if head_pkg == "port" else jhead
    smod = jhead if head_pkg == "port" else thead
    got = []
    head = hmod.HeadNode(2, bind="tcp://127.0.0.1:0", stale_frames=1,
                         sinks=(lambda i, p: got.append((i, p)),))
    senders = [smod.RankImageSender(r, head.endpoint) for r in range(2)]
    imgs, deps = _rank_images(n=2)
    try:
        time.sleep(0.2)
        for r in range(2):
            senders[r].send(0, imgs[r], deps[r])
        assert head.run(frames=1, timeout_s=DEADLINE_S) == 1
        for f in (1, 2, 3):
            senders[0].send(f, imgs[0], deps[0])
        _until(lambda: head.pump(timeout_ms=100) or
               head.frames_composited >= 3)
        assert got[0][0] == 0 and "degraded" not in got[0][1]
        want = jhead.depth_min_composite_np(imgs, deps)
        np.testing.assert_array_equal(got[0][1]["image"], want[0])
        np.testing.assert_array_equal(got[0][1]["depth"], want[1])
        late = [p for i, p in got if i > 0]
        assert late and all(p.get("missing_ranks") == [1] for p in late)
        np.testing.assert_array_equal(late[0]["image"], imgs[0])
    finally:
        for s in senders:
            s.close()
        head.close()


def test_head_sender_sink_forwards_image_payloads():
    sent = []

    class _Sender:
        def send(self, frame, image, depth):
            sent.append((frame, image, depth))
    sink = thead.head_sender_sink(_Sender())
    sink(3, {"image": 1, "depth": 2})
    sink(4, {"vdi_color": 1})
    assert sent == [(3, 1, 2)]


# ---------------------------------------------------------- benchmark


def _cams():
    return (tcam.Camera.create((0.0, 0.4, 2.5), fov_y_deg=45.0, near=0.3,
                               far=10.0, device="cpu"),
            jcam.Camera.create((0.0, 0.4, 2.5), fov_y_deg=45.0, near=0.3,
                               far=10.0))


def test_benchmark_views_csv_and_flythrough(tmp_path):
    """The sweep's eyes are the reference's, its CSV has the reference's
    form, the interpolated path equals the reference's cameras, and the
    flythrough writes a PNG a camera and feeds a video sink."""
    cam, jc = _cams()
    eyes, jeyes = [], []
    res = tbench.benchmark_views(
        lambda c: eyes.append(c.eye.numpy()) or torch.full((4, 8, 8), 0.5),
        cam, num_views=3, frames=2, warmup=1,
        screenshot_dir=str(tmp_path / "shots"))
    jbench.benchmark_views(
        lambda c: jeyes.append(np.asarray(c.eye)) or np.full((4, 8, 8),
                                                             0.5),
        jc, num_views=3, frames=2, warmup=1)
    np.testing.assert_allclose(np.stack(eyes), np.stack(jeyes), atol=1e-6)
    assert sorted(os.listdir(tmp_path / "shots")) == [
        "view00.png", "view01.png", "view02.png"]
    assert [r[0] for r in res] == pytest.approx(
        [2 * np.pi * v / 3 for v in range(3)])
    csv, jcsv = tbench.fps_csv(res), jbench.fps_csv(res)
    assert csv.splitlines()[0] == jcsv.splitlines()[0]
    assert len(csv.splitlines()) == 4
    b, jb = (tcam.Camera.create((2.0, 0.0, 0.5), target=(0.1, 0.0, 0.0),
                                fov_y_deg=60.0, device="cpu"),
             jcam.Camera.create((2.0, 0.0, 0.5), target=(0.1, 0.0, 0.0),
                                fov_y_deg=60.0))
    path = tbench.interpolate_path([cam, b], frames_per_segment=4)
    jpath = jbench.interpolate_path([jc, jb], frames_per_segment=4)
    assert len(path) == len(jpath) == 5
    for p, q in zip(path, jpath):
        for x, y in zip(p, q):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
    fed = []
    n = tbench.record_flythrough(lambda c: torch.full((4, 8, 8), 0.3), path,
                                 str(tmp_path / "fly"),
                                 video_sink=lambda i, p: fed.append(i))
    assert n == 5 and len(os.listdir(tmp_path / "fly")) == 5
    assert fed == list(range(5))
