"""Viewer client of the edge-serving tier (docs/SERVING.md "Client
protocol").

`ViewerClient` speaks the serve protocol over one DEALER socket: hello
(tier negotiation through admission control), camera requests, typed
answers (frame / shed), heartbeats so the server can tell a quiet viewer
from a dead one, and a clean bye. Every answer is validated (msgpack
header, CRC, declared shape × itemsize) BEFORE decode — a corrupt or
truncated answer is a typed `ServeDrop`, never an exception, mirroring
the `VDISubscriber` hardening contract (docs/ROBUSTNESS.md).

Between server keyframes, `render_local` warps the last answered frame
onto a new camera viewer-side (`serve/reproject.py`) — the small-motion
latency path that needs no round trip at all. The port of the
reference's ``serve/client.py``: the same protocol, so either package's
client talks to either package's server.
"""

from __future__ import annotations

import os
import time
import zlib
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from scenery_insitu_tpu_torch.config import FaultConfig
from scenery_insitu_tpu_torch.core.camera import Camera
from scenery_insitu_tpu_torch.runtime.streaming import (_msgpack, _zmq,
                                                        make_camera_message)


@dataclass(frozen=True)
class ServeDrop:
    """Typed record of one answer the client refused or one refusal the
    server sent: ``kind`` is ``"shed"`` (admission control),
    ``"integrity"`` (CRC/size/shape mismatch) or ``"malformed"``
    (header unparseable)."""

    kind: str
    reason: str
    seq: Optional[int] = None


@dataclass
class ViewerFrame:
    """One answered view: ``image`` is f32[4, H, W] premultiplied
    (wire-tier u8 payloads are dequantized here), ``wire_bytes`` is what
    actually crossed the socket for the pixel blob."""

    image: np.ndarray
    frame: int
    seq: int
    tier: str
    stale: bool
    cached: bool
    wire_bytes: int


class ViewerClient:
    """One viewer endpoint. Single-threaded: `request` then `poll` (or
    `render` for the request→answer round trip)."""

    def __init__(self, connect: str, tier: str = "proxy",
                 identity: Optional[bytes] = None,
                 fault: Optional[FaultConfig] = None):
        zmq = _zmq()
        self.tier = tier
        self.fault = fault or FaultConfig()
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.DEALER)
        self.identity = identity or os.urandom(8).hex().encode()
        self.sock.setsockopt(zmq.IDENTITY, self.identity)
        self.sock.connect(connect)
        self._seq = 0
        self._cams = {}                    # seq -> Camera (reprojection)
        self.last: Optional[ViewerFrame] = None
        self.last_camera: Optional[Camera] = None
        self.stats = {"answers": 0, "sheds": 0, "drops": 0, "bytes": 0,
                      "cache_hits": 0, "stale_answers": 0}
        self._last_send = time.monotonic()

    # ------------------------------------------------------------- sends
    def hello(self, timeout_ms: int = 5000
              ) -> Union[dict, ServeDrop, None]:
        """Introduce this viewer (tier negotiation). Returns the welcome
        dict, a ``shed`` ServeDrop (admission control refused), or None
        on timeout."""
        self.sock.send(_msgpack().packb({"type": "hello",
                                         "tier": self.tier}))
        self._last_send = time.monotonic()
        deadline = time.monotonic() + timeout_ms / 1000.0
        while time.monotonic() < deadline:
            left = max(0, int((deadline - time.monotonic()) * 1000))
            got = self.poll(timeout_ms=left)
            if isinstance(got, ServeDrop) and got.seq is not None:
                continue   # belongs to an earlier camera request —
                #            hellos carry no seq, so only a seq-less
                #            drop can be THIS hello's refusal
            if isinstance(got, dict) or isinstance(got, ServeDrop) \
                    or got is None:
                return got
            # a late frame answer from an earlier request — keep waiting

    def request(self, cam: Camera, seq: Optional[int] = None) -> int:
        """Send one camera request; returns its sequence number."""
        if seq is None:
            self._seq += 1
            seq = self._seq
        msg = make_camera_message(cam)
        msg["seq"] = int(seq)
        # carry the tier on every request: a viewer that never said
        # hello is implicitly admitted, and without this its answers
        # would silently arrive at serve.default_tier
        msg["tier"] = self.tier
        self.sock.send(_msgpack().packb(msg))
        self._last_send = time.monotonic()
        self._cams[int(seq)] = cam
        # bound the in-flight map — an answer can only reference a
        # recent seq, and a shed request's camera must not leak
        while len(self._cams) > 32:
            self._cams.pop(next(iter(self._cams)))
        return seq

    def heartbeat(self) -> None:
        self.sock.send(_msgpack().packb({"hb": 1}))
        self._last_send = time.monotonic()

    def maybe_heartbeat(self) -> bool:
        """Heartbeat only after ``fault.heartbeat_period_s`` of send
        silence (the stream publishers' pacer) — call from the viewer's
        idle loop to stay admitted past ``serve.client_timeout_s``
        without spamming the server."""
        if time.monotonic() - self._last_send \
                < self.fault.heartbeat_period_s:
            return False
        self.heartbeat()
        return True

    def bye(self) -> None:
        self.sock.send(_msgpack().packb({"type": "bye"}))

    # ----------------------------------------------------------- receive
    def poll(self, timeout_ms: int = 1000
             ) -> Union[None, dict, ServeDrop, ViewerFrame]:
        """One answer: a `ViewerFrame`, a welcome dict, a typed
        `ServeDrop` (shed / refused answer), or None on timeout."""
        if not self.sock.poll(timeout_ms):
            return None
        parts = self.sock.recv_multipart()
        msgpack = _msgpack()
        try:
            h = msgpack.unpackb(parts[0])
            if not isinstance(h, dict):
                raise TypeError("header is not a map")
        except Exception:
            self.stats["drops"] += 1
            return ServeDrop("malformed", "unparseable answer header")
        kind = h.get("type")
        if kind == "welcome":
            # adopt the NEGOTIATED tier (an unknown request degrades to
            # the server's default) so later requests carry it — here,
            # not in hello(): a fire-and-forget hello(timeout_ms=0)
            # consumes its welcome through a later poll()
            if "tier" in h:
                self.tier = h["tier"]
            return h
        if kind == "shed":
            self.stats["sheds"] += 1
            return ServeDrop("shed", str(h.get("reason")), h.get("seq"))
        if kind != "frame" or len(parts) != 2:
            self.stats["drops"] += 1
            return ServeDrop("malformed",
                             f"unexpected answer type {kind!r} with "
                             f"{len(parts)} parts")
        blob = parts[1]
        try:
            # EVERY field the ViewerFrame needs is extracted here — a
            # corrupt-but-parseable header (missing/mistyped keys) must
            # surface as a typed drop, never an exception
            shape = tuple(int(x) for x in h["shape"])
            dtype = np.uint8 if h["dtype"] == "u8" else np.float32
            want = int(np.prod(shape)) * np.dtype(dtype).itemsize
            fidx, seq = int(h["frame"]), int(h["seq"])
            tier, stale, cached = (str(h["tier"]), bool(h["stale"]),
                                   bool(h["cached"]))
        except Exception:
            self.stats["drops"] += 1
            return ServeDrop("malformed", "bad frame header fields",
                             h.get("seq"))
        if h.get("crc") is not None and h["crc"] != zlib.crc32(blob):
            self.stats["drops"] += 1
            return ServeDrop("integrity", "answer blob checksum mismatch",
                             h.get("seq"))
        if len(blob) != want:
            self.stats["drops"] += 1
            return ServeDrop(
                "integrity", f"answer blob bytes ({len(blob)}) != "
                             f"declared shape ({want})", h.get("seq"))
        img = np.frombuffer(blob, dtype).reshape(shape)
        if dtype is np.uint8:
            img = img.astype(np.float32) / 255.0
        out = ViewerFrame(image=np.asarray(img, np.float32),
                          frame=fidx, seq=seq, tier=tier, stale=stale,
                          cached=cached, wire_bytes=len(blob))
        self.stats["answers"] += 1
        self.stats["bytes"] += len(blob)
        if out.cached:
            self.stats["cache_hits"] += 1
        if out.stale:
            self.stats["stale_answers"] += 1
        cam = self._cams.pop(out.seq, None)
        if cam is not None:
            self.last_camera = cam
        self.last = out
        return out

    def render(self, cam: Camera, timeout_ms: int = 5000
               ) -> Union[None, ServeDrop, ViewerFrame]:
        """Round trip: request ``cam`` and wait for ITS answer (earlier
        in-flight answers are consumed into ``last`` on the way)."""
        seq = self.request(cam)
        deadline = time.monotonic() + timeout_ms / 1000.0
        while time.monotonic() < deadline:
            left = max(0, int((deadline - time.monotonic()) * 1000))
            got = self.poll(timeout_ms=left)
            if got is None:
                return None
            if isinstance(got, ServeDrop):
                if got.seq in (None, seq):
                    return got
                continue
            if isinstance(got, ViewerFrame) and got.seq == seq:
                return got
        return None

    # ------------------------------------------------- local reprojection
    def render_local(self, cam: Camera) -> Optional[np.ndarray]:
        """Small-motion path between keyframes:
        warp the last answered frame onto ``cam`` viewer-side — no round
        trip, no server cost. None until a first answer arrived."""
        if self.last is None or self.last_camera is None:
            return None
        from scenery_insitu_tpu_torch.serve.reproject import reproject_planar

        return reproject_planar(self.last.image, self.last_camera, cam)

    def close(self) -> None:
        self.sock.close(linger=0)
