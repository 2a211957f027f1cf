"""The VDI edge-serving tier: render once, serve thousands of viewers
(docs/SERVING.md).

The entire point of a VDI (PAPER.md §0) is view-independent
re-rendering: sim + march + composite cost is paid once per frame, and
any number of client cameras can be answered from the composited
representation. This module is the process that cashes that in —
≅ the reference's L7 streaming/steering plane (SURVEY §2, InSituMaster /
VideoEncoder), except the edge re-renders the REPRESENTATION per viewer
instead of rebroadcasting one camera's pixels.

`ViewerServer` subscribes to the composited VDI stream (tile-granular
and delta-aware — it rides the `VDISubscriber`/`FrameAssembler`
substrate, so mid-stream joins, corrupt messages and P-frame resyncs are
typed drops, never exceptions) and answers N concurrent client cameras
per VDI frame in batches (`ops.vdi_novel.render_vdi_batch`): one copy of
the VDI to the device and one (lazy) proxy expansion shared by every
viewer. Batches are sized to ``serve.buckets`` as the reference's are
(its padded lanes bound a compile cache; the port has none to bound and
renders only the real cameras). Around that core:

- per-client quality tiers — ``exact`` (closed-form renderer), ``proxy``
  (pre-shaded MXU proxy volume, built once per frame), ``wire`` (proxy
  pixels quantized to u8 wire precision, 4× fewer bytes per viewer);
- camera-delta caching — an unchanged camera (within ``serve.cam_tol``)
  on the same VDI frame re-serves the cached pixels without rendering;
- bounded staleness — answers from a VDI more than
  ``serve.staleness_frames`` behind the stream head are stamped
  ``stale`` (the viewer knows it is looking at the past);
- backpressure / admission control — viewers beyond
  ``serve.max_viewers`` and requests beyond ``serve.queue_cap`` get a
  typed ``shed`` answer; every shed, stale or degraded answer is minted
  on the obs ledger (``serve.*`` components, docs/OBSERVABILITY.md).

The client protocol (serve/client.py::`ViewerClient`) follows the
repo's zmq conventions — msgpack headers, CRC-validated blobs,
heartbeats — so the chaos harness (`testing/faults.py`) can exercise it
with the same injectors as every other seam.

The port of the reference's ``serve/server.py``. Renders run on the
server's device (``device=None``: CUDA) through the port's
``ops/vdi_novel`` with bf16 resampling there (f32 on the CPU), as the
reference's do on its accelerator. The render half of `answer_pending`
is `render_views`, which touches no socket: it takes (tier, camera)
views and returns their answer pixels. A server made by
`ViewerServer.without_sockets` runs the whole protocol without pyzmq or
msgpack: frames in through `adopt`, viewer messages through `handle`,
answers out into ``outbox``.
"""

from __future__ import annotations

import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from scenery_insitu_tpu_torch import obs as _obs
from scenery_insitu_tpu_torch.config import (FaultConfig, FrameworkConfig,
                                             ServeConfig, SliceMarchConfig)
from scenery_insitu_tpu_torch.core.camera import Camera
from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata
from scenery_insitu_tpu_torch.device import resolve_device
from scenery_insitu_tpu_torch.obs.slo import SLOEngine
from scenery_insitu_tpu_torch.ops import slicer, vdi_novel
from scenery_insitu_tpu_torch.obs.collector import lineage, trace_ctx
from scenery_insitu_tpu_torch.runtime.streaming import (FrameAssembler,
                                                        StreamDrop,
                                                        VDISubscriber,
                                                        _host, _msgpack,
                                                        _zmq)

TIERS = ("exact", "proxy", "wire")


def camera_from_message(msg: dict, device=None) -> Camera:
    """Client camera payload -> Camera on ``device`` (None: CUDA; the
    `make_camera_message` wire shape: eye/target/up lists + fov_y in
    radians, near/far optional). Raises on malformed payloads — the
    caller drops, typed."""
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)

    def vec3(key, default=None):
        v = msg[key] if key in msg else default
        a = np.asarray(v, np.float32)
        if a.shape != (3,) or not np.isfinite(a).all():
            raise ValueError(f"camera field {key!r} is not a finite vec3")
        return f32(a)

    def scalar(key, default):
        x = float(msg.get(key, default))
        if not np.isfinite(x):
            raise ValueError(f"camera field {key!r} is not finite")
        return x

    # finite-but-degenerate values burn a full batched render producing
    # a garbage frame — refuse them with the rest of the validation
    fov_y = scalar("fov_y", float(np.deg2rad(50.0)))
    near = scalar("near", 0.1)
    far = scalar("far", 1000.0)
    if not 0.0 < fov_y < float(np.pi):
        raise ValueError(f"camera fov_y {fov_y} outside (0, pi)")
    if near <= 0.0 or far <= near:
        raise ValueError(f"camera clip range [{near}, {far}] is "
                         "degenerate (need 0 < near < far)")
    return Camera(eye=vec3("eye"),
                  target=vec3("target", (0.0, 0.0, 0.0)),
                  up=vec3("up", (0.0, 1.0, 0.0)),
                  fov_y=f32(fov_y), near=f32(near), far=f32(far))


def _answer_payload(tier: str, img: np.ndarray) -> np.ndarray:
    """An answer's pixels: the wire tier's u8 unorm (4x fewer bytes a
    viewer), f32 otherwise."""
    if tier == "wire":
        return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(img, np.float32)


def _camera_sig(cam: Camera) -> np.ndarray:
    """Flattened camera leaves — the camera-delta cache key (compared
    with max-abs against ``serve.cam_tol``)."""
    return np.concatenate([np.ravel(_host(x).astype(np.float32))
                           for x in cam])


@dataclass
class _Client:
    ident: bytes
    tier: str
    last_seen: float
    # camera-delta cache: the last answered (adoption, tier, camera,
    # blob). cache_frame holds the server's monotone ADOPTION id, not
    # the stream frame index — indices restart with a publisher epoch,
    # and an old-epoch blob must never serve as the new frame. Tier
    # participates too (a re-negotiated tier changes the payload dtype).
    cache_frame: int = -1
    cache_tier: str = ""
    cache_sig: Optional[np.ndarray] = None
    cache_fields: Optional[dict] = None
    cache_blob: Optional[bytes] = None


@dataclass
class _Request:
    ident: bytes
    seq: int
    cam: Camera
    sig: np.ndarray
    regime: Tuple[int, int]
    t_in: float


class ViewerServer:
    """The edge-serving process: one upstream VDI subscription, one
    client-facing ROUTER socket, one batched render per tier bucket per
    frame. Single-threaded and pump-driven (`run_once` / `serve`) like
    the session loop — no hidden threads to leak under chaos."""

    def __init__(self, cfg: Optional[FrameworkConfig] = None, *,
                 connect: Optional[str] = None,
                 bind: Optional[str] = None,
                 fault: Optional[FaultConfig] = None, device=None):
        cfg = cfg or FrameworkConfig()
        self._init_state(cfg, fault, device)
        # upstream liveness supervision stays OPT-IN (the stream
        # endpoints' convention: without a heartbeat-pumping publisher a
        # healthy-but-slow stream would be torn down) — an explicit
        # fault= arg or serve.supervise_stream turns it on
        sub_fault = fault or (self.fault if self.cfg.supervise_stream
                              else None)
        zmq = _zmq()
        self.ctx = zmq.Context.instance()
        # bind the client socket BEFORE subscribing upstream: a bind
        # failure (address in use, the retry-loop case) must not leak a
        # SUB socket that keeps buffering full VDI frames to its HWM
        self.sock = self.ctx.socket(zmq.ROUTER)
        endpoint = bind or self.cfg.bind
        try:
            if endpoint.endswith(":0"):          # ephemeral port for tests
                port = self.sock.bind_to_random_port(endpoint[:-2])
                self.endpoint = (
                    f"{endpoint[:-2].replace('*', '127.0.0.1')}:{port}")
            else:
                self.sock.bind(endpoint)
                self.endpoint = endpoint.replace("*", "127.0.0.1")
        except Exception:
            self.sock.close(linger=0)
            raise
        self.sub = VDISubscriber(connect or self.cfg.connect,
                                 fault=sub_fault)
        self._epoch = self.sub.last_epoch    # publisher incarnation seen

    @classmethod
    def without_sockets(cls, cfg: Optional[FrameworkConfig] = None,
                        device=None) -> "ViewerServer":
        """The server with no socket (needs neither pyzmq nor msgpack):
        frames come in through `adopt`, viewer messages through `handle`,
        `answer_pending` answers into ``outbox``, and `render_views`
        renders without the protocol."""
        srv = cls.__new__(cls)
        srv._init_state(cfg or FrameworkConfig(), None, device)
        srv.sock = srv.sub = None
        return srv

    def _init_state(self, cfg: FrameworkConfig,
                    fault: Optional[FaultConfig], device) -> None:
        self.device = resolve_device(device)
        self.cfg: ServeConfig = cfg.serve
        # cross-field check lives HERE, not in ServeConfig.__post_init__:
        # with_overrides applies one assignment at a time, so a
        # per-assignment cross-field check would make override ORDER
        # decide validity (buckets-then-batch_size raises, the reverse
        # passes) — only the final consumed pair can be judged
        if self.cfg.buckets[-1] < self.cfg.batch_size:
            raise ValueError(
                f"serve.buckets must reach serve.batch_size "
                f"({self.cfg.batch_size}); the ladder tops out at "
                f"{self.cfg.buckets[-1]}")
        self.fault = fault or cfg.fault
        self.outbox: List[Tuple[bytes, dict, Optional[bytes]]] = []
        self.asm = FrameAssembler(fault=self.fault)
        self.clients: Dict[bytes, _Client] = {}
        # pending camera requests, latest-wins per client (an interactive
        # viewer's stale pose is worthless once a newer one arrived)
        self.queue: "OrderedDict[bytes, _Request]" = OrderedDict()
        # current frame state (adopted whole frames only)
        self.frame: Optional[dict] = None
        self.newest: Optional[int] = None    # newest stream index STARTED
        self._epoch = None                   # publisher incarnation seen
        self._adoption = 0         # monotone id of the adopted frame —
        #                            the cache key (stream INDICES restart
        #                            with a publisher epoch, this never does)
        self._frame_orphaned = False         # frame predates an epoch change
        self._proxy = None                   # per-frame lazy proxy volume
        self._spec_new: Dict[tuple, object] = {}
        self.stats = {"frames_adopted": 0, "answers": 0, "cache_hits": 0,
                      "sheds": 0, "stale_answers": 0, "batches": 0,
                      "batch_cameras": 0, "client_drops": 0,
                      "evictions": 0, "coalesced": 0, "proxy_builds": 0,
                      "stream_drops": 0}
        # live SLO checks on the answer path (docs/OBSERVABILITY.md
        # "SLO engine"): camera-to-pixel latency + answer staleness
        self.slo = SLOEngine(cfg.slo)

    # ------------------------------------------------------------ stream
    def pump_stream(self, timeout_ms: int = 0,
                    max_messages: int = 64) -> int:
        """Drain the upstream VDI stream (first receive may wait
        ``timeout_ms``; the rest are non-blocking). Tile messages
        assemble; complete frames are adopted. Returns frames adopted."""
        adopted = 0
        for _ in range(max_messages):
            got = self.sub.receive_tile(timeout_ms=timeout_ms)
            timeout_ms = 0
            if self.sub.last_epoch != self._epoch:
                # publisher restarted: its frame indices restart too, so
                # the server's OWN assembler and stream-head tracking
                # must reset with it (the subscriber resets its internal
                # state; without this mirror, the late-tile guard wedges
                # assembly and every answer reads as stale forever)
                self._epoch = self.sub.last_epoch
                self.asm = FrameAssembler(fault=self.fault)
                self.newest = None
                # the retained frame is the DEAD incarnation's last one;
                # until the new stream completes a frame, answers from
                # it must read stale (its age vs the new head is
                # meaningless, not zero)
                self._frame_orphaned = self.frame is not None
            if got is None:
                break
            if isinstance(got, StreamDrop):
                # already ledgered by the subscriber (stream.integrity /
                # stream.gap / stream.delta_resync) — count and go on.
                # A refused frame still STARTED: during a resync window
                # every P/SKIP record surfaces here, and if the head
                # froze too, answers from the retained frame would read
                # stale=False for the whole degraded stretch — exactly
                # when the bounded-staleness contract matters most
                if got.frame is not None \
                        and got.epoch == self.sub.last_epoch:
                    self.newest = got.frame if self.newest is None \
                        else max(self.newest, got.frame)
                self.stats["stream_drops"] += 1
                continue
            vdi, meta, tile = got
            idx = int(_host(meta.index))
            self.newest = idx if self.newest is None \
                else max(self.newest, idx)
            out = self.asm.add(vdi, meta, tile)
            if out is not None:
                self.adopt(*out)
                adopted += 1
        return adopted

    def adopt(self, vdi: VDI, meta: VDIMetadata) -> None:
        """Make (vdi, meta) — host arrays or tensors, a complete frame —
        the frame every answer renders from: its one copy to the device,
        the metadata's spec and camera, the derived plane count. The
        stream pump adopts every frame it completes."""
        mdt = "bf16" if self.device.type == "cuda" else "f32"
        dev = self.device
        meta = VDIMetadata(*(torch.tensor(_host(x), device=dev)
                             for x in meta))
        spec0 = vdi_novel.axis_spec_from_meta(meta, matmul_dtype=mdt)
        axcam0 = vdi_novel.axis_camera_from_meta(meta, spec0)
        depth = torch.tensor(_host(vdi.depth), dtype=torch.float32)
        ns = self.cfg.num_slices or None
        if ns is None:
            # derive the plane count from the frame's OWN depth range
            # (the render_vdi_exact s_cap logic): the reconstructed
            # ladder starts at the generating camera's near plane, and
            # for gather-engine VDIs that near plane sits well before
            # the volume — a fixed in-plane heuristic would stop
            # marching before the content. Quantized up so the plane
            # count only changes when the content depth moves materially.
            ends = depth.numpy()[:, 1]
            len0 = np.maximum(_host(axcam0.ray_lengths()), 1e-6)
            s_end = np.where(np.isfinite(ends), ends, 0.0) / len0[None]
            smax = max(1.0, float(s_end.max()))
            ds0 = abs(float(_host(axcam0.dwm))) \
                / max(float(_host(axcam0.zp)), 1e-6)
            raw = int(np.ceil((smax - 1.0) / max(ds0, 1e-6))) + 2
            ns = max(16, -(-raw // 16) * 16)
        # the ONE device copy of the frame, shared by every viewer
        self.frame = {
            "vdi": VDI(torch.tensor(_host(vdi.color), dtype=torch.float32,
                                    device=dev), depth.to(dev)),
            "meta": meta, "index": int(_host(meta.index)),
            "spec0": spec0, "axcam0": axcam0, "num_slices": ns,
        }
        self._proxy = None
        self._adoption += 1
        self._frame_orphaned = False
        # bound the spec cache: the derived num_slices (and with it the
        # proxy shape) tracks the content depth
        if len(self._spec_new) > 32:
            self._spec_new.clear()
        self.stats["frames_adopted"] += 1
        _obs.get_recorder().count("serve_frames_adopted")

    # ----------------------------------------------------------- clients
    def _drop_client(self, why: str) -> None:
        """``why`` must be a CONSTANT string: it lands in the ledger's
        dedup key, and client-controlled variability there (a payload
        repr, an unknown type name) lets one hostile peer grow the
        process-global ledger without bound (the subscriber's
        convention — fixed ledger reasons, variable detail stays out)."""
        self.stats["client_drops"] += 1
        _obs.get_recorder().count("serve_client_drops")
        _obs.degrade("serve.client", "client message", "dropped", why,
                     warn=False)

    def _shed(self, ident: bytes, seq: Optional[int], why: str) -> None:
        self.stats["sheds"] += 1
        _obs.get_recorder().count("serve_sheds")
        _obs.degrade(
            "serve.shed", "viewer request", "shed",
            f"admission control: the {why} cap is reached; the client "
            "got a typed shed answer", warn=False)
        self._send(ident, {"type": "shed", "reason": why, "seq": seq})

    def _resolve_tier(self, tier) -> str:
        if tier in TIERS:
            return tier
        _obs.degrade(
            "serve.tier", "requested tier", self.cfg.default_tier,
            "client requested an unknown quality tier; the configured "
            "default renders instead", warn=False)
        return self.cfg.default_tier

    def _admit(self, ident: bytes, msg: dict, now: float
               ) -> Optional[_Client]:
        """Look up (refreshing liveness) or admit a client at the
        default tier; None — after a typed shed — when the max_viewers
        cap refuses a new ident."""
        cl = self.clients.get(ident)
        if cl is not None:
            cl.last_seen = now
            return cl
        if len(self.clients) >= self.cfg.max_viewers:
            self._shed(ident, msg.get("seq"), "max_viewers")
            return None
        cl = _Client(ident, self.cfg.default_tier, now)
        self.clients[ident] = cl
        return cl

    def _hello(self, ident: bytes, msg: dict, now: float) -> None:
        fresh = ident not in self.clients
        cl = self._admit(ident, msg, now)
        if cl is None:
            return
        if fresh or "tier" in msg:
            cl.tier = self._resolve_tier(
                msg.get("tier", self.cfg.default_tier))
        self._send(ident, {
            "type": "welcome", "tier": cl.tier, "width": self.cfg.width,
            "height": self.cfg.height,
            "frame": -1 if self.frame is None else self.frame["index"]})

    def _camera(self, ident: bytes, msg: dict, now: float) -> None:
        # validate BEFORE admission: a sender of garbage must not
        # occupy a max_viewers slot (up to client_timeout_s, renewable)
        # that it never earned with a renderable request
        try:
            cam = camera_from_message(msg, self.device)
            seq = int(msg.get("seq", 0))
        except Exception:  # sitpu-lint: disable=SITPU-LEDGER (mints via _drop_client)
            self._drop_client("camera payload failed validation")
            return
        # implicit hello — still through admission; a tier carried on
        # the request is honored (a viewer that never said hello must
        # not be silently downgraded to serve.default_tier)
        cl = self._admit(ident, msg, now)
        if cl is None:
            return
        tier = msg.get("tier")
        if tier is not None and tier != cl.tier:
            cl.tier = self._resolve_tier(tier)
        if ident not in self.queue and len(self.queue) >= self.cfg.queue_cap:
            self._shed(ident, seq, "queue_cap")
            return
        if ident in self.queue:
            self.stats["coalesced"] += 1
            _obs.get_recorder().count("serve_requests_coalesced")
        self.queue[ident] = _Request(ident, seq, cam, _camera_sig(cam),
                                     slicer.choose_axis(cam), now)
        _obs.get_recorder().count("serve_requests")

    def pump_clients(self, max_messages: int = 256) -> int:
        """Drain the client socket: hellos, camera requests, byes,
        heartbeats. Malformed/oversized messages drop typed
        (``serve.client``); silent clients past ``client_timeout_s`` are
        evicted. Returns messages consumed."""
        zmq = _zmq()
        n = 0
        for _ in range(max_messages):
            try:
                parts = self.sock.recv_multipart(zmq.NOBLOCK)
            except zmq.Again:
                break
            n += 1
            if len(parts) != 2:
                self._drop_client("unexpected [ident, payload] framing")
                continue
            ident, raw = parts
            if len(raw) > self.fault.max_message_bytes:
                self._drop_client("message exceeds fault.max_message_bytes")
                continue
            try:
                msg = _msgpack().unpackb(raw)
            except Exception:
                self._drop_client("unparseable msgpack from a viewer")
                continue
            if not isinstance(msg, dict):
                self._drop_client("client payload is not a map")
                continue
            self.handle(ident, msg)
        self._evict(time.monotonic())
        return n

    def handle(self, ident: bytes, msg: dict) -> None:
        """One parsed client message from viewer ``ident`` (what
        `pump_clients` does with each message it validates): a hello, a
        camera request, a bye or a heartbeat."""
        now = time.monotonic()
        if msg.get("hb"):
            cl = self.clients.get(ident)
            if cl is not None:
                cl.last_seen = now
            return
        kind = msg.get("type")
        if kind == "hello":
            self._hello(ident, msg, now)
        elif kind == "camera":
            self._camera(ident, msg, now)
        elif kind == "bye":
            self.clients.pop(ident, None)
            self.queue.pop(ident, None)
        else:
            self._drop_client("unknown client message type")

    def _send(self, ident: bytes, fields: dict,
              blob: Optional[bytes] = None) -> None:
        """One answer to viewer ``ident``: on the client socket, or, on a
        server without sockets, into ``outbox`` as (ident, fields,
        blob)."""
        if self.sock is None:
            self.outbox.append((ident, fields, blob))
            return
        self.sock.send_multipart([ident, _msgpack().packb(fields)]
                                 + ([] if blob is None else [blob]))

    def _evict(self, now: float) -> None:
        for ident, cl in list(self.clients.items()):
            if now - cl.last_seen > self.cfg.client_timeout_s:
                del self.clients[ident]
                self.queue.pop(ident, None)
                self.stats["evictions"] += 1
                _obs.get_recorder().count("serve_clients_evicted")

    # ------------------------------------------------------------ render
    def _spec_new_for(self, regime: Tuple[int, int], shape: tuple):
        key = (regime, shape)
        spec = self._spec_new.get(key)
        if spec is None:
            cfg = SliceMarchConfig(
                matmul_dtype=self.frame["spec0"].matmul_dtype,
                scale=self.cfg.march_scale)
            # cam is unused when axis_sign is given, but for its device
            spec = slicer.make_spec(
                Camera.create((0.0, 0.0, 3.0), device=self.device), shape,
                cfg, axis_sign=regime)
            self._spec_new[key] = spec
        return spec

    def _ensure_proxy(self):
        if self._proxy is not None:
            return self._proxy
        vdi = self.frame["vdi"]
        with _obs.get_recorder().span("serve_proxy_build",
                                      frame=self.frame["index"]):
            self._proxy = vdi_novel.vdi_to_rgba_volume(
                vdi, self.frame["axcam0"], self.frame["spec0"],
                num_slices=self.frame["num_slices"])
        self.stats["proxy_builds"] += 1
        _obs.get_recorder().count("serve_proxy_builds")
        return self._proxy

    def _bucket(self, n: int) -> int:
        for b in self.cfg.buckets:
            if b >= n:
                return b
        return self.cfg.buckets[-1]

    def _render_batch(self, gtier: str, regime, cams: List[Camera]
                      ) -> np.ndarray:
        """One batch of cameras (its bucket the ``serve.buckets`` size
        that holds it) through `render_vdi_batch` on the adopted frame
        -> host f32[len(cams), 4, H, W]."""
        n = len(cams)
        bucket = self._bucket(n)
        stacked = vdi_novel.stack_cameras(cams)
        w, h = self.cfg.width, self.cfg.height
        with _obs.get_recorder().span(
                "serve_batch", frame=self.frame["index"], tier=gtier,
                cameras=n, bucket=bucket):
            if gtier == "exact":
                vdi = self.frame["vdi"]
                imgs = vdi_novel.render_vdi_batch(
                    vdi, self.frame["axcam0"], self.frame["spec0"],
                    stacked, w, h, tier="exact")
            else:
                proxy = self._ensure_proxy()
                spec_new = self._spec_new_for(
                    regime, tuple(proxy.data.shape[-3:]))
                imgs = vdi_novel.render_vdi_batch(
                    None, None, self.frame["spec0"], stacked, w, h,
                    tier="proxy", proxy=proxy, spec_new=spec_new)
            imgs = imgs.cpu().numpy()
        self.stats["batches"] += 1
        self.stats["batch_cameras"] += n
        _obs.get_recorder().count("serve_batches")
        _obs.get_recorder().count("serve_batch_cameras", n)
        return imgs

    def render_views(self, views) -> List[Tuple[str, np.ndarray]]:
        """The render half of `answer_pending`, without a socket: each
        ``(tier, camera)`` view against the adopted frame -> its answer's
        ``(tier, pixels)`` in the views' order. Tiers resolve (an unknown
        one to ``serve.default_tier``); ``exact`` views batch together,
        ``proxy`` and ``wire`` views batch per march regime over one
        proxy volume built once a frame; each group goes in chunks of
        ``serve.batch_size``; a wire answer is the proxy render quantized
        to u8 (f32 otherwise)."""
        if self.frame is None:
            raise RuntimeError("render_views needs an adopted frame")
        tiers = [self._resolve_tier(t) for t, _ in views]
        groups: Dict[tuple, List[int]] = {}
        for i, ((_, cam), tier) in enumerate(zip(views, tiers)):
            gkey = ("exact", None) if tier == "exact" \
                else ("proxy", slicer.choose_axis(cam))
            groups.setdefault(gkey, []).append(i)
        out: List[Optional[Tuple[str, np.ndarray]]] = [None] * len(views)
        for (gtier, regime), idx in groups.items():
            for lo in range(0, len(idx), self.cfg.batch_size):
                chunk = idx[lo:lo + self.cfg.batch_size]
                imgs = self._render_batch(gtier, regime,
                                          [views[i][1] for i in chunk])
                for i, img in zip(chunk, imgs):
                    out[i] = (tiers[i], _answer_payload(tiers[i], img))
        return out

    def answer_pending(self) -> int:
        """Answer every queued request against the current VDI frame:
        camera-delta cache hits first, then `render_views` for the rest
        (one batched render per (tier, regime) bucket). Returns answers
        sent."""
        if self.frame is None or not self.queue:
            return 0
        fidx = self.frame["index"]
        stale = self._frame_orphaned or (
            self.newest is not None
            and self.newest - fidx > self.cfg.staleness_frames)
        if stale:
            _obs.degrade(
                "serve.stale", "fresh frame", "stale answer",
                "the served VDI is more than serve.staleness_frames "
                "behind the stream head; answers are stamped stale",
                warn=False)
        served = 0
        todo: List[Tuple[_Request, str]] = []
        for ident, req in list(self.queue.items()):
            del self.queue[ident]
            cl = self.clients.get(ident)
            if cl is None:
                continue
            if (cl.cache_blob is not None
                    and cl.cache_frame == self._adoption
                    and cl.cache_tier == cl.tier
                    and cl.cache_sig is not None
                    and cl.cache_sig.shape == req.sig.shape
                    and float(np.max(np.abs(req.sig - cl.cache_sig)))
                    <= self.cfg.cam_tol):
                # staleness is re-stamped: the cached PIXELS are still
                # the current frame's (cache_frame == fidx), but the
                # stream head may have moved past it since they were
                # rendered — a frozen stale=False would break the
                # bounded-staleness contract
                fields = dict(cl.cache_fields, seq=req.seq, cached=True,
                              stale=bool(stale),
                              tc=trace_ctx(fidx,
                                           _obs.get_recorder().rank))
                self._send(ident, fields, cl.cache_blob)
                self.stats["cache_hits"] += 1
                self.stats["answers"] += 1
                _obs.get_recorder().count("serve_cache_hits")
                _obs.get_recorder().count("serve_answers")
                _obs.get_recorder().count("serve_bytes_out",
                                          len(cl.cache_blob))
                if stale:
                    self.stats["stale_answers"] += 1
                    _obs.get_recorder().count("serve_stale_answers")
                self._observe_answer(req, fidx, stale)
                served += 1
                continue
            todo.append((req, cl.tier))
        if todo:
            answers = self.render_views([(tier, req.cam)
                                         for req, tier in todo])
            for (req, _), (tier, payload) in zip(todo, answers):
                self._reply(req, tier, payload, fidx, stale)
                served += 1
        return served

    def _observe_answer(self, req: _Request, fidx: int,
                        stale: bool) -> None:
        """Per-answer telemetry: camera-to-pixel latency and answer
        staleness feed the SLO engine; one ``serve`` lineage hop joins
        the frame's fleet-trace arc."""
        c2p_ms = (time.monotonic() - req.t_in) * 1e3
        self.slo.observe("camera_to_pixel_ms", c2p_ms, frame=fidx)
        if self.newest is not None:
            self.slo.observe("staleness_frames",
                             max(0, self.newest - fidx), frame=fidx)
        lineage("serve", "send", fidx, seq=req.seq, stale=bool(stale),
                cam_to_pix_ms=round(c2p_ms, 3))

    def _reply(self, req: _Request, tier: str, payload: np.ndarray,
               fidx: int, stale: bool) -> None:
        cl = self.clients.get(req.ident)
        dtype = "u8" if payload.dtype == np.uint8 else "f32"
        blob = payload.tobytes()
        fields = {"type": "frame", "frame": fidx, "seq": req.seq,
                  "tier": tier, "stale": bool(stale), "cached": False,
                  "shape": list(payload.shape), "dtype": dtype,
                  "crc": zlib.crc32(blob),
                  "tc": trace_ctx(fidx, _obs.get_recorder().rank)}
        self._send(req.ident, fields, blob)
        self.stats["answers"] += 1
        rec = _obs.get_recorder()
        rec.count("serve_answers")
        rec.count("serve_bytes_out", len(blob))
        if stale:
            self.stats["stale_answers"] += 1
            rec.count("serve_stale_answers")
        self._observe_answer(req, fidx, stale)
        if cl is not None:
            cl.cache_frame = self._adoption
            cl.cache_tier = tier
            cl.cache_sig = req.sig
            cl.cache_fields = dict(fields, cached=True)
            cl.cache_blob = blob

    # -------------------------------------------------------------- loop
    def run_once(self, timeout_ms: int = 50) -> int:
        """One pump: drain clients, drain stream, answer pending.
        Clients drain FIRST, and the stream wait is skipped while there
        are requests the server can actually answer — otherwise an idle
        stream puts a ``timeout_ms`` latency floor under every
        camera-to-pixel answer. Requests queued BEFORE the first frame
        arrives don't skip the wait (nothing is answerable yet, and a
        zero-wait pump would busy-spin until the stream starts).
        Returns answers sent."""
        self.pump_clients()
        answerable = bool(self.queue) and self.frame is not None
        self.pump_stream(timeout_ms=0 if answerable else timeout_ms)
        return self.answer_pending()

    def serve(self, seconds: Optional[float] = None,
              max_answers: Optional[int] = None) -> dict:
        """Pump until ``seconds`` elapse or ``max_answers`` were sent
        (None = forever on that axis); returns the stats snapshot."""
        deadline = None if seconds is None else time.monotonic() + seconds
        answers = 0
        try:
            while (deadline is None or time.monotonic() < deadline) and \
                    (max_answers is None or answers < max_answers):
                answers += self.run_once(timeout_ms=20)
        except BaseException:
            # flight recorder: the serve loop died — dump the recorder's
            # last window before the exception erases it
            _obs.flight_flush(where="serve")
            raise
        return dict(self.stats)

    def slo_snapshot(self) -> dict:
        """The SLO engine's machine-readable health record for THIS
        edge (camera-to-pixel + staleness quantiles vs budget)."""
        return self.slo.snapshot()

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close(linger=0)
            self.sub.close()
