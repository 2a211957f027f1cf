"""Streaming and steering: the port of the reference's
``runtime/streaming.py`` (SURVEY.md §7 step 10b, layer L7).

The reference's side channels, over ZMQ and msgpack:

- ``VDIPublisher``/``VDISubscriber``: multipart VDI frames ``[msgpack
  header, color blob, depth blob]`` with the ``io/vdi_io`` codecs, the
  qpack8 pre-codec pass and the P-frame codec of ``ops/delta``; every
  message carries a publisher epoch, a u32 sequence number and a CRC32
  per blob, so the subscriber refuses a corrupt, stale or unjoinable
  message as a typed ``StreamDrop`` instead of raising. ``FrameAssembler``
  turns a tile stream back into frames. The wire is the reference's, so
  either package's publisher feeds the other's subscriber.
- the steering protocol: typed dict messages (``make_camera_message``,
  ``make_tf_message``) applied by ``apply_steering`` and, in a session,
  ``runtime/session.steer_session``; ``SteeringEndpoint`` drains them
  from a socket each frame, ``SteeringPublisher`` sends them,
  ``SteeringRelay`` fans them out to every render endpoint.
- live video over UDP (``VideoStreamer``/``VideoReceiver``, JPEG
  datagrams) and the movie sinks (``video_sink``: cv2's writer or the
  I_PCM H.264 writer of ``io/h264``).

``zmq``, ``msgpack`` and ``cv2`` are imported inside the functions that
use them; the message helpers and the wire validation need none of them.
The subscriber hands back host numpy arrays (VDI and metadata), as the
reference does and as ``io/vdi_io.load_vdi`` does; the publisher takes
tensors on any device or arrays.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from scenery_insitu_tpu_torch import obs as _obs
from scenery_insitu_tpu_torch.config import DeltaConfig, FaultConfig
from scenery_insitu_tpu_torch.core.camera import Camera
from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata
from scenery_insitu_tpu_torch.io.vdi_io import compress, decompress
from scenery_insitu_tpu_torch.obs.collector import lineage, trace_ctx
from scenery_insitu_tpu_torch.utils.retry import Backoff


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


_META_FIELDS = VDIMetadata._fields

# ------------------------------------------------- sequence-space helpers

SEQ_MASK = 0xFFFFFFFF
_EPOCH_COUNT = itertools.count(1)


def _make_epoch() -> int:
    """Publisher-incarnation id: distinguishes a restarted publisher
    (sequence counter reset) from a sequence gap on a live one. Random
    32-bit (collision odds ~2^-32 per restart — a pid/counter scheme
    collides at 2^-16, which over long deployments silently blackholes
    the successor's stream as 'stale'); xor'd with a process counter so
    even an exhausted entropy pool cannot hand two publishers in one
    process the same epoch. Tests pass ``epoch=`` explicitly for
    determinism."""
    r = int.from_bytes(os.urandom(4), "little")
    return ((r ^ next(_EPOCH_COUNT)) & SEQ_MASK) or 1


def seq_delta(a: int, b: int, bits: int = 32) -> int:
    """Wrap-aware ``a - b`` in modular sequence space, mapped into
    ``[-2**(bits-1), 2**(bits-1))`` — positive means ``a`` is newer.
    Shared by the VDI stream continuity check and the UDP video
    receiver's eviction (a u32 frame counter wraps after ~2.3 years at
    60 FPS, and an unwrapped ``f < fid - 4`` comparison would leak and
    misorder across the wrap)."""
    mask = (1 << bits) - 1
    half = 1 << (bits - 1)
    d = (a - b) & mask
    return d - (1 << bits) if d >= half else d


@dataclass(frozen=True)
class StreamDrop:
    """Typed record of one message the subscriber refused: ``kind`` is
    ``"integrity"`` (failed checksum/size/shape validation before
    decode), ``"stale"`` (duplicate or reordered sequence number),
    ``"malformed"`` (header unparseable) or ``"resync"`` (a temporal-
    delta P/SKIP record whose base tile is not retained — an earlier
    drop broke the chain; the stream recovers on the next forced
    I-tile, within ``delta.iframe_period`` frames). Returned instead of
    raising — the stream outlives any single bad message. ``frame`` is
    the refused message's frame index when its header parsed far enough
    to carry one — a refused frame still STARTED, so stream-head
    bookkeeping (the serving tier's bounded-staleness clock) must
    advance past it."""

    kind: str
    reason: str
    epoch: Optional[int] = None
    seq: Optional[int] = None
    frame: Optional[int] = None


_HEARTBEAT = object()        # receive-loop sentinel: liveness, not a frame


class _HeartbeatPacer:
    """Shared idle-heartbeat pacing: subclasses define ``heartbeat()``
    and keep ``_last_send`` fresh; ``maybe_heartbeat()`` fires one only
    after ``fault.heartbeat_period_s`` of silence."""

    def maybe_heartbeat(self) -> bool:
        """Heartbeat only if nothing was sent for
        ``fault.heartbeat_period_s``; returns True when one went out.
        Cheap to call every loop iteration."""
        if (time.monotonic() - self._last_send
                < self.fault.heartbeat_period_s):
            return False
        self.heartbeat()
        return True


class _ReconnectSupervisor:
    """Shared liveness supervision (docs/ROBUSTNESS.md): track last-seen
    traffic and, past ``fault.liveness_timeout_s``, re-establish the
    socket via the subclass's ``_reopen()``, pacing retries on the
    bounded backoff ladder. Supervision is OPT-IN (``fault=`` passed to
    the constructor): idle publishers are normal, and without a
    heartbeat pump a healthy-but-slow stream must not be torn down.
    A failed re-open (e.g. transient EADDRINUSE right after close) is
    ledgered and retried on the next backoff tick, never raised into
    the render loop."""

    _what = "stream"             # names the stream in the ledger reason

    def _init_supervision(self, supervised: bool) -> None:
        self._supervised = supervised
        self._backoff = Backoff(self.fault.backoff_base_s,
                                self.fault.backoff_cap_s)
        self._last_seen = time.monotonic()
        self._next_reconnect = 0.0

    def _supervise(self) -> None:
        t = self.fault.liveness_timeout_s
        if not self._supervised or t <= 0:
            return
        now = time.monotonic()
        if now - self._last_seen <= t:
            self._backoff.reset()
            return
        if now < self._next_reconnect:
            return
        self._next_reconnect = now + self._backoff.next_delay()
        try:
            self._reopen()
        except Exception as e:
            _obs.degrade(
                "stream.liveness", "reconnecting", "reconnect failed",
                f"socket re-open failed ({type(e).__name__}); retrying "
                "on the backoff ladder", warn=False)
            return
        self.stats["reconnects"] += 1
        _obs.get_recorder().count("stream_reconnects")
        _obs.degrade(
            "stream.liveness", "connected", "reconnecting",
            f"no {self._what} traffic past liveness_timeout_s={t}; "
            "re-dialing with bounded backoff", warn=False)


def _msgpack():
    import msgpack
    return msgpack


def _zmq():
    import zmq
    return zmq


# --------------------------------------------------------------- VDI stream

class VDIPublisher(_HeartbeatPacer):
    """PUB endpoint streaming (metadata, color, depth) per frame.

    ``precision="qpack8"`` runs the sort-last wire quantizer
    (ops.wire.qpack8_quantize_np; docs/PERF.md "Wire formats") as a
    pre-codec pass on every frame: buffers shrink 4× BEFORE the byte
    codec, the [near, far] scale and the precision tag travel in the
    frame header, and the metadata's ``precision`` field is stamped so
    subscribers (which dequantize transparently) and any archived
    headers agree on what the bytes are. Lossy by the wire contract.

    ``bind=None`` makes a publisher without a socket (it needs neither
    pyzmq nor msgpack): every message it would send lands in
    ``outbox`` as (header fields with their seq, color blob, depth
    blob), the encode path otherwise unchanged."""

    def __init__(self, bind: Optional[str] = "tcp://*:6655",
                 codec: str = "zstd",
                 level: int = -1, precision: str = "f32",
                 fault: Optional[FaultConfig] = None,
                 epoch: Optional[int] = None,
                 delta: Optional[DeltaConfig] = None,
                 encode_workers: int = 1):
        from scenery_insitu_tpu_torch.io.vdi_io import resolve_codec

        if precision not in ("f32", "qpack8"):
            raise ValueError(f"precision must be 'f32' or 'qpack8', "
                             f"got {precision!r}")
        if encode_workers < 1:
            raise ValueError(f"encode_workers must be >= 1, "
                             f"got {encode_workers}")
        # temporal-delta wire codec (docs/PERF.md "Temporal deltas"):
        # per-tile SKIP / residual / I-tile records against the retained
        # previous frame. Code-space comparison is only exact on the
        # monotone qpack8 quantizer, so f32 + delta is a config error.
        self._delta = None
        if delta is not None and delta.enabled:
            if precision != "qpack8":
                raise ValueError(
                    "delta.enabled requires precision='qpack8' (the "
                    "P-frame codec compares qpack8 code space)")
            from scenery_insitu_tpu_torch.ops.delta import DeltaEncoder

            self._delta = DeltaEncoder(delta.iframe_period)
        # parallel tile encode (docs/PERF.md "Async delivery"): the
        # column-block tile is the independent unit, so the per-tile
        # quantize/compress/CRC work of publish_tile fans out across a
        # small thread pool; wire messages still post in submission
        # (ascending column) order, so delivered bytes are bit-identical
        # to the serial path. The temporal-delta codec is stateful per
        # tile key (encode order IS the codec state), so delta forces
        # the serial path — ledgered, not silent.
        self.encode_workers = int(encode_workers)
        if self.encode_workers > 1 and self._delta is not None:
            _obs.degrade("delivery.encode",
                         f"{self.encode_workers} encode workers",
                         "serial",
                         "temporal delta is stateful per tile (P-frame "
                         "records compare against the retained previous "
                         "tile), so parallel encode would race the "
                         "codec state", warn=False)
            self.encode_workers = 1
        self._pool = None
        self._enc_pending = deque()   # futures in tile submission order
        # degrade the default codec when the optional zstandard package
        # is absent (the resolved name travels in every frame header, so
        # subscribers stay consistent)
        self.codec = resolve_codec(codec)
        self.level = level
        self.precision = precision
        self.fault = fault or FaultConfig()
        # stream continuity identity (docs/ROBUSTNESS.md): the epoch
        # names this publisher incarnation, seq counts every message
        # (frames, tiles AND heartbeats share one counter, so idle
        # heartbeats keep the continuity check alive)
        self.epoch = _make_epoch() if epoch is None else int(epoch)
        self.seq = 0
        self.last_bytes = {}       # header/color/depth sizes of last send
        self._last_send = time.monotonic()
        # serializes frame publishes with the optional background
        # heartbeat pump (zmq sockets are not thread-safe)
        self._send_lock = threading.Lock()
        self._hb_stop = None
        self._hb_thread = None
        self.outbox = []
        self.sock = self.endpoint = None
        if bind is None:
            return
        zmq = _zmq()
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.PUB)
        if bind.endswith(":0"):                      # ephemeral port for tests
            port = self.sock.bind_to_random_port(bind[:-2])
            self.endpoint = f"{bind[:-2].replace('*', '127.0.0.1')}:{port}"
        else:
            self.sock.bind(bind)
            self.endpoint = bind.replace("*", "127.0.0.1")

    def _next_seq(self) -> int:
        self.seq = (self.seq + 1) & SEQ_MASK
        return self.seq

    def heartbeat(self) -> None:
        """Send one idle heartbeat (single-part message carrying only
        the continuity header) — subscribers refresh their last-seen
        time and sequence tracking without receiving a frame."""
        with self._send_lock:
            fields = {"hb": 1, "epoch": self.epoch, "seq": self._next_seq()}
            if self.sock is None:
                self.outbox.append((fields, None, None))
            else:
                self.sock.send(_msgpack().packb(fields))
            self._last_send = time.monotonic()

    def start_heartbeats(self) -> None:
        """Opt-in background heartbeat pump (docs/ROBUSTNESS.md): a
        daemon thread fires ``maybe_heartbeat`` so supervised
        subscribers can tell a slow frame from a dead publisher even
        when the render loop is stalled inside a dispatch. Sends are
        lock-serialized with the frame publishes; ``close()`` stops the
        thread. Pair with ``VDISubscriber(fault=...)``."""
        if self._hb_thread is not None:
            return
        self._hb_stop = threading.Event()

        def pump():
            # wake at half the period so an idle gap is detected within
            # ~1.5 periods worst case
            while not self._hb_stop.wait(
                    self.fault.heartbeat_period_s / 2):
                self.maybe_heartbeat()

        self._hb_thread = threading.Thread(
            target=pump, daemon=True, name="vdi-publisher-heartbeat")
        self._hb_thread.start()

    def publish(self, vdi: VDI, meta: VDIMetadata) -> int:
        """Send one frame; returns wire bytes (≅ the compressed publish loop,
        VolumeFromFileExample.kt:974-1037). Any tile encodes still in
        flight post first — the frame message closes the frame AFTER its
        tiles, whatever the pool's timing."""
        self.flush_tiles()
        return self._send(vdi, meta, None)

    def publish_tile(self, vdi: VDI, meta: VDIMetadata, tile: int,
                     tiles: int, col0: int) -> int:
        """Send one finished column-block tile of a frame BEFORE the
        frame closes (the tile-wave delivery unit — docs/PERF.md "Tile
        waves"; wired to the session by `stream_tile_sink`). The
        multipart message is the frame format plus a ``tile`` header
        {tile, tiles, col0}; `VDISubscriber.receive_tile` returns the
        placement so a viewer can assemble the frame incrementally (or
        start a partial novel-view render on the columns it has).

        With ``encode_workers > 1`` the encode runs on the pool and the
        wire post is deferred (messages still go out in submission
        order; ``flush_tiles``/``publish`` forces them out) — the call
        then returns 0 and the flush accounts the bytes."""
        th = {"tile": int(tile), "tiles": int(tiles), "col0": int(col0)}
        if self.encode_workers > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(
                    max_workers=self.encode_workers,
                    thread_name_prefix="vdi-encode")
            self._enc_pending.append(
                self._pool.submit(self._encode, vdi, meta, th))
            # bound the in-flight window: post (in order) anything the
            # pool already finished, and never hold more than 2x the
            # pool width of undelivered encodes
            while self._enc_pending and (
                    self._enc_pending[0].done()
                    or len(self._enc_pending) > 2 * self.encode_workers):
                self._post(*self._enc_pending.popleft().result())
            return 0
        return self._send(vdi, meta, th)

    def flush_tiles(self) -> int:
        """Post every deferred tile encode, in submission order; returns
        the wire bytes flushed. No-op on the serial path."""
        total = 0
        while self._enc_pending:
            total += self._post(*self._enc_pending.popleft().result())
        return total

    def _send(self, vdi: VDI, meta: VDIMetadata,
              tile: Optional[dict]) -> int:
        return self._post(*self._encode(vdi, meta, tile))

    def _encode(self, vdi: VDI, meta: VDIMetadata,
                tile: Optional[dict]):
        """Deterministic encode half (quantize, delta, compress, CRC,
        header fields sans seq) — pure per tile, safe on pool threads.
        The seq-dependent wire post lives in ``_post``."""
        fidx = int(_host(meta.index))
        with _obs.get_recorder().span(
                "encode", frame=fidx,
                sink="vdi_publisher", codec=self.codec,
                precision=self.precision,
                **({"tile": tile["tile"]} if tile else {})):
            color = np.ascontiguousarray(_host(vdi.color))
            depth = np.ascontiguousarray(_host(vdi.depth))
            qscale = None
            dhead = None
            if self.precision == "qpack8":
                from scenery_insitu_tpu_torch.ops.wire import (WIRE_CODES,
                                                         qpack8_quantize_np)

                color, depth, near, far = qpack8_quantize_np(color, depth)
                qscale = [float(near), float(far)]
                meta = meta._replace(
                    precision=np.int32(WIRE_CODES[self.precision]))
                if self._delta is not None:
                    # P-frame codec: the declared shapes stay the FULL
                    # tile's code shapes; the blobs carry the record's
                    # payload (ops/delta.py) and the delta header says
                    # how to re-split it
                    from scenery_insitu_tpu_torch.io.vdi_io import (
                        pack_delta_blobs)

                    key = int(tile["tile"]) if tile else -1
                    drec = self._delta.encode(key, color, depth, near,
                                              far)
                    dhead, cblob, dblob = pack_delta_blobs(
                        drec, self.codec, self.level)
            else:
                # stamp what THIS frame ships — a meta that rode in from a
                # quantized hop must not mislabel the f32 buffers sent here
                meta = meta._replace(precision=np.int32(0))
            if dhead is None:
                cblob = compress(np.ascontiguousarray(color).tobytes(),
                                 self.codec, self.level)
                dblob = compress(np.ascontiguousarray(depth).tobytes(),
                                 self.codec, self.level)
            fields = {
                "codec": self.codec,
                "precision": self.precision,
                "qscale": qscale,
                "delta": dhead,
                "tile": tile,
                # integrity + continuity (docs/ROBUSTNESS.md): CRCs are
                # of the WIRE blobs, so truncation/corruption is caught
                # before any decompress/reshape runs on the subscriber
                "epoch": self.epoch,
                "crc": [zlib.crc32(cblob), zlib.crc32(dblob)],
                "color_shape": list(color.shape),
                "depth_shape": list(depth.shape),
                "meta": {f: _host(getattr(meta, f)).tolist()
                         for f in _META_FIELDS},
                # frame lineage (docs/OBSERVABILITY.md "Fleet tracing"):
                # frame id + origin rank + origin wall clock ride every
                # frame-bytes message; old decoders ignore unknown keys
                "tc": trace_ctx(fidx, _obs.get_recorder().rank),
            }
        return fields, cblob, dblob, fidx, tile

    def _post(self, fields: dict, cblob: bytes, dblob: bytes,
              fidx: int, tile: Optional[dict]) -> int:
        """Wire half: mint the seq and send. Loop/worker thread only —
        posts must happen in tile order (the seq is the subscriber's
        continuity check), so this is never called from the pool."""
        lineage("tile" if tile else "publish", "send", fidx,
                **({"tile": tile["tile"]} if tile else {}))
        with self._send_lock:
            # seq is minted INSIDE the lock: a background heartbeat
            # claiming a later seq but reaching the wire first would
            # make this frame read as stale at the subscriber
            fields = {**fields, "seq": self._next_seq()}
            if self.sock is None:
                self.outbox.append((fields, cblob, dblob))
                self.last_bytes = {"header": None, "color": len(cblob),
                                   "depth": len(dblob)}
                return len(cblob) + len(dblob)
            header = _msgpack().packb(fields)
            self.sock.send_multipart([header, cblob, dblob])
            self._last_send = time.monotonic()
        self.last_bytes = {"header": len(header), "color": len(cblob),
                           "depth": len(dblob)}
        return len(header) + len(cblob) + len(dblob)

    def force_iframe(self) -> None:
        """Scene cut: drop the delta codec's retained tiles so every
        tile's next record is a full I-tile (a TF change or dataset
        swap makes residuals meaningless; counted ``iframe_forced``).
        No-op when the delta codec is off."""
        if self._delta is not None:
            self._delta.reset()

    @property
    def delta_stats(self) -> Optional[dict]:
        """The delta encoder's record/byte accounting (None when off)."""
        return None if self._delta is None else dict(self._delta.stats)

    def close(self) -> None:
        try:
            self.flush_tiles()     # deferred encodes must not be lost
        except Exception:
            pass
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None
        if self.sock is not None:
            self.sock.close(linger=0)


class VDISubscriber(_ReconnectSupervisor):
    """SUB endpoint for the streamed-VDI client (novel-view rendering of
    received VDIs via ops.vdi_render).

    Hardened against the wire (docs/ROBUSTNESS.md): every message is
    validated BEFORE decode — part count, header parse, per-blob CRC32,
    then decompressed byte counts against the declared shapes × itemsize
    — and a failing message comes back as a typed ``StreamDrop`` (never
    an exception). Sequence continuity (gaps, duplicates, publisher
    restarts) is tracked per epoch and ledgered (``stream.gap``);
    ``self.stats`` counts frames/drops/gaps/heartbeats/reconnects.

    Liveness supervision is OPT-IN: construct with ``fault=`` and the
    subscriber reconnects with bounded exponential backoff
    (``stream.liveness``) after ``liveness_timeout_s`` of silence —
    pair it with a publisher that pumps ``maybe_heartbeat()``, or a
    healthy-but-slow stream would be torn down mid-frame."""

    def __init__(self, connect: str = "tcp://localhost:6655",
                 fault: Optional[FaultConfig] = None):
        from scenery_insitu_tpu_torch.ops.delta import DeltaDecoder

        self.connect = connect
        self.fault = fault or FaultConfig()
        self.last_epoch: Optional[int] = None
        self.last_seq: Optional[int] = None
        self.stats = {"frames": 0, "drops": 0, "gaps": 0, "stale": 0,
                      "heartbeats": 0, "epoch_changes": 0, "reconnects": 0,
                      "resyncs": 0}
        # wire bytes of the most recent multipart message (heartbeats
        # included) — the receive-side twin of VDIPublisher.last_bytes,
        # consumed by the hierarchical head assembler's dcn_bytes
        # accounting (parallel/hier.py)
        self.last_recv_bytes = 0
        # temporal-delta reconstruction state (docs/PERF.md "Temporal
        # deltas"): transparent — only messages carrying a delta header
        # consult it, and an epoch change resets it (the restarted
        # publisher's encoder shares no state with the old stream)
        self._delta = DeltaDecoder()
        # whole-frame transparency for `receive`: a
        # consumer that joins a TILE-granular stream mid-frame must not
        # mistake one column block for the whole frame the metadata
        # describes — tile messages assemble here and only complete
        # frames surface
        self._assembler = None
        self._init_supervision(supervised=fault is not None)
        self._open()

    def _open(self) -> None:
        zmq = _zmq()
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.SUB)
        self.sock.setsockopt(zmq.SUBSCRIBE, b"")
        self.sock.connect(self.connect)

    def _reopen(self) -> None:
        """A PUB/SUB reconnect is idempotent — worst case it
        re-subscribes to a healthy stream."""
        self.sock.close(linger=0)
        self._open()

    def receive(self, timeout_ms: Optional[int] = None
                ) -> Union[None, StreamDrop, Tuple[VDI, VDIMetadata]]:
        """Whole-frame receive. Whole-frame messages return directly;
        TILE messages (`VDIPublisher.publish_tile`) feed an internal
        `FrameAssembler` and only COMPLETE frames surface: a tile
        message's metadata describes the whole frame (window_dims names
        the FULL width), so a whole-frame consumer (the serve tier)
        handed one would render one column block as the scene. A consumer
        joining mid-stream therefore waits for the next frame whose
        tiles it saw from tile 0 — the same "first contact must wait"
        contract the temporal-delta codec has (a P/SKIP record before
        the first I-tile is a typed ``resync`` StreamDrop, never an
        error). Returns None on timeout, StreamDrop for refused
        messages, else (VDI, metadata)."""
        deadline = (None if timeout_ms is None
                    else time.monotonic() + timeout_ms / 1000.0)
        while True:
            wait = (None if deadline is None else
                    max(0, int((deadline - time.monotonic()) * 1000)))
            got = self.receive_tile(wait)
            if got is None or isinstance(got, StreamDrop):
                return got
            vdi, meta, tile = got
            if tile is None:
                return vdi, meta
            if self._assembler is None:
                self._assembler = FrameAssembler(fault=self.fault)
            out = self._assembler.add(vdi, meta, tile)
            if out is not None:
                return out
            if deadline is not None and time.monotonic() >= deadline:
                return None

    def receive_tile(self, timeout_ms: Optional[int] = None
                     ) -> Union[None, StreamDrop,
                                Tuple[VDI, VDIMetadata, Optional[dict]]]:
        """Like `receive`, but also returns the tile placement header
        ({tile, tiles, col0}) of a `VDIPublisher.publish_tile` message —
        None for whole-frame messages. Tiles of frame f arrive in
        column order before frame f closes, so a viewer can assemble
        incrementally (see `FrameAssembler`).

        Returns None on timeout, a `StreamDrop` for a message that
        failed validation, or the decoded (VDI, meta, tile) tuple.
        Heartbeats are consumed internally (they refresh liveness and
        sequence tracking) and never surface."""
        deadline = (None if timeout_ms is None
                    else time.monotonic() + timeout_ms / 1000.0)
        while True:
            self._supervise()
            if deadline is not None:
                wait = max(0.0, deadline - time.monotonic())
                if not self.sock.poll(int(wait * 1000)):
                    return None
            elif not self.sock.poll(1000):
                continue          # blocking mode: re-check liveness 1/s
            parts = self.sock.recv_multipart()
            self.last_recv_bytes = sum(len(p) for p in parts)
            got = self._decode(parts)
            if got is _HEARTBEAT:
                if deadline is not None and time.monotonic() >= deadline:
                    return None
                continue
            return got

    # ------------------------------------------------------- validation
    def _drop(self, kind: str, reason: str, epoch=None,
              seq=None, frame=None) -> StreamDrop:
        self.stats["drops"] += 1
        if kind == "stale":
            self.stats["stale"] += 1
        if kind == "resync":
            self.stats["resyncs"] += 1
        _obs.get_recorder().count("stream_drops")
        if kind == "resync":
            _obs.degrade(
                "stream.delta_resync", "stream message",
                "dropped before decode",
                "temporal-delta record without its base tile retained; "
                "recovering on the next I-tile (forced within "
                "delta.iframe_period frames)", warn=False)
        elif kind == "stale":
            _obs.degrade(
                "stream.gap", "stream message", "dropped before decode",
                "duplicate or reordered message", warn=False)
        else:
            _obs.degrade(
                "stream.integrity", "stream message",
                "dropped before decode",
                "failed integrity validation (checksum/size/shape/"
                "header)", warn=False)
        return StreamDrop(kind, reason, epoch, seq, frame)

    @staticmethod
    def _header_frame(h: dict) -> Optional[int]:
        """Best-effort frame index from a parsed header — StreamDrop
        bookkeeping only; the caller mints the drop itself."""
        try:
            return int(np.asarray(h["meta"]["index"]))
        except Exception:  # sitpu-lint: disable=SITPU-LEDGER (the caller mints the drop)
            return None

    def _track_continuity(self, h: dict) -> Optional[StreamDrop]:
        """Update epoch/seq tracking from one parsed header; returns a
        StreamDrop for stale (duplicate/reordered) messages, else None.
        Messages from pre-continuity publishers (no epoch/seq) pass."""
        epoch, seq = h.get("epoch"), h.get("seq")
        if epoch is None or seq is None:
            return None
        if self.last_epoch is not None and epoch != self.last_epoch:
            self.stats["epoch_changes"] += 1
            _obs.degrade("stream.gap", f"epoch {self.last_epoch}",
                         f"epoch {epoch}",
                         "publisher restarted (epoch changed); sequence "
                         "tracking reset", warn=False)
            self.last_seq = None
            # the restarted publisher's delta encoder starts fresh — its
            # first record per tile is an I-tile, so dropping the old
            # retained tiles loses nothing and can never patch a new
            # residual onto a stale base
            self._delta.reset()
            # partial tile frames from the old incarnation can never
            # complete (its frame indices restart too) — drop them
            # rather than pasting old-epoch tiles into new-epoch frames
            self._assembler = None
        self.last_epoch = epoch
        if self.last_seq is not None:
            d = seq_delta(seq, self.last_seq)
            if d <= 0:
                return self._drop("stale",
                                  f"seq {seq} after {self.last_seq}",
                                  epoch, seq, self._header_frame(h))
            if d > 1:
                self.stats["gaps"] += d - 1
                _obs.get_recorder().count("stream_gap_messages", d - 1)
                _obs.degrade("stream.gap", "contiguous sequence",
                             f"{d - 1} message(s) missing",
                             "sequence gap detected on the VDI stream",
                             warn=False)
        self.last_seq = seq
        return None

    def _decode(self, parts):
        """Validate one multipart message and decode it, or explain why
        not. Order matters: cheap checks (part count, header parse,
        CRC of the wire blobs) run before any decompress/reshape."""
        self._last_seen = time.monotonic()
        self._backoff.reset()
        msgpack = _msgpack()
        if len(parts) == 1:
            try:
                h = msgpack.unpackb(parts[0])
            except Exception:  # sitpu-lint: disable=SITPU-LEDGER (drops mint via _drop)
                return self._drop("malformed", "unparseable single-part "
                                               "message")
            if isinstance(h, dict) and h.get("hb"):
                self.stats["heartbeats"] += 1
                # a stale/duplicated heartbeat is counted by the
                # continuity tracker but carries no frame — heartbeats
                # NEVER surface to the caller
                self._track_continuity(h)
                return _HEARTBEAT
            return self._drop("integrity", "single-part message is not "
                                           "a heartbeat")
        if len(parts) != 3:
            return self._drop("integrity",
                              f"expected 3 parts, got {len(parts)} "
                              "(truncated multipart)")
        header, cblob, dblob = parts
        try:
            h = msgpack.unpackb(header)
            if not isinstance(h, dict):
                raise TypeError("header is not a map")
            cshape = tuple(int(x) for x in h["color_shape"])
            dshape = tuple(int(x) for x in h["depth_shape"])
            codec = h["codec"]
        except Exception as e:  # sitpu-lint: disable=SITPU-LEDGER (drops mint via _drop)
            return self._drop("malformed", f"bad header: {e!r}")
        epoch, seq = h.get("epoch"), h.get("seq")
        fidx = self._header_frame(h)
        # continuity first, ONCE: a message that is both stale and
        # corrupt is one refusal, not two ledger rows. A corrupt blob
        # still advances seq tracking — the header parsed, so the
        # message was received-and-refused, not missing (no spurious
        # gap on its successor).
        stale = self._track_continuity(h)
        if stale is not None:
            return stale
        crc = h.get("crc")
        if crc is not None and list(crc) != [zlib.crc32(cblob),
                                             zlib.crc32(dblob)]:
            return self._drop("integrity", "blob checksum mismatch",
                              epoch, seq, fidx)
        precision = h.get("precision", "f32")
        dh = h.get("delta")
        cdt, ddt = ((np.uint32, np.uint16) if precision == "qpack8"
                    else (np.float32, np.float32))
        try:
            craw = (decompress(cblob, codec) if cblob else b"")
            draw = (decompress(dblob, codec) if dblob else b"")
        except Exception as e:  # sitpu-lint: disable=SITPU-LEDGER (drops mint via _drop)
            return self._drop("integrity", f"decompress failed: {e!r}",
                              epoch, seq, fidx)
        if dh is not None:
            # delta records declare the FULL tile's shapes but carry a
            # record payload — the expected byte counts come from the
            # delta header instead (io/vdi_io.delta_expected_bytes)
            from scenery_insitu_tpu_torch.io.vdi_io import delta_expected_bytes

            try:
                want_c, want_d = delta_expected_bytes(dh, cshape, dshape)
            except Exception as e:  # sitpu-lint: disable=SITPU-LEDGER (drops mint via _drop)
                return self._drop("malformed",
                                  f"bad delta header: {e!r}", epoch,
                                  seq, fidx)
        else:
            want_c = int(np.prod(cshape)) * np.dtype(cdt).itemsize
            want_d = int(np.prod(dshape)) * np.dtype(ddt).itemsize
        if len(craw) != want_c or len(draw) != want_d:
            # a truncated/corrupt blob must be rejected HERE — handed
            # to frombuffer/reshape it would raise
            return self._drop(
                "integrity",
                f"blob bytes ({len(craw)}, {len(draw)}) != declared "
                f"shapes ({want_c}, {want_d})", epoch, seq, fidx)
        if dh is not None:
            # temporal-delta reconstruction: (retained tile + record) ->
            # the current frame's qpack8 codes, bit-exact. A record
            # whose base the decoder does not hold (an earlier message
            # was dropped) is a resync wait, not an error.
            from scenery_insitu_tpu_torch.io.vdi_io import unpack_delta_payload
            from scenery_insitu_tpu_torch.ops.wire import qpack8_dequantize_np

            try:
                cpay, dpay = unpack_delta_payload(dh, craw, draw,
                                                  cshape, dshape)
                tile_h = h.get("tile")
                key = int(tile_h["tile"]) if tile_h else -1
                near, far = h["qscale"]
                got = self._delta.apply(key, dh["mode"], int(dh["gen"]),
                                        int(dh["base"]), cpay, dpay,
                                        (float(near), float(far)))
            except Exception as e:  # sitpu-lint: disable=SITPU-LEDGER (drops mint via _drop)
                return self._drop("integrity",
                                  f"delta decode failed: {e!r}",
                                  epoch, seq, fidx)
            if got is None:
                return self._drop(
                    "resync", f"{dh['mode']} record for tile {key} "
                              f"patches generation {dh['base']} which "
                              "is not retained", epoch, seq, fidx)
            qc, qd, near, far = got
            try:
                color, depth = qpack8_dequantize_np(qc, qd, near, far)
                meta = self._unpack_meta(h)
            except Exception as e:  # sitpu-lint: disable=SITPU-LEDGER (drops mint via _drop)
                return self._drop("integrity", f"decode failed: {e!r}",
                                  epoch, seq, fidx)
            self.stats["frames"] += 1
            lineage("tile" if h.get("tile") else "publish", "recv",
                    fidx, ctx=h.get("tc"))
            return VDI(color, depth), meta, h.get("tile")
        try:
            if precision == "qpack8":
                # the publisher's pre-codec quantize pass (header
                # carries the [near, far] scale): dequantize back to f32
                from scenery_insitu_tpu_torch.ops.wire import (
                    qpack8_dequantize_np)

                qc = np.frombuffer(craw, np.uint32).reshape(cshape)
                qd = np.frombuffer(draw, np.uint16).reshape(dshape)
                near, far = h["qscale"]
                color, depth = qpack8_dequantize_np(qc, qd, near, far)
            else:
                color = np.frombuffer(craw, np.float32).reshape(cshape)
                depth = np.frombuffer(draw, np.float32).reshape(dshape)
            meta = self._unpack_meta(h)
        except Exception as e:  # sitpu-lint: disable=SITPU-LEDGER (drops mint via _drop)
            return self._drop("integrity", f"decode failed: {e!r}",
                              epoch, seq, fidx)
        self.stats["frames"] += 1
        lineage("tile" if h.get("tile") else "publish", "recv",
                fidx, ctx=h.get("tc"))
        return VDI(color, depth), meta, h.get("tile")

    @staticmethod
    def _unpack_meta(h: dict) -> VDIMetadata:
        """The header's metadata as host numpy fields (as
        ``io/vdi_io.load_vdi`` returns them)."""
        m = h["meta"]
        f32 = lambda k: np.asarray(m[k], np.float32)
        return VDIMetadata(
            projection=f32("projection").reshape(4, 4),
            view=f32("view").reshape(4, 4),
            model=f32("model").reshape(4, 4),
            volume_dims=f32("volume_dims").reshape(3),
            window_dims=np.asarray(m["window_dims"], np.int32).reshape(2),
            nw=np.float32(m["nw"]), index=np.int32(m["index"]),
            precision=np.int32(m.get("precision", 0)))

    def close(self) -> None:
        self.sock.close(linger=0)


class FrameAssembler:
    """Assemble `publish_tile` streams back into whole frames — the
    ``VideoReceiver._parts`` eviction pattern, generalized to the VDI
    tile stream (docs/ROBUSTNESS.md "Degraded frames").

    Feed it every successful `receive_tile` result; whole-frame messages
    pass straight through, tile messages accumulate per frame index and
    the frame is returned once all tiles arrived (pasted in col0 order).
    An incomplete frame is ABANDONED — ledgered ``stream.gap``, counted
    in ``stats["abandoned"]`` — once ``window`` newer frames have
    started, so one lost tile costs one frame, not unbounded memory."""

    def __init__(self, window: Optional[int] = None,
                 fault: Optional[FaultConfig] = None):
        if window is None:
            # the config-threaded default: FrameworkConfig.fault
            # (pass a session's cfg.fault here so the knob is live)
            window = (fault or FaultConfig()).assembler_window
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self._frames = {}   # frame index -> {tiles: {t: (col0, vdi)},
                            #                 total, meta}
        self._newest = None  # newest frame index ever seen
        self.stats = {"assembled": 0, "abandoned": 0, "tiles": 0,
                      "passthrough": 0, "late_tiles": 0}

    def add(self, vdi: VDI, meta: VDIMetadata, tile: Optional[dict]
            ) -> Optional[Tuple[VDI, VDIMetadata]]:
        """Returns the completed (VDI, meta) when this message closed a
        frame (or was a whole-frame message), else None."""
        if tile is None:
            self.stats["passthrough"] += 1
            return vdi, meta
        idx = int(_host(meta.index))
        if self._newest is not None and idx < self._newest - self.window:
            # straggler tile of a frame already past the eviction
            # horizon (assembled or abandoned) — re-creating its entry
            # would re-abandon it once per late tile
            self.stats["late_tiles"] += 1
            return None
        self._newest = (idx if self._newest is None
                        else max(self._newest, idx))
        entry = self._frames.setdefault(
            idx, {"tiles": {}, "total": int(tile["tiles"]), "meta": meta})
        entry["tiles"][int(tile["tile"])] = (int(tile["col0"]), vdi)
        self.stats["tiles"] += 1
        self._evict(newest=self._newest)
        if idx not in self._frames \
                or len(entry["tiles"]) < entry["total"]:
            return None
        del self._frames[idx]
        placed = sorted(entry["tiles"].values(), key=lambda cv: cv[0])
        color = np.concatenate([_host(v.color) for _, v in placed],
                               axis=-1)
        depth = np.concatenate([_host(v.depth) for _, v in placed],
                               axis=-1)
        self.stats["assembled"] += 1
        return VDI(color, depth), entry["meta"]

    def _evict(self, newest: int) -> None:
        for old in [f for f in self._frames if f < newest - self.window]:
            del self._frames[old]
            self.stats["abandoned"] += 1
            _obs.get_recorder().count("frames_abandoned")
            _obs.degrade(
                "stream.gap", "complete tile frame",
                "frame abandoned incomplete",
                f"tile loss: a frame was still incomplete after "
                f"{self.window} newer frames started", warn=False)


# ----------------------------------------------------------------- steering

def make_camera_message(cam: Camera) -> dict:
    """Viewer -> renderer camera pose (≅ the msgpack camera payload,
    VolumeFromFileExample.kt:907-918). Carries the whole camera, near
    and far included: a re-rendering consumer generates its rays through
    this pose, and the near plane takes part in ray generation
    (steering consumers ignore the extra fields)."""
    return {"type": "camera",
            "eye": _host(cam.eye).tolist(),
            "target": _host(cam.target).tolist(),
            "up": _host(cam.up).tolist(),
            "fov_y": float(_host(cam.fov_y)),
            "near": float(_host(cam.near)),
            "far": float(_host(cam.far))}


def make_tf_message(points, colormap: str = "hot") -> dict:
    """Viewer -> renderer transfer-function update (≅ updateVis's TF
    payload, DistributedVolumeRenderer.kt:747-774 — there dispatched by
    payload size, here an explicit type). ``points`` are (value, alpha)
    control points; the session rebuilds its TF and swaps the affected
    steps (knot arrays are fixed-shape, so no shape changes)."""
    return {"type": "tf",
            "points": [[float(v), float(a)] for v, a in points],
            "colormap": str(colormap)}


def tf_from_message(msg: dict, device=None):
    """The TransferFunction a ``tf`` steering message describes, on
    ``device`` (None: CUDA)."""
    from scenery_insitu_tpu_torch.core.transfer import TransferFunction

    return TransferFunction.points(
        [tuple(p) for p in msg["points"]],
        colormap=msg.get("colormap", "hot"), device=device)


def apply_steering(cam: Camera, msg: dict) -> Tuple[Camera, dict]:
    """Apply one steering message; returns (camera, side_effects). A
    ``camera`` message moves the camera (on the camera's device); other
    types pass through in side_effects, keyed by type (≅ updateVis
    dispatch, DistributedVolumeRenderer.kt:747-774)."""
    kind = msg.get("type")
    if kind == "camera":
        dev = cam.eye.device
        f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32),
                                        device=dev)
        cam = cam._replace(
            eye=f32(msg["eye"]),
            target=f32(msg.get("target", _host(cam.target))),
            up=f32(msg.get("up", _host(cam.up))))
        if "fov_y" in msg:
            cam = cam._replace(fov_y=f32(msg["fov_y"]))
        return cam, {}
    return cam, {kind: msg}


class SteeringEndpoint(_ReconnectSupervisor):
    """Renderer-side SUB socket draining steering messages each frame.

    The socket is network-facing: one malformed or oversized message
    must not kill an in-situ run mid-simulation. ``drain`` therefore
    validates per message — size cap first (before unpack), then msgpack
    parse, then "is it a dict" — drops failures on the
    ``stream.steering`` ledger and KEEPS draining. Heartbeats
    (``{"hb": 1}``) refresh liveness and are consumed; past
    ``fault.liveness_timeout_s`` with no traffic the endpoint re-opens
    its socket with bounded backoff (liveness is opt-in here: steering
    is bursty, so the default FaultConfig applies only when ``fault`` is
    passed — pass one to enable supervision)."""

    def __init__(self, connect_or_bind: str = "tcp://*:6656",
                 bind: bool = True, fault: Optional[FaultConfig] = None):
        # None = liveness supervision off (idle viewers are normal);
        # the size cap still applies with the default FaultConfig
        self.fault = fault or FaultConfig()
        self.bind = bind
        self.stats = {"messages": 0, "dropped": 0, "heartbeats": 0,
                      "reconnects": 0}
        self._init_supervision(supervised=fault is not None)
        zmq = _zmq()
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.SUB)
        self.sock.setsockopt(zmq.SUBSCRIBE, b"")
        if bind and connect_or_bind.endswith(":0"):
            port = self.sock.bind_to_random_port(connect_or_bind[:-2])
            # the REAL re-bindable address keeps the wildcard host; the
            # display/connect endpoint rewrites it for local viewers
            self._addr = f"{connect_or_bind[:-2]}:{port}"
            self.endpoint = (f"{connect_or_bind[:-2].replace('*', '127.0.0.1')}"
                             f":{port}")
        elif bind:
            self.sock.bind(connect_or_bind)
            self._addr = connect_or_bind
            self.endpoint = connect_or_bind.replace("*", "127.0.0.1")
        else:
            self.sock.connect(connect_or_bind)
            self._addr = connect_or_bind
            self.endpoint = connect_or_bind

    def _reopen(self) -> None:
        """Tear down and re-establish the socket on the ORIGINAL address
        (a '*' bind must stay a wildcard bind — rewriting it to the
        loopback display form would cut off every remote viewer)."""
        zmq = _zmq()
        self.sock.close(linger=0)
        self.sock = self.ctx.socket(zmq.SUB)
        self.sock.setsockopt(zmq.SUBSCRIBE, b"")
        if self.bind:
            self.sock.bind(self._addr)
        else:
            self.sock.connect(self._addr)

    _what = "steering"

    def _drop_steering(self, why: str) -> None:
        self.stats["dropped"] += 1
        _obs.get_recorder().count("steering_drops")
        _obs.degrade("stream.steering", "steering message", "dropped",
                     why, warn=False)

    def drain(self) -> Iterator[dict]:
        zmq = _zmq()
        self._supervise()
        while True:
            try:
                raw = self.sock.recv(zmq.NOBLOCK)
            except zmq.Again:
                return
            self._last_seen = time.monotonic()
            if len(raw) > self.fault.max_message_bytes:
                self._drop_steering(
                    "message exceeds fault.max_message_bytes")
                continue
            try:
                msg = _msgpack().unpackb(raw)
            except Exception:
                self._drop_steering("unparseable msgpack from the "
                                    "network-facing socket")
                continue
            if not isinstance(msg, dict):
                self._drop_steering("steering payload is not a map")
                continue
            if msg.get("hb"):
                self.stats["heartbeats"] += 1
                continue
            self.stats["messages"] += 1
            yield msg

    def close(self) -> None:
        self.sock.close(linger=0)


class SteeringPublisher(_HeartbeatPacer):
    """Viewer-side PUB socket (≅ the ZMQ publisher feeding InSituMaster)."""

    def __init__(self, connect: str,
                 fault: Optional[FaultConfig] = None):
        zmq = _zmq()
        self.fault = fault or FaultConfig()
        self._last_send = time.monotonic()
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.PUB)
        self.sock.connect(connect)

    def send(self, msg: dict) -> None:
        self.sock.send(_msgpack().packb(msg))
        self._last_send = time.monotonic()

    def heartbeat(self) -> None:
        """Idle keepalive so a supervised SteeringEndpoint can tell a
        quiet viewer from a dead one."""
        self.send({"hb": 1})

    def close(self) -> None:
        self.sock.close(linger=0)


class SteeringRelay:
    """Headless relay: SUB upstream, PUB to every render endpoint
    (≅ InSituMaster forwarding payloads to all ranks via MPI broadcast,
    InSituMaster.kt:14-45 — here the fan-out is a PUB socket)."""

    def __init__(self, upstream_bind: str = "tcp://*:6655",
                 downstream_bind: str = "tcp://*:6656"):
        zmq = _zmq()
        self.ctx = zmq.Context.instance()
        self.sub = self.ctx.socket(zmq.SUB)
        self.sub.setsockopt(zmq.SUBSCRIBE, b"")
        self.pub = self.ctx.socket(zmq.PUB)
        for sock, ep in ((self.sub, upstream_bind), (self.pub, downstream_bind)):
            if ep.endswith(":0"):
                port = sock.bind_to_random_port(ep[:-2])
                ep = f"{ep[:-2].replace('*', '127.0.0.1')}:{port}"
            else:
                sock.bind(ep)
                ep = ep.replace("*", "127.0.0.1")
            if sock is self.sub:
                self.upstream = ep
            else:
                self.downstream = ep

    def pump(self, max_messages: int = 64) -> int:
        """Forward pending messages; returns count."""
        zmq = _zmq()
        n = 0
        for _ in range(max_messages):
            try:
                self.pub.send(self.sub.recv(zmq.NOBLOCK))
                n += 1
            except zmq.Again:
                break
        return n

    def close(self) -> None:
        self.sub.close(linger=0)
        self.pub.close(linger=0)


def stream_tile_sink(publisher: VDIPublisher) -> Callable[[int, dict], None]:
    """Session TILE sink (``InSituSession.tile_sinks``) publishing every
    delivered column-block tile the moment the session fetches it —
    paired with ``composite.schedule = "waves"``, subscribers see the
    frame's first columns while later tiles are still in flight
    (docs/PERF.md "Tile waves"). Tile payloads arrive as host numpy
    arrays and are published as-is — no device round trip on the
    latency-motivated path."""

    def sink(index: int, payload: dict) -> None:
        if "vdi_color" not in payload or "tile" not in payload:
            return
        publisher.publish_tile(
            VDI(payload["vdi_color"], payload["vdi_depth"]),
            payload["meta"], payload["tile"], payload["tiles"],
            payload["col0"])

    return sink


def stream_sink(publisher: VDIPublisher) -> Callable[[int, dict], None]:
    """Session sink that publishes every fetched VDI frame (≅ transmitVDIs
    mode, VolumeFromFileExample.kt:996-1037). Requires payloads carrying
    ``meta`` (InSituSession provides it)."""

    def sink(index: int, payload: dict) -> None:
        if "vdi_color" not in payload or "meta" not in payload:
            return
        publisher.publish(VDI(payload["vdi_color"], payload["vdi_depth"]),
                          payload["meta"])

    return sink


# -------------------------------------------------------- live video stream

class VideoStreamer:
    """LIVE video over UDP (≅ the reference's H264/UDP:3337 stream,
    DistributedVolumeRenderer.kt:275-291). This image ships no
    ffmpeg/libx264, so frames go out as JPEG (cv2.imencode) — the MJPEG
    transport role of the reference's stream, same socket shape. Frames
    larger than one datagram are chunked ``[magic, frame, part, nparts,
    t_origin | payload]``; receivers reassemble and drop incomplete
    frames (UDP semantics: newest complete frame wins, stalls never
    block the renderer). ``t_origin`` (f64 unix seconds, stamped once
    per frame) is the frame-lineage trace context of this hop
    (docs/OBSERVABILITY.md "Fleet tracing")."""

    MAGIC = b"SIVD"
    CHUNK = 60000
    HEADER = "!4sIHHd"
    HEADER_BYTES = 20

    def __init__(self, host: str = "127.0.0.1", port: int = 3337,
                 quality: int = 85, gamma: float = 2.2):
        import socket

        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.quality = quality
        self.gamma = gamma
        self.frame_id = 0

    def send_frame(self, img: np.ndarray) -> int:
        """img f32[4, H, W] premultiplied -> JPEG datagrams; returns bytes
        sent."""
        import struct

        import cv2

        with _obs.get_recorder().span("encode", frame=self.frame_id,
                                      sink="video_streamer"):
            rgb = np.clip(_host(img)[:3], 0.0, 1.0) ** (1.0 / self.gamma)
            frame = (np.moveaxis(rgb, 0, -1) * 255).astype(np.uint8)
            ok, jpg = cv2.imencode(".jpg", frame[:, :, ::-1],
                                   [cv2.IMWRITE_JPEG_QUALITY, self.quality])
        if not ok:
            return 0
        blob = jpg.tobytes()
        nparts = -(-len(blob) // self.CHUNK)
        sent = 0
        t_origin = time.time()
        for p in range(nparts):
            payload = blob[p * self.CHUNK:(p + 1) * self.CHUNK]
            head = struct.pack(self.HEADER, self.MAGIC,
                               self.frame_id & 0xFFFFFFFF, p, nparts,
                               t_origin)
            sent += self.sock.sendto(head + payload, self.addr)
        lineage("video", "send", self.frame_id)
        # wrap in lockstep with the u32 wire field — the receiver's
        # eviction compares in wrap-aware sequence space (seq_delta)
        self.frame_id = (self.frame_id + 1) & SEQ_MASK
        return sent

    def close(self) -> None:
        self.sock.close()


class VideoReceiver:
    """Receiving end of VideoStreamer (a viewer/monitor process)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 3337,
                 timeout_s: float = 1.0):
        import socket

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.sock.settimeout(timeout_s)
        self.port = self.sock.getsockname()[1]
        self._parts = {}

    def receive_frame(self) -> Optional[np.ndarray]:
        """Blocks up to the timeout for one COMPLETE frame -> u8[H, W, 3]
        RGB, or None."""
        import socket as _socket
        import struct

        import cv2

        deadline = time.monotonic() + self.sock.gettimeout()
        while time.monotonic() < deadline:
            try:
                pkt, _ = self.sock.recvfrom(65536)
            except (_socket.timeout, TimeoutError):
                return None
            hb = VideoStreamer.HEADER_BYTES
            if len(pkt) < hb or pkt[:4] != VideoStreamer.MAGIC:
                continue
            _, fid, part, nparts, t_origin = struct.unpack(
                VideoStreamer.HEADER, pkt[:hb])
            if nparts == 0 or part >= nparts:
                continue                                   # corrupt/foreign
            parts = self._parts.setdefault(fid, {})
            parts[part] = pkt[hb:]
            # evict incomplete older frames (lost datagrams must not
            # leak) — wrap-aware: the u32 frame id wraps on long
            # streams, and an unwrapped `f < fid - 4` would both leak
            # the pre-wrap entries forever and mis-evict post-wrap ones
            for old in [f for f in self._parts
                        if seq_delta(fid, f) > 4]:
                del self._parts[old]
            if all(p in parts for p in range(nparts)):
                blob = b"".join(parts[p] for p in range(nparts))
                del self._parts[fid]
                img = cv2.imdecode(np.frombuffer(blob, np.uint8),
                                   cv2.IMREAD_COLOR)
                if img is None:
                    continue
                lineage("viewer", "recv", int(fid),
                        ctx={"frame": int(fid), "t": t_origin})
                return img[:, :, ::-1]                     # BGR -> RGB
        return None

    def close(self) -> None:
        self.sock.close()


def _payload_image(payload: dict) -> Optional[np.ndarray]:
    """Session payload -> displayable premultiplied image (decodes VDI
    payloads to the same-view image). Shared by every video sink."""
    if "image" in payload:
        return _host(payload["image"])
    if "vdi_color" in payload:
        from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
        return render_vdi_same_view(
            VDI(torch.as_tensor(payload["vdi_color"]),
                torch.as_tensor(payload["vdi_depth"]))).cpu().numpy()
    return None


def live_video_sink(streamer: VideoStreamer) -> Callable[[int, dict], None]:
    """Session sink streaming every fetched frame live."""

    def sink(index: int, payload: dict) -> None:
        img = _payload_image(payload)
        if img is not None:
            streamer.send_frame(img)

    return sink


# -------------------------------------------------------------- video sinks

def _open_video_writer(path: str, fps: float, size: Tuple[int, int]):
    """Open a cv2 VideoWriter, preferring a real H264 encoder when the
    cv2 build ships one (the reference streams H264 —
    DistributedVolumeRenderer.kt:275-291 VideoEncoder → UDP:3337). Probes
    avc1/H264 and falls back to mp4v. This image's cv2 carries no
    libx264/openh264 and no ffmpeg/PyAV exists either (checked 2026-07-31),
    so mp4v is the expected outcome for THIS cv2 path; a guaranteed real
    H264 bitstream is available regardless via the vendored I_PCM writer
    (`io/h264.py`, ``video_sink(..., codec="h264_ipcm")``) — conformance
    pinned by decoding through cv2's H264 decoder in tests/test_h264.py.
    A failed probe may print cv2/ffmpeg codec errors to stderr once
    (native-layer prints, not exceptions); the fallback proceeds
    regardless. Returns (writer, fourcc_used)."""
    import cv2

    for cc in ("avc1", "H264"):
        try:
            w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*cc), fps, size)
        except cv2.error:
            continue
        if w.isOpened():
            return w, cc
        w.release()
    return (cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                            size), "mp4v")


def video_sink(path: str, fps: float = 30.0, gamma: float = 2.2,
               codec: str = "auto") -> Callable[[int, dict], None]:
    """Movie-writer sink for session image payloads (≅ the reference's
    VideoEncoder movie file, DistributedVolumeRenderer.kt:285). Lazily opens
    the writer on the first frame (size unknown until then); the codec
    actually used is exposed as ``sink.codec`` after that.

    ``codec="auto"`` (default): cv2 writer, H264 when the build has an
    encoder, else mp4v (`_open_video_writer`). ``codec="h264_ipcm"``:
    the vendored always-available REAL H264 elementary stream
    (io/h264.h264_sink — all-intra I_PCM, lossless in YUV, large files;
    give ``path`` an .h264 extension so players treat it as an
    elementary stream)."""
    if codec == "h264_ipcm":
        from scenery_insitu_tpu_torch.io.h264 import h264_sink

        inner = h264_sink(path, gamma=gamma, fps=fps)

        def sink(index: int, payload: dict) -> None:
            img = _payload_image(payload)
            if img is not None:
                inner(img)

        sink.codec = inner.codec
        sink.release = inner.close
        return sink
    if codec != "auto":
        raise ValueError(f"unknown video codec {codec!r} "
                         "(expected 'auto' or 'h264_ipcm')")
    state = {"writer": None}

    def sink(index: int, payload: dict) -> None:
        img = _payload_image(payload)
        if img is None:
            return
        rgb = np.clip(img[:3], 0.0, 1.0) ** (1.0 / gamma)
        frame = (np.moveaxis(rgb, 0, -1) * 255).astype(np.uint8)
        if state["writer"] is None:
            h, w = frame.shape[:2]
            state["writer"], sink.codec = _open_video_writer(
                path, fps, (w, h))
        state["writer"].write(frame[:, :, ::-1])          # RGB -> BGR

    sink.codec = None
    sink.release = lambda: (state["writer"].release()
                            if state["writer"] else None)
    return sink
