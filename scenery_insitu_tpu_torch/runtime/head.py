"""The head/display node — a standalone viewer process assembling remote
render ranks' images (≅ Head.kt: a master node that receives each rank's
color+depth planes, binds them as ColorBuffer$rank/DepthBuffer$rank and
min-depth composites on a fullscreen quad, Head.kt:40-183 +
NaiveCompositor.frag:15-28; its camera moves are published back over ZMQ,
Head.kt:137-161).

Here the head is transport + numpy: render ranks PUSH ``[msgpack header |
image blob | depth blob]`` per frame (``RankImageSender``), the head
collects one set per frame index, depth-min composites
(ops.composite.composite_depth_min semantics, done in numpy — the head
node owns no accelerator), and hands frames to sinks (PNG, movie, live
UDP video). Steering messages go back through the ordinary
SteeringPublisher → SteeringRelay → render ranks chain.

The port of the reference's ``runtime/head.py``: the head owns no
accelerator, so it is the same numpy, and its senders take the session's
tensors (on any device) or arrays.

Run standalone:  python -m scenery_insitu_tpu_torch.runtime.head --ranks 2
                 [--bind tcp://*:6677] [--frames 10] [--out dir/]
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from scenery_insitu_tpu_torch import obs as _obs
from scenery_insitu_tpu_torch.obs.collector import lineage, trace_ctx
from scenery_insitu_tpu_torch.runtime.failsafe import SinkGuard
from scenery_insitu_tpu_torch.runtime.streaming import _host, _msgpack, _zmq

Sink = Callable[[int, dict], None]


class RankImageSender:
    """Render-rank side: push this rank's (image, depth) per frame to the
    head (≅ the MPI iSend of image planes the reference's ranks did,
    SharedSpheresExample.kt:174-207 / scenery's client mode)."""

    def __init__(self, rank: int, connect: str = "tcp://localhost:6677"):
        zmq = _zmq()
        self.rank = rank
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.PUSH)
        self.sock.connect(connect)

    def send(self, frame: int, image: np.ndarray, depth: np.ndarray) -> None:
        """image f32[4, H, W] premultiplied; depth f32[H, W] (+inf empty)."""
        image = np.ascontiguousarray(_host(image), np.float32)
        depth = np.ascontiguousarray(_host(depth), np.float32)
        header = _msgpack().packb({
            "rank": self.rank, "frame": int(frame),
            "image_shape": list(image.shape),
            "depth_shape": list(depth.shape),
            "tc": trace_ctx(frame, self.rank)})
        self.sock.send_multipart([header, image.tobytes(), depth.tobytes()])
        lineage("head", "send", int(frame), rank=self.rank)

    def close(self) -> None:
        self.sock.close(linger=0)


def depth_min_composite_np(images: List[np.ndarray],
                           depths: List[np.ndarray]
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel nearest-rank pick (numpy twin of ops.composite
    .composite_depth_min; ≅ NaiveCompositor.frag:15-28)."""
    imgs = np.stack(images)                                # [n, 4, H, W]
    deps = np.stack(depths)                                # [n, H, W]
    idx = np.argmin(deps, axis=0)                          # [H, W]
    img = np.take_along_axis(imgs, idx[None, None], axis=0)[0]
    dep = np.take_along_axis(deps, idx[None], axis=0)[0]
    return img, dep


class HeadNode:
    """Collect per-rank frames, composite complete sets, feed sinks.

    Per-rank liveness (docs/ROBUSTNESS.md): a rank silent for
    ``stale_frames`` frames is marked DOWN (``head.rank_down`` ledger)
    and subsequent frames composite WITHOUT it — the payload carries
    ``degraded=True`` + ``missing_ranks`` so sinks can flag the frame —
    and the rank is re-admitted the moment it sends again. Malformed
    rank messages are dropped on the ``stream.integrity`` ledger
    instead of killing the pump, and sinks run behind a ``SinkGuard``
    (a repeatedly-throwing sink is quarantined, not fatal)."""

    def __init__(self, num_ranks: int, bind: str = "tcp://*:6677",
                 sinks: Tuple[Sink, ...] = (), stale_frames: int = 8,
                 max_sink_failures: int = 3):
        zmq = _zmq()
        self.n = num_ranks
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.PULL)
        if bind.endswith(":0"):
            port = self.sock.bind_to_random_port(bind[:-2])
            self.endpoint = f"{bind[:-2].replace('*', '127.0.0.1')}:{port}"
        else:
            self.sock.bind(bind)
            self.endpoint = bind.replace("*", "127.0.0.1")
        self.sinks = list(sinks)
        self.stale_frames = stale_frames
        self._pending: Dict[int, Dict[int, Tuple[np.ndarray, np.ndarray]]] = {}
        self.frames_composited = 0
        self.frames_degraded = 0
        self.latest: Optional[np.ndarray] = None
        self.down: set = set()          # ranks currently marked down
        self._last_frame: Dict[int, int] = {}  # rank -> newest frame seen
        self._newest: Optional[int] = None     # newest frame index seen
        self._first: Optional[int] = None      # first frame index seen
        self._done: set = set()         # recently composited frame indices
        # frame-index plausibility window: a jump beyond this resets the
        # stream bookkeeping instead of being trusted into _newest
        self._max_jump = max(1000, 16 * stale_frames)
        self._guard = SinkGuard(max_sink_failures, domain="head")

    # ---------------------------------------------------------- liveness
    def _mark_down(self) -> bool:
        """Ranks (0..n-1 by the sender contract) whose newest
        contribution lags the stream by more than stale_frames are
        down; never-seen ranks count from the first frame observed.
        Returns True when the down set grew (pending frames must be
        re-checked against the shrunken live set)."""
        if self._newest is None:
            return False
        grew = False
        floor = self._first if self._first is not None else self._newest
        for r in range(self.n):
            if r in self.down:
                continue
            last = self._last_frame.get(r, floor - 1)
            if self._newest - last > self.stale_frames:
                self.down.add(r)
                grew = True
                _obs.get_recorder().count("head_ranks_down")
                _obs.degrade(
                    "head.rank_down", f"rank {r} contributing",
                    "compositing without it",
                    f"rank silent for more than stale_frames="
                    f"{self.stale_frames} frames; re-admitted on "
                    "return", warn=False)
        return grew

    def _readmit(self, rank: int) -> None:
        """Re-admit a down rank only once it has CAUGHT UP to within the
        stale horizon — a rank that keeps sending but stays lagged would
        otherwise flap up/down on every message, turning the liveness
        counters into churn."""
        if rank not in self.down:
            return
        if self._newest is not None and \
                self._newest - self._last_frame.get(rank, 0) \
                > self.stale_frames:
            return
        self.down.discard(rank)
        _obs.get_recorder().count("head_ranks_readmitted")
        _obs.get_recorder().event("head_rank_up", rank=rank)

    # --------------------------------------------------------- composite
    def _composite(self, frame: int,
                   ranks: Dict[int, Tuple[np.ndarray, np.ndarray]]
                   ) -> None:
        imgs = [ranks[r][0] for r in sorted(ranks)]
        deps = [ranks[r][1] for r in sorted(ranks)]
        out, dmin = depth_min_composite_np(imgs, deps)
        self.latest = out
        self.frames_composited += 1
        payload = {"image": out, "depth": dmin, "frame": frame}
        missing = sorted(set(range(self.n)) - set(ranks))
        if missing:
            # degraded-frame semantics (docs/ROBUSTNESS.md): the frame
            # ships, flagged, rather than stalling the whole stream on
            # a dead rank
            payload["degraded"] = True
            payload["missing_ranks"] = missing
            self.frames_degraded += 1
            _obs.get_recorder().count("head_degraded_frames")
        lineage("composite", "send", frame, ranks=len(ranks))
        self._guard.run(self.sinks, frame, payload, kind="head sink")

    def pump(self, timeout_ms: int = 100) -> int:
        """Receive pending rank messages; composite every completed frame
        set; returns number of frames composited this call."""
        _zmq()                  # fail fast if pyzmq is missing
        done = 0
        while self.sock.poll(timeout_ms):
            parts = self.sock.recv_multipart()
            try:
                header, iblob, dblob = parts
                h = _msgpack().unpackb(header)
                img = np.frombuffer(iblob, np.float32) \
                    .reshape(h["image_shape"])
                dep = np.frombuffer(dblob, np.float32) \
                    .reshape(h["depth_shape"])
                frame = int(h["frame"])
                rank = int(h["rank"])
                # parseable-but-inconsistent messages must be refused
                # HERE: a ragged set reaching np.stack in the composite
                # would kill the pump
                if not 0 <= rank < self.n:
                    raise ValueError(f"rank {rank} outside 0..{self.n}")
                if frame < 0:
                    raise ValueError(f"negative frame {frame}")
                if img.ndim != 3 or dep.shape != img.shape[1:]:
                    raise ValueError("depth/image shape mismatch")
                peers = self._pending.get(frame)
                if peers:
                    p_img, _ = next(iter(peers.values()))
                    if p_img.shape != img.shape:
                        raise ValueError(
                            "image shape disagrees with this frame's "
                            "other ranks")
            except Exception:
                _obs.degrade(
                    "stream.integrity", "head rank message",
                    "dropped before composite",
                    "malformed rank frame (part count, header, blob "
                    "size/shape, rank/frame range, or cross-rank shape "
                    "mismatch)", warn=False)
                timeout_ms = 0
                continue
            lineage("head", "recv", frame, ctx=h.get("tc"), rank=rank)
            if self._newest is not None and \
                    abs(frame - self._newest) > self._max_jump:
                # a frame index wildly outside the plausible window —
                # a corrupt-but-parseable counter or a restarted sender
                # session. Treating it as truth would poison liveness
                # and eviction (one absurd index silently refuses every
                # real frame after it); reset the stream bookkeeping
                # instead and start over from this message.
                _obs.degrade(
                    "stream.gap", f"head stream at frame {self._newest}",
                    f"reset to frame {frame}",
                    "frame index jumped beyond the plausibility window; "
                    "head stream state reset (sender restart or corrupt "
                    "counter)", warn=False)
                self._pending.clear()
                self._done.clear()
                self._last_frame.clear()
                self.down.clear()
                self._newest = self._first = None
            self._newest = (frame if self._newest is None
                            else max(self._newest, frame))
            if self._first is None:
                self._first = frame
            self._last_frame[rank] = max(self._last_frame.get(rank,
                                                              frame),
                                         frame)
            self._readmit(rank)
            down_grew = self._mark_down()
            if frame in self._done or frame < self._newest - self.stale_frames:
                # late data for a frame already shipped or already past
                # the eviction horizon (a rank lagging further than the
                # _done set remembers) — a second, more-degraded
                # composite of the same index would misorder the sinks
                timeout_ms = 0
                continue
            self._pending.setdefault(frame, {})[rank] = (img, dep)
            # a frame completes when every LIVE rank contributed (down
            # ranks' late data still composites if it arrived in time).
            # When a rank just went down, every OLDER pending frame was
            # waiting on it too — re-check them all, oldest first, so
            # they ship before newer frames rather than trailing out of
            # order through the eviction path.
            live = set(range(self.n)) - self.down
            check = (sorted(self._pending) if down_grew else
                     [frame] if frame in self._pending else [])
            for f in check:
                if live <= set(self._pending[f]):
                    self._composite(f, self._pending.pop(f))
                    self._done.add(f)
                    done += 1
            # stragglers that can never complete — on EVERY message, not
            # only on completion (a dead rank must not leak the live
            # ranks' frames forever). Non-empty sets composite DEGRADED
            # instead of vanishing: partial work beats a dropped frame.
            for old in sorted(f for f in self._pending
                              if f < self._newest - self.stale_frames):
                # no _done bookkeeping needed for evicted frames: they
                # are past the horizon, so the frame-age check above
                # already refuses any late re-contribution
                self._composite(old, self._pending.pop(old))
                done += 1
            # _done only needs to remember frames still inside the
            # horizon (older ones are refused by the age check)
            self._done -= {f for f in self._done
                           if f < self._newest - self.stale_frames}
            timeout_ms = 0                                 # drain non-blocking
        return done

    def run(self, frames: int, timeout_s: float = 60.0) -> int:
        """Pump until ``frames`` sets composited or timeout; returns count."""
        t0 = time.monotonic()
        while (self.frames_composited < frames
               and time.monotonic() - t0 < timeout_s):
            self.pump(timeout_ms=100)
        return self.frames_composited

    def close(self) -> None:
        self.sock.close(linger=0)


def head_sender_sink(sender: RankImageSender) -> Sink:
    """Session sink forwarding plain/particle frames to the head node
    (payloads with image+depth — the particle and plain modes)."""

    def sink(index: int, payload: dict) -> None:
        if "image" in payload and "depth" in payload:
            sender.send(index, payload["image"], payload["depth"])

    return sink


if __name__ == "__main__":
    import argparse
    import os

    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--bind", default="tcp://*:6677")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default=None, help="PNG output directory")
    ap.add_argument("--video-port", type=int, default=0,
                    help="also stream composited frames over UDP")
    args = ap.parse_args()

    sinks = []
    if args.out:
        from scenery_insitu_tpu_torch.utils.image import save_png

        os.makedirs(args.out, exist_ok=True)
        sinks.append(lambda i, p: save_png(
            os.path.join(args.out, f"head{i:05d}.png"), p["image"]))
    if args.video_port:
        from scenery_insitu_tpu_torch.runtime.streaming import (VideoStreamer,
                                                          live_video_sink)

        sinks.append(live_video_sink(VideoStreamer(port=args.video_port)))

    head = HeadNode(args.ranks, args.bind, tuple(sinks))
    print(f"[head] listening on {head.endpoint} for {args.ranks} ranks",
          flush=True)
    got = head.run(args.frames)
    print(f"[head] composited {got} frames", flush=True)
