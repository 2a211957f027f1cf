"""Fleet telemetry side-channel: per-process obs batches -> ONE trace.

The Recorder is process-local and post-hoc; a multi-process fleet (render
ranks -> head -> serve) therefore has no cross-process answer to "where
did this frame's time go". This module closes that gap with three small
pieces, a copy of the reference's ``obs/collector.py`` whose batches and
trace records read the same, so a publisher of either package feeds a
collector of the other:

- **trace context** helpers (``trace_ctx``/``lineage``): a compact dict
  ``{"frame", "src", "t"}`` threaded through every wire header that
  carries frame bytes. Senders stamp it, receivers mint a ``lineage``
  instant event; the merged trace joins those instants into flow arrows
  following a frame's sim -> march -> exchange -> composite -> publish
  -> serve -> viewer arc.
- **ObsPublisher**: each process PUBs its Recorder's event backlog as
  batched, zlib-compressed JSON over ZMQ, and pings the collector's
  heartbeat ROUTER from a DEALER to estimate its clock offset
  (``offset = tc - (t0 + rtt/2)``, error bound +-rtt/2). Loss-tolerant
  by construction: every socket op is non-blocking with a small HWM - a
  dead or slow collector costs dropped batches (counted and ledgered
  ``obs.collector``), never a stalled render loop.
- **Collector**: binds the SUB + ROUTER pair, drains batches, answers
  pings with its own clock, and merges everything into a single
  multi-track Perfetto trace (pid = rank) on the collector's timebase,
  with flow events binding each frame's lineage across process tracks.

Import is torch-free and zmq-lazy so any module can use the helpers.
"""

from __future__ import annotations

import json
import time
import zlib
from typing import Any, Dict, List, Optional

from scenery_insitu_tpu_torch.obs import recorder as _rec

_DROP_REASON = ("collector unreachable or slow (non-blocking send "
                "would block, or heartbeats unanswered); telemetry "
                "batch dropped, render loop unaffected")
_NOZMQ_REASON = "pyzmq unavailable; fleet telemetry side-channel is inert"

# Stages in canonical arc order — used only for stable tie-breaks when
# two lineage instants land on the same aligned microsecond.
ARC_ORDER = ("sim", "march", "exchange", "composite", "publish",
             "tile", "head", "serve", "video", "viewer")


def trace_ctx(frame: int, src: int) -> Dict[str, Any]:
    """The wire trace context: frame id, origin rank, origin wall
    clock. Senders embed it under the ``"tc"`` header key; decoders that
    predate it ignore unknown keys, so the wire stays compatible."""
    return {"frame": int(frame), "src": int(src),
            "t": round(time.time(), 6)}


def lineage(stage: str, role: str, frame: Optional[int],
            ctx: Optional[dict] = None,
            rec: Optional[_rec.Recorder] = None, **attrs) -> None:
    """Mint one ``lineage`` instant on the active recorder: ``stage`` is
    the arc hop (publish/serve/...), ``role`` is ``"send"`` or
    ``"recv"``. A receive with the sender's ``ctx`` also records the
    origin stamp and the wall-clock age of the bytes — the raw material
    for cross-process flow arrows and camera-to-pixel spans."""
    rec = rec or _rec.get_recorder()
    if not rec.enabled:
        return
    if ctx:
        frame = ctx.get("frame", frame)
        attrs["src"] = ctx.get("src")
        t0 = ctx.get("t")
        if t0:
            attrs["t_origin"] = t0
            attrs["age_ms"] = round((time.time() - t0) * 1e3, 3)
    rec.event("lineage", frame=frame, stage=stage, role=role, **attrs)


# ------------------------------------------------------------- publisher

class ObsPublisher:
    """Per-process telemetry publisher. ``pump(recorder)`` on the frame
    loop ships the recorder's new events since the last pump; everything
    is non-blocking and drop-on-pressure."""

    def __init__(self, endpoint: str, hb_endpoint: str = "",
                 rank: int = 0, interval_s: float = 0.25,
                 max_batch_events: int = 10_000):
        self.rank = rank
        self.interval_s = interval_s
        self.max_batch_events = max_batch_events
        self.clock_offset = 0.0     # collector clock minus local clock
        self.rtt = 0.0              # of the offset sample kept (min-RTT)
        self.batches = 0
        self.drops = 0
        self._cursor = 0
        self._seq = 0
        self._last_pump = 0.0
        self._unanswered = 0    # pings sent since the last pong
        self._seen = set()      # ranks the collector reports ingested
        self._pub = self._hb = self._ctx = None
        try:
            import zmq
        except ImportError:
            _rec.degrade("obs.collector", "publish", "disabled",
                         _NOZMQ_REASON, warn=False)
            return
        self._zmq = zmq
        self._ctx = zmq.Context.instance()
        self._pub = self._ctx.socket(zmq.PUB)
        self._pub.setsockopt(zmq.SNDHWM, 16)
        self._pub.setsockopt(zmq.LINGER, 0)
        self._pub.connect(endpoint)
        if hb_endpoint:
            self._hb = self._ctx.socket(zmq.DEALER)
            self._hb.setsockopt(zmq.SNDHWM, 4)
            self._hb.setsockopt(zmq.LINGER, 0)
            self._hb.connect(hb_endpoint)

    # ------------------------------------------------------------ clocks
    def _heartbeat(self) -> None:
        """Fire one ping and drain pongs; keep the min-RTT offset sample
        (offset error is bounded by ±rtt/2, see docs). The post-ping
        wait is bounded at 5 ms: a live collector answers on loopback/
        ICI well inside it (giving an honest RTT instead of one inflated
        by the pump interval), a dead one costs 5 ms per interval_s."""
        zmq, hb = self._zmq, self._hb
        try:
            hb.send(json.dumps({"t0": time.time()}).encode(),
                    zmq.NOBLOCK)
            self._unanswered += 1
        except zmq.ZMQError:  # sitpu-lint: disable=SITPU-LEDGER (pump mints the drop)
            # HWM of queued pings reached — as unanswered as they come
            self._unanswered += 1
        waited = False
        while True:
            try:
                raw = hb.recv(zmq.NOBLOCK)
            except zmq.ZMQError:
                if waited or not hb.poll(5):
                    break
                waited = True
                continue
            t1 = time.time()
            try:
                pong = json.loads(raw)
            except ValueError:
                continue
            self._unanswered = 0
            self._seen = set(pong.get("seen", []))
            rtt = t1 - pong["t0"]
            if rtt >= 0 and (self.rtt == 0.0 or rtt < self.rtt):
                self.rtt = rtt
                self.clock_offset = pong["tc"] - (pong["t0"] + rtt / 2)

    @property
    def linked(self) -> bool:
        """True once a heartbeat pong proved the collector ingested a
        batch (or probe) from THIS rank — the PUB path is established
        end to end. The channel stays loss-legal either way; ``linked``
        exists so a caller that NEEDS a deterministic start (the traced-
        fleet drill, a bench run) can sequence one with ``probe()``
        instead of sacrificing the first batch to the asynchronous zmq
        subscription handshake."""
        return self.rank in self._seen

    def probe(self) -> None:
        """Ship one contentless presence batch + heartbeat. Costs a few
        bytes, moves no events, advances no cursor — loop it until
        ``linked`` (the collector's host must be polling)."""
        if self._pub is None:
            return
        if self._hb is not None:
            self._heartbeat()
        payload = zlib.compress(json.dumps(
            {"rank": self.rank, "probe": True}).encode(), 1)
        try:
            self._pub.send(payload, self._zmq.NOBLOCK)
        except self._zmq.ZMQError:
            pass

    # -------------------------------------------------------------- pump
    def pump(self, recorder: _rec.Recorder, force: bool = False) -> bool:
        """Publish events accumulated since the last pump (rate-limited
        to ``interval_s`` unless ``force``). Returns True when a batch
        was handed to the socket, False on skip/drop — never raises,
        never blocks."""
        if self._pub is None:
            return False
        now = time.monotonic()
        if not force and now - self._last_pump < self.interval_s:
            return False
        self._last_pump = now
        if self._hb is not None:
            self._heartbeat()
        events = recorder.events[self._cursor:
                                 self._cursor + self.max_batch_events]
        self._cursor += len(events)
        self._seq += 1
        batch = {"rank": self.rank, "seq": self._seq,
                 "epoch_unix": recorder.epoch_unix,
                 "t_unix": time.time(),
                 "clock_offset": round(self.clock_offset, 6),
                 "rtt": round(self.rtt, 6),
                 "events": events,
                 "counters": dict(recorder.counters),
                 "ledger": _rec.ledger()}
        payload = zlib.compress(json.dumps(batch).encode(), 1)
        try:
            self._pub.send(payload, self._zmq.NOBLOCK)
        except self._zmq.ZMQError:  # sitpu-lint: disable=SITPU-LEDGER (drops mint via _drop)
            # HWM full: the batch is lost, the loop is not.
            self._drop(recorder)
            return False
        if self._hb is not None and self._unanswered >= 3:
            # a PUB socket discards silently when the peer is gone, so a
            # dead collector never raises — three consecutive unanswered
            # heartbeats is the presumed-lost verdict for this batch
            self._drop(recorder)
            return False
        self.batches += 1
        recorder.count("obs_batches_published")
        return True

    def _drop(self, recorder: _rec.Recorder) -> None:
        self.drops += 1
        recorder.count("obs_batch_drops")
        _rec.degrade("obs.collector", "publish", "drop",
                     _DROP_REASON, warn=False)

    def close(self, recorder: Optional[_rec.Recorder] = None) -> None:
        """Final forced pump, then tear the sockets down."""
        if recorder is not None:
            self.pump(recorder, force=True)
        for s in (self._pub, self._hb):
            if s is not None:
                s.close(0)
        self._pub = self._hb = None


# ------------------------------------------------------------- collector

class Collector:
    """The fleet-side aggregator. Bind, ``poll()`` on any schedule, then
    ``export_fleet_trace()``; a collector that is never polled (or dies)
    costs publishers nothing but drops."""

    def __init__(self, bind: str = "tcp://127.0.0.1",
                 endpoint: str = "", hb_endpoint: str = ""):
        import zmq              # the collector side genuinely needs zmq
        self._zmq = zmq
        self._ctx = zmq.Context.instance()
        self._sub = self._ctx.socket(zmq.SUB)
        self._sub.setsockopt(zmq.SUBSCRIBE, b"")
        self._sub.setsockopt(zmq.LINGER, 0)
        self._hb = self._ctx.socket(zmq.ROUTER)
        self._hb.setsockopt(zmq.LINGER, 0)
        if endpoint:
            self._sub.bind(endpoint)
            self.endpoint = endpoint
        else:
            port = self._sub.bind_to_random_port(bind)
            self.endpoint = f"{bind}:{port}"
        if hb_endpoint:
            self._hb.bind(hb_endpoint)
            self.hb_endpoint = hb_endpoint
        else:
            port = self._hb.bind_to_random_port(bind)
            self.hb_endpoint = f"{bind}:{port}"
        self._poller = zmq.Poller()
        self._poller.register(self._sub, zmq.POLLIN)
        self._poller.register(self._hb, zmq.POLLIN)
        # rank -> merged per-process record
        self.ranks: Dict[int, Dict[str, Any]] = {}
        self.batches = 0
        self.decode_errors = 0

    # -------------------------------------------------------------- poll
    def poll(self, timeout_ms: int = 50) -> int:
        """Drain pending batches and answer pings; returns the number of
        batches ingested this call."""
        zmq = self._zmq
        got = 0
        ready = dict(self._poller.poll(timeout_ms))
        while ready:
            if self._hb in ready:
                try:
                    ident, raw = self._hb.recv_multipart(zmq.NOBLOCK)
                    ping = json.loads(raw)
                    self._hb.send_multipart(
                        [ident, json.dumps(
                            {"t0": ping["t0"],
                             "tc": time.time(),
                             "seen": sorted(self.ranks)}).encode()],
                        zmq.NOBLOCK)
                except (zmq.ZMQError, ValueError, KeyError):
                    self.decode_errors += 1
            if self._sub in ready:
                try:
                    raw = self._sub.recv(zmq.NOBLOCK)
                    self._ingest(json.loads(zlib.decompress(raw)))
                    got += 1
                except (zmq.ZMQError, ValueError, KeyError,
                        zlib.error):
                    self.decode_errors += 1
            ready = dict(self._poller.poll(0))
        return got

    def _ingest(self, batch: dict) -> None:
        rank = int(batch["rank"])
        r = self.ranks.setdefault(rank, {"events": [], "batches": 0})
        if batch.get("probe"):          # presence only — no payload
            return
        r["events"].extend(batch.get("events") or [])
        r["batches"] += 1
        for k in ("epoch_unix", "clock_offset", "rtt", "counters",
                  "ledger", "seq", "t_unix"):
            if k in batch:
                r[k] = batch[k]
        self.batches += 1

    # ------------------------------------------------------------- merge
    def _aligned_us(self, r: dict, ev: dict) -> float:
        """Event time on the collector's unix clock, in µs. Alignment
        model: local unix = epoch_unix + ts; collector unix = local +
        clock_offset (error bounded by ±rtt/2 of the kept sample)."""
        t = r.get("epoch_unix", 0.0) + ev["ts"] + r.get(
            "clock_offset", 0.0)
        return t * 1e6

    def merged_events(self) -> List[dict]:
        """All ranks' raw events with aligned ``t_us`` (collector unix
        µs) attached, time-sorted."""
        out = []
        for rank, r in self.ranks.items():
            for ev in r["events"]:
                e = dict(ev)
                e["rank"] = rank
                e["t_us"] = self._aligned_us(r, ev)
                out.append(e)
        out.sort(key=lambda e: e["t_us"])
        return out

    def frame_arc(self, frame: int) -> List[dict]:
        """One frame's lineage instants across every rank, in aligned
        time order (canonical-arc tie-break) — the per-frame causal
        timeline the flow arrows draw."""
        hops = [e for e in self.merged_events()
                if e["type"] == "instant" and e["name"] == "lineage"
                and e.get("frame") == frame]

        def key(e):
            stage = (e.get("attrs") or {}).get("stage", "")
            rank = ARC_ORDER.index(stage) if stage in ARC_ORDER else 99
            return (e["t_us"], rank)
        hops.sort(key=key)
        return hops

    def frames_seen(self) -> List[int]:
        return sorted({e.get("frame") for e in self.merged_events()
                       if e["type"] == "instant"
                       and e["name"] == "lineage"
                       and e.get("frame") is not None})

    # ------------------------------------------------------------ export
    def trace_events(self) -> List[dict]:
        """The merged multi-track Perfetto event list: every rank's
        spans/counters/instants on the collector timebase (pid = rank),
        plus flow arrows (ph "s"/"f") binding each frame's lineage hops
        across tracks, plus each rank's final ledger."""
        t0_us = None
        merged = self.merged_events()
        if merged:
            t0_us = min(e["t_us"] for e in merged)
        out = []
        for rank, r in sorted(self.ranks.items()):
            out.append({"ph": "M", "name": "process_name", "pid": rank,
                        "tid": 0, "args": {"name": f"rank {rank}"}})
        for ev in merged:
            ts = round(ev["t_us"] - t0_us, 1)
            base = {"name": ev["name"], "pid": ev["rank"], "tid": 0,
                    "ts": ts}
            args = dict(ev.get("attrs") or {})
            if "frame" in ev:
                args["frame"] = ev["frame"]
            if ev["type"] == "span":
                base.update(ph="X", dur=round(ev["dur"] * 1e6, 1),
                            cat="phase")
                if "parent" in ev:
                    args["parent"] = ev["parent"]
            elif ev["type"] == "counter":
                base.update(ph="C", cat="counter")
                args = {"value": ev["value"]}
            else:
                base.update(ph="i", s="p", cat="event")
            base["args"] = args
            out.append(base)
        # Flow arrows: consecutive lineage hops of each frame.
        for frame in self.frames_seen():
            hops = self.frame_arc(frame)
            for k in range(len(hops) - 1):
                a, b = hops[k], hops[k + 1]
                fid = f"f{frame}.{k}"
                out.append({"ph": "s", "id": fid, "cat": "lineage",
                            "name": f"frame {frame}",
                            "pid": a["rank"], "tid": 0,
                            "ts": round(a["t_us"] - t0_us, 1)})
                out.append({"ph": "f", "bp": "e", "id": fid,
                            "cat": "lineage", "name": f"frame {frame}",
                            "pid": b["rank"], "tid": 0,
                            "ts": round(b["t_us"] - t0_us, 1)})
        for rank, r in sorted(self.ranks.items()):
            for entry in r.get("ledger") or []:
                out.append({"ph": "i", "s": "g",
                            "name": f"degrade:{entry['component']}",
                            "pid": rank, "tid": 0, "ts": 0.0,
                            "cat": "degrade", "args": entry})
        return out

    def clock_model(self) -> Dict[str, Any]:
        """Per-rank alignment record: offset to the collector clock,
        the RTT of the sample it came from, and the resulting error
        bound (±rtt/2, ms)."""
        return {str(rank): {
                    "clock_offset_s": r.get("clock_offset", 0.0),
                    "rtt_s": r.get("rtt", 0.0),
                    "error_bound_ms": round(
                        r.get("rtt", 0.0) / 2 * 1e3, 3)}
                for rank, r in sorted(self.ranks.items())}

    def export_fleet_trace(self, path: str) -> str:
        """Write the ONE merged fleet trace (open at ui.perfetto.dev)."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.trace_events(),
                       "displayTimeUnit": "ms",
                       "otherData": {"fleet": True,
                                     "ranks": sorted(self.ranks),
                                     "batches": self.batches,
                                     "decode_errors": self.decode_errors,
                                     "clock_model": self.clock_model()}},
                      f)
        return path

    def summary(self) -> Dict[str, Any]:
        return {"ranks": sorted(self.ranks),
                "batches": self.batches,
                "decode_errors": self.decode_errors,
                "events": sum(len(r["events"])
                              for r in self.ranks.values()),
                "clock_model": self.clock_model()}

    def close(self) -> None:
        for s in (self._sub, self._hb):
            s.close(0)
