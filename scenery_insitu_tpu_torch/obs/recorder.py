"""Structured run telemetry: the host half of the observability layer.

Three layers:

- ``Recorder``: structured span events (name, frame, rank, t0, dur,
  attrs) plus counters and instant events. Every span also feeds a
  ``runtime.timers.Timers`` (O(1) PhaseStats, windowed dumps), so
  ``sess.timers`` works whether the recorder is enabled or not. A
  DISABLED recorder only feeds the timers: it records no events and
  writes no files.
- the module-level **fallback ledger** (`degrade`/`ledger`): process-
  global, so a degradation reported before any session exists is not
  lost. Identical (component, from, to, reason) entries are counted, not
  duplicated, and the first occurrence emits a ``warnings.warn``.
- exporters: Chrome-trace/Perfetto JSON (open the file at
  ``ui.perfetto.dev``) and a JSONL metrics stream; the rank is in every
  event.

A copy of the reference's ``obs/recorder.py``; the two registries below
catalog this package's own ``degrade`` and ``count`` sites
(``tests/test_torch_runtime.py`` holds them equal to the sites).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

from scenery_insitu_tpu_torch.runtime.timers import Timers

# ---------------------------------------------------------------- ledger

_LEDGER: Dict[tuple, Dict[str, Any]] = {}
_LEDGER_LOCK = threading.Lock()


def degrade(component: str, from_: str, to: str, reason: str,
            warn: bool = True, stacklevel: int = 2) -> Dict[str, Any]:
    """Report one degradation: ``component`` was configured/asked to run
    ``from_`` but actually runs ``to`` because of ``reason``.

    Every silent-fallback site routes through here so a run can end with
    an explicit list of everything that did not run as configured
    (``ledger()``). The first occurrence of a (component, from, to,
    reason) tuple emits a ``warnings.warn`` — same visible behavior the
    inline warning sites had — and later occurrences only bump the
    entry's count (a per-frame fallback must not spam). The active
    recorder, if enabled, additionally gets an instant event so the
    degradation lands in the trace timeline too."""
    key = (component, from_, to, reason)
    with _LEDGER_LOCK:
        entry = _LEDGER.get(key)
        first = entry is None
        if first:
            entry = {"component": component, "from": from_, "to": to,
                     "reason": reason, "count": 1,
                     "t": round(time.time(), 3)}
            _LEDGER[key] = entry
        else:
            entry["count"] += 1
    if first and warn:
        import warnings
        warnings.warn(f"{component}: {from_} -> {to} ({reason})",
                      stacklevel=stacklevel + 1)
    rec = get_recorder()
    if rec.enabled:
        rec.event("degrade", component=component, **{"from": from_},
                  to=to, reason=reason)
    return entry


# The component catalog of every degrade() site in this package: keys
# are components, values say what degrading means there.
_LEDGER_REGISTRY: Dict[str, str] = {
    "bench.adaptive_mode": "bench: temporal adaptive mode needs the mxu "
                           "engine; histogram runs instead",
    "bench.cost_analysis": "bench: XLA cost analysis unavailable; "
                           "artifact bytes fall back to the floor model",
    "bricks.partition": "a brick render partition was configured where "
                        "the builder has no brick march (hybrid/plain "
                        "steps); the even z-slab decomposition renders",
    "composite.schedule": "tile waves requested on a single-rank mesh; "
                          "frame schedule runs (nothing to overlap)",
    "config.removed_key": "a removed config key was set and ignored "
                          "(deprecation note in the reason)",
    "delivery.drain": "teardown drain of the async delivery queue timed "
                      "out; undelivered frames were abandoned so "
                      "shutdown could proceed",
    "delivery.encode": "parallel per-tile encode requested together "
                       "with temporal delta (stateful per-tile "
                       "history); the publisher encodes serially",
    "delivery.shed": "the bounded async delivery queue overflowed under "
                     "overflow='drop_oldest'; the stalest undelivered "
                     "frame was shed latest-wins",
    "delta.reuse": "temporal fragment reuse requested where no marched "
                   "VDI fragment can be carried (gather/hybrid/plain/"
                   "particle modes, scan blocks); every frame "
                   "re-marches",
    "head.rank_down": "head node: a render rank went silent past "
                      "stale_frames; frames composite without it "
                      "(degraded flag) until it returns",
    "ingest.stall": "shm ingest: no strictly-newer producer frame past "
                    "frame_timeout_ms; the session keeps rendering the "
                    "last-good frame until frames resume",
    "io.vdi_codec": "zstd codec unavailable; VDI IO degrades to stdlib "
                    "zlib",
    "lod.engine": "a multi-level brick map reached the gather engine, "
                  "which marches every brick at full resolution; levels "
                  "flatten to 0 (docs/PERF.md 'LOD marching')",
    "lod.inert": "lod.enabled is set but the session has no brick map "
                 "(composite.rebalance != bricks), so no per-brick "
                 "levels exist to plan; the replan is a no-op",
    "multihost.connect": "multihost.initialize could not reach the "
                         "coordinator on an attempt; retrying on the "
                         "bounded backoff ladder instead of hanging "
                         "the fleet silently",
    "multihost.host_down": "hierarchical head assembly: a host's domain "
                           "partial never arrived; the column block "
                           "composites without its slab content "
                           "(degraded), the frame still ships",
    "multihost.transport": "host gathers route through the coordinator "
                           "KV store because this backend cannot run "
                           "cross-process device collectives (the "
                           "multi-process CPU harness)",
    "obs.collector": "fleet telemetry side-channel: a batch publish to "
                     "the collector could not complete without blocking "
                     "(dead/slow collector, HWM full); the batch is "
                     "dropped, the render loop never waits",
    "obs.flight_recorder": "an unhandled exception tore down a frame "
                           "loop; the last unflushed obs window was "
                           "dumped best-effort to the configured "
                           "trace/metrics paths",
    "obs.profiler": "a ProfileCapture could not produce a phase "
                    "attribution (trace backend absent, no trace "
                    "emitted, or the HLO/trace join failed); the step "
                    "keeps running unprofiled (docs/OBSERVABILITY.md "
                    "'Phase attribution')",
    "occupancy.k_budget": "occupancy K budgets requested where no "
                          "pyramid/adaptive threshold exists; static "
                          "budgets run",
    "occupancy.rebalance": "render rebalancing requested where there is "
                           "nothing to rebalance (single rank / no volume "
                           "field); even z-slabs render",
    "occupancy.replan": "the render z-plan changed from fetched live "
                        "fractions; the affected steps recompile on the "
                        "new band split",
    "scenario.tf_update": "a steered transfer function not seen before "
                          "rebuilt the compiled steps (a repeated TF "
                          "restores its cached steps instead — the "
                          "recompile-or-reuse contract)",
    "serve.client": "edge server: a malformed or oversized client "
                    "message was dropped; the serve loop keeps going",
    "serve.shed": "edge server admission control refused a viewer or "
                  "camera request (max_viewers/queue_cap); the client "
                  "got a typed shed answer, not an exception",
    "serve.stale": "edge server answered from a VDI more than "
                   "serve.staleness_frames behind the stream head; "
                   "answers are stamped stale",
    "serve.tier": "a client requested an unknown quality tier; the "
                  "serve.default_tier renders instead",
    "session.sink": "a frame/tile sink or on_steer callback failed "
                    "max_sink_failures consecutive times and is "
                    "quarantined (disabled) for the rest of the run",
    "slo.breach": "the live SLO engine saw a rolling-window quantile "
                  "cross its configured budget (metric and quantile in "
                  "the reason); the run keeps going, the breach is the "
                  "signal",
    "stream.delta_resync": "a temporal-delta P/SKIP record arrived "
                           "without its base tile retained (an earlier "
                           "message was lost); dropped while waiting "
                           "for the next forced I-tile",
    "stream.gap": "VDI stream continuity: a sequence gap, duplicate/"
                  "reordered message, publisher restart, or a tile "
                  "frame abandoned incomplete past the assembler window",
    "stream.integrity": "a corrupt/truncated stream message failed "
                        "checksum/size/shape validation and was dropped "
                        "before decode",
    "stream.liveness": "a stream endpoint saw no traffic past "
                       "liveness_timeout_s and is reconnecting with "
                       "bounded exponential backoff",
    "stream.steering": "a malformed or oversized steering message was "
                       "dropped; the drain keeps going",
    "topology.hier": "a hierarchical topology knob is inert on this "
                     "configuration (one host, or a mode with no "
                     "two-level composite); the flat single-level "
                     "path runs",
}


def ledger_registry() -> Dict[str, str]:
    """The static component catalog of the fallback ledger: every
    component a ``degrade()`` site in this package can mint, with a
    one-line meaning."""
    return dict(_LEDGER_REGISTRY)


# The counter catalog of every ``Recorder.count`` site in this package:
# keys are counter names, values say what one increment means.
_COUNTER_REGISTRY: Dict[str, str] = {
    "bricks_steps_built": "a brick-partitioned render step was built for "
                          "a brick map",
    "build_steps": "the session (re)built its render step set",
    "compile_step": "one render step was built for a march regime",
    "dcn_bytes_received": "bytes received over the inter-host DCN seam "
                          "by the hierarchical composite",
    "dcn_bytes_sent": "bytes sent over the inter-host DCN seam by the "
                      "hierarchical composite",
    "dcn_hops_built": "one DCN ring hop of the hierarchical exchange "
                      "was built",
    "delivery_frames_delivered": "the async delivery worker finished "
                                 "one frame's sinks (tiles in column "
                                 "order, then the frame sinks)",
    "delivery_frames_enqueued": "the render loop handed one fetched "
                                "frame to the async delivery queue",
    "delivery_frames_inflight": "net frames inside the delivery plane "
                                "(+1 on enqueue, -1 on delivered or "
                                "shed) — a gauge expressed as a counter",
    "delivery_sheds": "the bounded delivery queue dropped its oldest "
                      "undelivered frame (overflow='drop_oldest')",
    "delta_bytes_saved": "wire bytes avoided by a temporal-delta "
                         "(SKIP/P) record vs the full I-tile encoding",
    "delta_march_skipped": "a rank's re-march was skipped because its "
                           "occupancy range signature was unchanged",
    "delta_tiles_skipped": "an unchanged tile shipped as a SKIP record",
    "flight_dumps": "the flight recorder dumped the last obs window "
                    "after an unhandled frame-loop exception",
    "frames_abandoned": "the tile assembler abandoned a frame that "
                        "stayed incomplete past its window",
    "frames_eager_dispatch": "a frame went through the eager per-frame "
                             "dispatch path",
    "head_degraded_frames": "the head composited a frame with >= 1 rank "
                            "missing (degraded flag set)",
    "head_ranks_down": "head liveness marked a render rank silent",
    "head_ranks_readmitted": "a silent render rank resumed and was "
                             "readmitted to the composite",
    "hier_composite_builds": "a two-level hierarchical composite "
                             "schedule was built",
    "hier_plain_levels": "a plain (non-ring) allgather level of the "
                         "hierarchical exchange was built",
    "iframe_forced": "the delta encoder forced a full I-tile (resync or "
                     "cadence)",
    "ingest_stall_recoveries": "shm ingest saw a strictly-newer producer "
                               "frame again after a stall",
    "ingest_stalls": "shm ingest found no strictly-newer producer frame "
                     "past frame_timeout_ms",
    "obs_batch_drops": "a fleet-telemetry batch was dropped because the "
                       "collector socket would have blocked",
    "obs_batches_published": "a fleet-telemetry batch was handed to the "
                             "collector PUB socket",
    "occupancy_kbudget_builds": "a K-budget occupancy plan was built",
    "profile_captures": "a ProfileCapture produced a phase attribution "
                        "(profiled frames joined back to sitpu_* scopes)",
    "rebalance_replans": "a rebalance replan (slab or brick-steal) was "
                         "executed",
    "rebalance_steps_built": "a render step was built for a rebalanced "
                             "partition",
    "regime_switches": "the camera entered another march regime than "
                       "the previous frame's",
    "reuse_steps_built": "a temporal-reuse render step (carried "
                         "fragments) was built",
    "ring_exchange_builds": "a ring all-to-all exchange program was "
                            "built",
    "ring_steps_built": "one hop of a ring exchange was built",
    "serve_answers": "the edge server sent one answer to a viewer",
    "serve_batch_cameras": "cameras rendered inside batched serve "
                           "dispatches (count = cameras)",
    "serve_batches": "the edge server ran one batched render dispatch",
    "serve_bytes_out": "bytes sent to viewers by the edge server",
    "serve_cache_hits": "a viewer camera hit the camera-delta cache",
    "serve_client_drops": "a malformed/oversized client message was "
                          "dropped by the serve loop",
    "serve_clients_evicted": "an idle viewer was evicted from the edge "
                             "server",
    "serve_frames_adopted": "the serve loop adopted a new VDI frame "
                            "from the stream",
    "serve_proxy_builds": "a planar-reprojection proxy renderer was "
                          "built",
    "serve_requests": "the edge server received one client camera "
                      "request",
    "serve_requests_coalesced": "duplicate per-frame camera requests "
                                "were coalesced into one render",
    "serve_sheds": "admission control refused a viewer or camera "
                   "request",
    "serve_stale_answers": "an answer was rendered from a VDI beyond "
                           "the staleness budget (stamped stale)",
    "sink_failures": "a frame/tile sink or steering callback raised",
    "sinks_quarantined": "a sink was disabled after repeated "
                         "consecutive failures",
    "slo_breaches": "the live SLO engine recorded one budget breach",
    "steering_drops": "a malformed steering message was dropped",
    "stream_drops": "a stream message was dropped (integrity or "
                    "continuity validation)",
    "stream_gap_messages": "a sequence gap/duplicate/reorder was "
                           "observed on a stream",
    "stream_reconnects": "a stream endpoint reconnected after a "
                         "liveness timeout",
    "tf_steps_reused": "a steered transfer function restored its cached "
                       "compiled steps",
    "tf_updates": "a steered transfer-function update was applied",
    "tiles_delivered": "one column-block tile payload went to the tile "
                       "sinks (from the session or the delivery worker)",
    "wave_schedule_builds": "a tile-wave overlap schedule was built",
    "wave_steps_built": "a tile-wave render step was compiled",
    "wire_encode_builds": "a wire encode executable was built",
}


def counter_registry() -> Dict[str, str]:
    """The static name catalog of ``Recorder.count`` counters: every
    counter a call site in this package can bump, with a one-line
    meaning."""
    return dict(_COUNTER_REGISTRY)


def ledger() -> List[Dict[str, Any]]:
    """Snapshot of every degradation reported so far (insertion order)."""
    with _LEDGER_LOCK:
        return [dict(e) for e in _LEDGER.values()]


def clear_ledger() -> None:
    """Reset the process-global ledger (tests / bench child isolation)."""
    with _LEDGER_LOCK:
        _LEDGER.clear()


# ----------------------------------------------------------------- spans

class _Span:
    """One timed region. Always feeds the recorder's Timers (PhaseStats
    and windowed dumps); records a structured event only when the
    recorder is enabled."""

    __slots__ = ("rec", "name", "frame", "attrs", "t0", "depth", "parent")

    def __init__(self, rec: "Recorder", name: str,
                 frame: Optional[int], attrs: Optional[dict]):
        self.rec = rec
        self.name = name
        self.frame = frame
        self.attrs = attrs

    def __enter__(self):
        rec = self.rec
        if rec.enabled:
            stack = rec._stack
            self.depth = len(stack)
            self.parent = stack[-1] if stack else None
            stack.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        rec = self.rec
        dt = t1 - self.t0
        rec.timers.record(self.name, dt)
        if rec.enabled:
            rec._stack.pop()
            ev = {"type": "span", "name": self.name,
                  "rank": rec.rank,
                  "ts": self.t0 - rec.epoch, "dur": dt,
                  "depth": self.depth}
            if self.parent is not None:
                ev["parent"] = self.parent
            if self.frame is not None:
                ev["frame"] = self.frame
            if self.attrs:
                ev["attrs"] = self.attrs
            rec._push(ev)
        return False


class Recorder:
    """Per-run telemetry recorder. ``enabled=False`` is the hot-path
    no-op configuration: spans delegate to the Timers only, ``events``
    stays empty forever and ``flush()`` writes nothing."""

    def __init__(self, enabled: bool = True, rank: int = 0,
                 window: int = 100, log=None,
                 trace_path: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 timers: Optional[Timers] = None,
                 max_events: int = 500_000):
        self.enabled = enabled
        self.rank = rank
        self.timers = timers if timers is not None else Timers(
            window=window, log=log, rank=rank)
        self.trace_path = trace_path or None
        self.metrics_path = metrics_path or None
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()
        self.events: List[dict] = []
        self.counters: Dict[str, float] = {}
        self.max_events = max_events
        # spans now open/close on the delivery worker threads too
        # (runtime/delivery.py): the open-span stack is per-thread so a
        # worker span cannot corrupt the loop thread's nesting, and the
        # counter read-modify-write is locked
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._dropped = 0

    @property
    def _stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    @classmethod
    def from_config(cls, obs_cfg, rank: int = 0, log=None,
                    window: Optional[int] = None) -> "Recorder":
        """Build from a ``config.ObsConfig`` block (``obs.window == 0``
        inherits the caller's window, normally runtime.stats_window)."""
        return cls(enabled=obs_cfg.enabled, rank=rank, log=log,
                   window=obs_cfg.window or window or 100,
                   trace_path=obs_cfg.trace_path,
                   metrics_path=obs_cfg.metrics_path)

    # ------------------------------------------------------------ record
    def span(self, name: str, frame: Optional[int] = None,
             **attrs) -> _Span:
        """Context manager timing one phase; ``frame``/``attrs`` become
        event attribution. Usable whether enabled or not."""
        return _Span(self, name, frame, attrs or None)

    def count(self, name: str, n: float = 1) -> None:
        """Bump a named counter (compile events, scan blocks, eager
        frames, ...). O(1) dict update — cheap enough to leave in hot
        paths unconditionally; the counter event stream is only recorded
        when enabled."""
        with self._lock:
            value = self.counters[name] = self.counters.get(name, 0) + n
        if self.enabled:
            self._push({"type": "counter", "name": name, "rank": self.rank,
                        "ts": time.perf_counter() - self.epoch,
                        "value": value})

    def event(self, name: str, frame: Optional[int] = None,
              **attrs) -> None:
        """Instant event (no duration)."""
        if not self.enabled:
            return
        ev = {"type": "instant", "name": name, "rank": self.rank,
              "ts": time.perf_counter() - self.epoch}
        if frame is not None:
            ev["frame"] = frame
        if attrs:
            ev["attrs"] = attrs
        self._push(ev)

    def _push(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self._dropped += 1     # bound memory over long campaigns
            return
        self.events.append(ev)

    def frame_done(self) -> None:
        self.timers.frame_done()

    # ----------------------------------------------------------- summary
    def summary(self) -> dict:
        """One JSON-able record of the run: per-phase stats, counters and
        the process-global fallback ledger."""
        phases = {name: {"avg_ms": round(st.avg * 1e3, 3),
                         "total_s": round(st.total, 4), "n": st.n}
                  for name, st in sorted(self.timers.stats.items())}
        return {"rank": self.rank, "frames": self.timers.frames,
                "enabled": self.enabled, "phases": phases,
                "counters": dict(self.counters),
                "events_recorded": len(self.events),
                "events_dropped": self._dropped,
                "degradations": ledger()}

    # --------------------------------------------------------- exporters
    def chrome_trace_events(self) -> List[dict]:
        """Chrome-trace / Perfetto event list: spans as complete ("X")
        events, counters as "C", instants as "i", plus process-name
        metadata. ``pid`` is the rank, timestamps in µs from the
        recorder epoch."""
        out = [{"ph": "M", "name": "process_name", "pid": self.rank,
                "tid": 0,
                "args": {"name": f"rank {self.rank}"}}]
        for ev in self.events:
            ts = round(ev["ts"] * 1e6, 1)
            base = {"name": ev["name"], "pid": ev.get("rank", self.rank),
                    "tid": 0, "ts": ts}
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
        for entry in ledger():
            out.append({"ph": "i", "s": "g", "name":
                        f"degrade:{entry['component']}", "pid": self.rank,
                        "tid": 0, "ts": 0.0, "cat": "degrade",
                        "args": entry})
        return out

    def export_chrome_trace(self, path: str) -> str:
        """Write ``trace.json`` (open in ui.perfetto.dev or
        chrome://tracing)."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_trace_events(),
                       "displayTimeUnit": "ms",
                       "otherData": {"rank": self.rank,
                                     "epoch_unix": self.epoch_unix}}, f)
        return path

    def export_metrics_jsonl(self, path: str) -> str:
        """Write the raw event stream as JSON lines, one event per line,
        terminated by one ``summary`` line (the grep/jq-friendly twin of
        the trace file)."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
            f.write(json.dumps({"type": "summary", **self.summary()})
                    + "\n")
        return path

    def flush(self) -> None:
        """Write the configured sinks (no-op when disabled or pathless).
        Idempotent — call at end of run(), or repeatedly mid-campaign for
        a monotonically growing snapshot."""
        if not self.enabled:
            return
        if self.trace_path:
            self.export_chrome_trace(self.trace_path)
        if self.metrics_path:
            self.export_metrics_jsonl(self.metrics_path)


# ------------------------------------------------------ flight recorder

_FLIGHT_REASON = ("unhandled exception tore down the frame loop; the "
                  "last obs window was dumped best-effort to the "
                  "configured paths")


def flight_flush(rec: Optional[Recorder] = None,
                 where: str = "run") -> bool:
    """Crash-path dump: write whatever the recorder holds to its
    configured sinks, best-effort, so an exception mid-run does not lose
    the final unflushed window (the one that usually explains the
    crash). Never raises — this runs while the original exception is
    propagating, and a broken disk must not mask it. Returns True when
    a dump was attempted (enabled recorder with >= 1 sink path)."""
    rec = rec or get_recorder()
    if not rec.enabled or not (rec.trace_path or rec.metrics_path):
        return False
    rec.count("flight_dumps")
    rec.event("flight_dump", where=where)
    degrade("obs.flight_recorder", where, "crash_flush", _FLIGHT_REASON,
            warn=False)
    try:
        rec.flush()
    except Exception:
        pass    # the in-flight exception is the story, not this one
    return True


# ------------------------------------------------------- global recorder

_GLOBAL = Recorder(enabled=False)


def get_recorder() -> Recorder:
    """The process's active recorder (a disabled one until a session or
    harness installs its own)."""
    return _GLOBAL


def set_recorder(rec: Recorder) -> Recorder:
    """Install ``rec`` as the active recorder; returns the previous one
    so callers can restore it."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = rec
    return prev
