"""Phase attribution on ``torch.profiler``.

A frame of this package is a chain of PyTorch ops and hand-written
kernels launched from Python, so the host timers see only the whole
frame. This module makes the device explain itself, with the
reference's scope catalog and record schema:

1. Every step (``parallel/pipeline.py``, ``parallel/hier.py``,
   ``ops/composite.py`` and ``models/pipelines.py``) wraps its phases in
   ``phase(name)``: a ``torch.profiler.record_function`` named
   ``sitpu_<name>``. Under ``torch.autograd.profiler.emit_nvtx()`` the
   same ranges become NVTX ranges for Nsight. With no profiler running
   ``phase`` returns one shared null context: an unprofiled frame pays
   one flag read a scope (a ``record_function`` costs tens of
   microseconds on the host even when nothing records it).
2. `ProfileCapture` runs N frames under ``torch.profiler``, exports the
   Chrome trace and joins every device event back to its scope. On a
   card the device events are the kernel, memcpy and memset events (the
   package's own kernels, launched through ``ctypes``, among them). A
   kernel runs after its launching call returned, so it is joined by
   ``args.correlation`` to the CUDA API call that launched it, and
   that call to the innermost ``sitpu_`` annotation enclosing it on its
   thread; ``External id`` is the fallback link. On the CPU
   the events are the ``cpu_op`` rows, counted by their self time
   (``aten::matmul`` contains ``aten::mm``) and joined to the
   enclosing annotation by time on their thread.

Accounting is the reference's: per-phase ms = sum of event durations /
(frames x devices), where ``devices`` is the number of CUDA devices
the trace's events ran on (1 on the CPU), never the in-process mesh's
rank count; device time no scope explains lands in ``unattributed``;
the gap between the wall clock (taken after a ``synchronize``) and the
device time lands in ``host``; summed op time above the wall is
normalized onto it (``normalized``, ``op_parallelism``, ``coverage``).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from scenery_insitu_tpu_torch.obs import recorder as _rec

SCOPE_PREFIX = "sitpu_"

# The phase catalog: every named scope the steps emit, and the
# two synthetic phases the capture itself mints.
PHASES = ("march", "halo", "exchange", "merge", "resegment",
          "wire_encode", "sim_step", "dcn_hop", "wave")
EXTRA_PHASES = ("unattributed", "host")

_NULL = contextlib.nullcontext()

# device-side event categories of a CUDA trace
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# Host seconds the capture waits, with the device idle, on either side
# of the window's opening and before its close. The tracer keeps a
# device event only if its timestamp, converted to the host's clock,
# falls inside the window, and that conversion is at times off by
# milliseconds: on an H100, kernels stamped up to 5.2 ms before the call
# that launched them, and without the margins 9 of 120 captures of a
# 512^3 frame lost one or two of its first kernels
# (``benchmarks/profile_window.py``). The margins keep the measured
# frames' events inside the window and the warm-up's outside it.
WINDOW_MARGIN_S = 0.05


def phase(name: str):
    """Named scope for one step phase: ``with phase("march"): ...``. A
    ``record_function`` while a profiler runs, else a shared null
    context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _autograd_profiler.record_function(SCOPE_PREFIX + name)


def scope_of(op_name: str) -> Optional[str]:
    """The phase of a ``/``-joined scope path: the LAST ``sitpu_``
    component wins, so nested scopes attribute to the innermost phase
    (wave(march) -> march)."""
    found = None
    for comp in op_name.split("/"):
        if comp.startswith(SCOPE_PREFIX):
            found = comp[len(SCOPE_PREFIX):]
    return found


def scope_names(text: str) -> set:
    """All ``sitpu_*`` phase names present in a text (a trace dump)."""
    return set(re.findall(r"sitpu_(\w+)", text))


class _Annotations:
    """The ``sitpu_`` annotations of one thread, for the innermost
    enclosing scope of a host interval."""

    def __init__(self, spans):
        # (start, end, phase), outer before inner at equal starts
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]

    def innermost(self, ts: float, te: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, ts)
        best = None
        # the latest-starting span that still covers [ts, te]
        for j in range(i - 1, -1, -1):
            s, e, name = self.spans[j]
            if e >= te:
                best = name
                break
        return best


def _self_times(ops: List[dict]) -> List[float]:
    """Self time (us) of each host op of one thread: its duration less
    its direct children's."""
    order = sorted(range(len(ops)),
                   key=lambda i: (ops[i]["ts"], -ops[i]["dur"]))
    self_us = [float(op["dur"]) for op in ops]
    stack: List[int] = []
    for i in order:
        ts = ops[i]["ts"]
        while stack and ops[stack[-1]]["ts"] + ops[stack[-1]]["dur"] <= ts:
            stack.pop()
        if stack:
            self_us[stack[-1]] -= float(ops[i]["dur"])
        stack.append(i)
    return [max(0.0, u) for u in self_us]


def join_trace(events: List[dict]):
    """Join a Chrome trace's events to the ``sitpu_`` scopes. Returns
    ``(rows, scopes, devices)``: rows ``(name, phase or None, dur_us)``
    of the device events (a CUDA trace) or of the ``cpu_op`` rows by
    self time (a CPU trace), the distinct scope names seen, and the
    number of devices the device events ran on (0 in a CPU trace)."""
    xs = [e for e in events if e.get("ph") == "X"]
    by_tid: Dict[Any, List] = {}
    scopes = set()
    for e in xs:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and \
                name.startswith(SCOPE_PREFIX):
            ph = name[len(SCOPE_PREFIX):]
            scopes.add(ph)
            by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 ph))
    ann = {k: _Annotations(v) for k, v in by_tid.items()}

    def scope_at(e) -> Optional[str]:
        a = ann.get((e.get("pid"), e.get("tid")))
        if a is None:
            return None
        ts = float(e["ts"])
        return a.innermost(ts, ts + float(e.get("dur", 0)))

    device = [e for e in xs if e.get("cat") in _DEVICE_CATS]
    rows = []
    if device:
        launch, external = {}, {}
        for e in xs:
            args = e.get("args") or {}
            if e.get("cat") in _LAUNCH_CATS and "correlation" in args:
                launch[args["correlation"]] = e
            elif e.get("cat") in ("cpu_op", "user_annotation") and \
                    "External id" in args:
                external.setdefault(args["External id"], e)
        devices = set()
        for e in device:
            args = e.get("args") or {}
            devices.add(args.get("device"))
            host = launch.get(args.get("correlation"))
            if host is None:
                host = external.get(args.get("External id"))
            ph = scope_at(host) if host is not None else None
            rows.append((e.get("name", ""), ph, float(e.get("dur", 0))))
        return rows, scopes, max(1, len(devices - {None}))
    ops_by_tid: Dict[Any, List[dict]] = {}
    for e in xs:
        if e.get("cat") == "cpu_op":
            ops_by_tid.setdefault((e.get("pid"), e.get("tid")),
                                  []).append(e)
    for ops in ops_by_tid.values():
        for e, us in zip(ops, _self_times(ops)):
            rows.append((e.get("name", ""), scope_at(e), us))
    return rows, scopes, 0


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class ProfileCapture:
    """Run N profiled frames of a step and attribute device time back to
    the ``sitpu_*`` phase scopes.

    ``capture(fn, *args, step=None)``: frames are ``fn(*args)``, or
    ``step()`` when given (a zero-argument callable running ONE frame,
    for callers that thread state between frames). ``warmup`` frames
    run first, as the profiler's warm-up step: traced, then dropped.

    ``host_time_fn`` (zero-argument, CUMULATIVE host seconds) attributes
    measured host work inside the frames (the delivery plane's copy,
    CRC and compression) to the ``host`` phase: device phases then
    normalize onto the wall less that time.

    A disabled capture returns None and touches neither the profiler
    nor the step. A failure degrades through the ``obs.profiler``
    ledger component and returns None; it never raises. After a capture
    ``rows`` holds the joined events ``(name, phase, dur_us)``.
    """

    def __init__(self, frames: int = 3, enabled: bool = True,
                 trace_dir: Optional[str] = None, warmup: int = 1,
                 devices: Optional[int] = None,
                 host_time_fn: Optional[Callable[[], float]] = None):
        self.frames = max(1, int(frames))
        self.enabled = bool(enabled)
        self.trace_dir = trace_dir
        self.warmup = max(0, int(warmup))
        self.devices = devices
        self.host_time_fn = host_time_fn
        self.rows: List[tuple] = []

    def capture(self, fn, *args,
                step: Optional[Callable[[], Any]] = None
                ) -> Optional[Dict[str, Any]]:
        if not self.enabled:
            return None
        try:
            return self._capture(fn, args, step)
        except Exception as e:   # sitpu-lint: disable=SITPU-LEDGER
            # capture is best-effort observability: the profiled step
            # keeps running whatever the profiler did (ledgered below)
            _rec.degrade("obs.profiler", "device_trace", "none",
                         f"profile capture failed: {e}", warn=False)
            return None

    def _capture(self, fn, args, step):
        from torch.profiler import ProfilerActivity, profile, schedule

        run = step if step is not None else (lambda: fn(*args))
        acts = [ProfilerActivity.CPU]
        on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        # the warm-up frames run as the profiler's own warm-up step: the
        # device tracer is live before the measured frames begin (a
        # window opened cold can lose its first kernels), and the
        # warm-up's events are discarded
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=self.frames, repeat=1)) as prof:
            for _ in range(self.warmup):
                run()
            _synchronize()
            if on_card:
                time.sleep(WINDOW_MARGIN_S)
            prof.step()
            if on_card:
                time.sleep(WINDOW_MARGIN_S)
            h0 = self.host_time_fn() if self.host_time_fn else 0.0
            t0 = time.perf_counter()
            for i in range(self.frames):
                run()
                if i < self.frames - 1:
                    prof.step()
            _synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / self.frames
            h1 = self.host_time_fn() if self.host_time_fn else 0.0
            if on_card:
                time.sleep(WINDOW_MARGIN_S)
            prof.step()
        hook_ms = 0.0
        if self.host_time_fn:
            hook_ms = max(0.0, (h1 - h0) * 1e3 / self.frames)
            hook_ms = min(hook_ms, wall_ms)   # a hook cannot exceed wall

        tmp = None if self.trace_dir else tempfile.mkdtemp(
            prefix="sitpu_profile_")
        try:
            trace_dir = self.trace_dir or tmp
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
        rows, scopes, traced_devices = join_trace(events)
        self.rows = rows

        phase_us: Dict[str, float] = {}
        phase_events: Dict[str, int] = {}
        joined = 0
        for _, sc, dur in rows:
            if sc is None:
                sc = "unattributed"
            else:
                joined += 1
            phase_us[sc] = phase_us.get(sc, 0.0) + dur
            phase_events[sc] = phase_events.get(sc, 0) + 1

        devices = self.devices or max(1, traced_devices)
        phases = {
            name: {"ms": round(us / 1e3 / (self.frames * devices), 4),
                   "events": phase_events.get(name, 0)}
            for name, us in sorted(phase_us.items())}
        device_ms = sum(p["ms"] for p in phases.values())
        # summed op time above the wall (a CPU intra-op pool, streams
        # overlapping on a card) is normalized onto the wall less the
        # hooked host time, so the phases sum to the measured wall;
        # op_parallelism keeps the raw ratio
        device_budget = max(0.0, wall_ms - hook_ms)
        op_parallelism = (device_ms / device_budget
                          if device_budget > 0 else None)
        normalized = False
        if op_parallelism is not None and op_parallelism > 1.0:
            scale = device_budget / device_ms
            for p in phases.values():
                p["ms"] = round(p["ms"] * scale, 4)
            device_ms = sum(p["ms"] for p in phases.values())
            normalized = True
        host_ms = hook_ms + max(0.0, wall_ms - hook_ms - device_ms)
        phases["host"] = {"ms": round(host_ms, 4), "events": 0}

        on_card = traced_devices > 0
        attr = {
            "type": "phase_attribution",
            "backend": "cuda" if on_card else "cpu",
            "device_kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
            "hlo_module": None,
            "frames": self.frames,
            "devices": devices,
            "wall_ms_per_frame": round(wall_ms, 4),
            "device_ms_per_frame": round(device_ms, 4),
            "host_hook_ms_per_frame": round(hook_ms, 4),
            "coverage": (round(min(1.0, op_parallelism), 4)
                         if op_parallelism is not None else None),
            "op_parallelism": (round(op_parallelism, 4)
                               if op_parallelism is not None else None),
            "normalized": normalized,
            "scoped_ops": len(scopes),
            "events_total": len(rows),
            "events_joined": joined,
            "phases": phases,
        }
        _rec.get_recorder().count("profile_captures")
        return attr


# ------------------------------------------------- fleet-trace export

def attribution_chrome_events(attr: Dict[str, Any],
                              pid: int = 9000) -> list:
    """Render one attribution as extra Perfetto tracks: a synthetic
    "device phases" process whose complete events lay the per-phase ms
    out sequentially (one representative frame). Append these to a
    Recorder ``chrome_trace_events()`` list or an exported trace file
    (``append_to_chrome_trace``)."""
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "device phases (attributed)"}}]
    ts = 0.0
    for name, p in (attr.get("phases") or {}).items():
        dur = float(p.get("ms") or 0.0) * 1e3    # us
        out.append({"ph": "X", "name": name, "pid": pid, "tid": 0,
                    "ts": round(ts, 1), "dur": round(dur, 1),
                    "cat": "device_phase",
                    "args": {"ms": p.get("ms"),
                             "events": p.get("events")}})
        ts += dur
    return out


def append_to_chrome_trace(attr: Dict[str, Any], path: str) -> str:
    """Append the attribution tracks to an existing exported fleet
    trace (Recorder.export_chrome_trace format)."""
    with open(path) as f:
        doc = json.load(f)
    doc.setdefault("traceEvents", []).extend(
        attribution_chrome_events(attr))
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def publish_attribution(attr: Dict[str, Any], rec=None,
                        frame: Optional[int] = None) -> None:
    """Publish a capture into the live fleet Recorder as an instant
    event carrying the per-phase breakdown (it shows in the Perfetto
    trace beside the host-side spans)."""
    rec = rec or _rec.get_recorder()
    rec.event("phase_attribution", frame=frame,
              wall_ms_per_frame=attr.get("wall_ms_per_frame"),
              coverage=attr.get("coverage"),
              **{f"ms_{name}": p.get("ms")
                 for name, p in (attr.get("phases") or {}).items()})
