"""The asynchronous delivery plane: take the host's sink work off the
frame's critical path.

``DeliveryExecutor`` is a worker tier: the loop enqueues one job per
fetched frame (host numpy payloads, nothing on the device) onto a bounded
FIFO, and a single worker thread runs the sinks behind the session's
``SinkGuard``. Within one frame every tile payload is delivered in
ascending column order, then the frame sinks run; across frames the
queue is strictly FIFO. Overflow is a stated policy: ``block`` applies
lossless backpressure (disk dumps, checkpoints), ``drop_oldest`` sheds
the stalest undelivered frame latest-wins and mints a ``delivery.shed``
ledger row, a ``delivery_sheds`` counter bump and a ``delivery_shed``
event. ``drain()`` empties the queue on teardown and on the session's
crash paths. A copy of the reference's ``runtime/delivery.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Sequence

from scenery_insitu_tpu_torch import obs as _obs
from scenery_insitu_tpu_torch.obs.collector import lineage

_SHED_REASON = ("bounded delivery queue overflowed with overflow="
                "'drop_oldest'; the stalest undelivered frame was shed "
                "latest-wins (docs/ROBUSTNESS.md 'Shed semantics')")
_DRAIN_REASON = ("teardown drain timed out with frames still queued; "
                 "remaining jobs were abandoned so shutdown could "
                 "proceed")


class _FrameJob:
    """One frame's delivery work: the frame payload plus its tile
    payloads in ascending column order (host numpy only)."""

    __slots__ = ("index", "payload", "tiles", "t_enqueue")

    def __init__(self, index: int, payload: dict,
                 tiles: Sequence[dict]):
        self.index = index
        self.payload = payload
        self.tiles = list(tiles)
        self.t_enqueue = time.perf_counter()


class DeliveryExecutor:
    """Background sink tier draining a bounded per-frame queue off the
    render-loop thread.

    ``tile_sinks`` / ``sinks`` are the session's LIVE lists (the same
    objects users append to mid-run); ``guard`` is the session's
    SinkGuard, shared so quarantine state is one truth whether a sink
    ran inline or on the worker."""

    def __init__(self, cfg, guard, tile_sinks: List, sinks: List,
                 recorder=None, slo=None, log=None):
        self.cfg = cfg
        self.guard = guard
        self.tile_sinks = tile_sinks
        self.sinks = sinks
        self.slo = slo
        self.log = log or (lambda s: None)
        self._recorder = recorder
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._active = 0           # jobs popped but not yet delivered
        self._stop = False
        self.sheds = 0
        self.delivered = 0
        self.enqueued = 0
        self._worker = threading.Thread(
            target=self._run, daemon=True, name="delivery-worker")
        self._worker.start()

    # ------------------------------------------------------------ helpers
    def _rec(self):
        return self._recorder or _obs.get_recorder()

    @property
    def depth(self) -> int:
        """Current queue depth (jobs queued + in delivery) — the
        queue-depth gauge; also published as the value of the
        ``delivery_frames_inflight`` counter."""
        with self._cond:
            return len(self._q) + self._active

    # ------------------------------------------------------------- submit
    def submit(self, index: int, payload: dict,
               tiles: Sequence[dict] = ()) -> bool:
        """Enqueue one frame's delivery; called from the loop thread.
        Returns False when this submission caused a shed (an OLDER frame
        was dropped under ``drop_oldest`` — the submitted frame itself
        is always accepted; under ``block`` the call waits for space
        instead and always returns True)."""
        rec = self._rec()
        job = _FrameJob(index, payload, tiles)
        shed = None
        with self._cond:
            if self._stop:
                raise RuntimeError("DeliveryExecutor is closed")
            if self.cfg.overflow == "block":
                while len(self._q) >= self.cfg.queue_frames \
                        and not self._stop:
                    self._cond.wait(0.05)
            elif len(self._q) >= self.cfg.queue_frames:
                shed = self._q.popleft()
                self.sheds += 1
            self._q.append(job)
            self.enqueued += 1
            gauge = len(self._q) + self._active
            self._cond.notify_all()
        rec.count("delivery_frames_enqueued")
        rec.count("delivery_frames_inflight")
        rec.event("delivery_queue_depth", frame=index, depth=gauge)
        if shed is not None:
            rec.count("delivery_sheds")
            rec.count("delivery_frames_inflight", -1)
            rec.event("delivery_shed", frame=shed.index,
                      tiles=len(shed.tiles), queued_behind=index)
            _obs.degrade("delivery.shed", f"frame {shed.index}",
                         "shed", _SHED_REASON, warn=False)
            self.log(f"delivery: shed frame {shed.index} "
                     f"(queue {self.cfg.queue_frames} full, "
                     f"overflow=drop_oldest)")
        return shed is None

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stop:
                    self._cond.wait(0.1)
                if not self._q:
                    return                          # stopped and empty
                job = self._q.popleft()
                self._active += 1
                self._cond.notify_all()
            try:
                self._deliver(job)
            finally:
                with self._cond:
                    self._active -= 1
                    self._cond.notify_all()

    def _deliver(self, job: _FrameJob) -> None:
        """Run one frame's sinks on the worker thread — tile payloads in
        ascending column order first, then the frame sinks (the frame
        closes after its tiles); every callable behind the SinkGuard.
        The spans here record on the worker's own span stack (the
        recorder's stack is thread-local) and carry the frame id, so
        traces attribute delivery time to the frame it belongs to."""
        rec = self._rec()
        with rec.span("deliver", frame=job.index, worker="delivery",
                      tiles=len(job.tiles)):
            for tp in job.tiles:
                with rec.span("tile", frame=job.index,
                              tile=tp.get("tile")):
                    rec.count("tiles_delivered")
                    self.guard.run(self.tile_sinks, job.index, tp,
                                   kind="tile sink")
            with rec.span("sinks", frame=job.index):
                self.guard.run(self.sinks, job.index, job.payload)
        lineage("deliver", "send", job.index, rec=rec)
        self.delivered += 1
        lag_ms = (time.perf_counter() - job.t_enqueue) * 1e3
        rec.count("delivery_frames_delivered")
        rec.count("delivery_frames_inflight", -1)
        if self.slo is not None:
            self.slo.observe("delivery_lag_ms", lag_ms, frame=job.index)

    # ----------------------------------------------------------- teardown
    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Block until every queued frame is delivered (queue empty AND
        worker idle). Returns True on a clean drain; a timeout ledgers
        the abandon (``delivery.drain``) and returns False — the caller
        is tearing down and must not hang forever on a wedged sink.
        Safe to call from crash paths: never raises."""
        deadline = time.monotonic() + (self.cfg.drain_timeout_s
                                       if timeout_s is None else timeout_s)
        try:
            with self._cond:
                while self._q or self._active:
                    if not self._worker.is_alive():
                        break
                    if time.monotonic() >= deadline:
                        left = len(self._q) + self._active
                        self._q.clear()
                        self._cond.notify_all()
                        _obs.degrade("delivery.drain",
                                     f"{left} frames queued", "abandoned",
                                     _DRAIN_REASON, warn=False)
                        self.log(f"delivery: drain timed out with {left} "
                                 f"frames undelivered")
                        return False
                    self._cond.wait(0.05)
        except Exception as e:
            try:
                _obs.degrade("delivery.drain", "drain", "aborted",
                             f"drain error: {e!r}", warn=False)
            except Exception:
                pass        # torn-down obs; the original error wins
            return False    # crash-path caller; never raises
        return True

    def close(self, timeout_s: Optional[float] = None) -> bool:
        """Drain, then stop the worker. Idempotent."""
        clean = self.drain(timeout_s)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._worker.join(timeout=2.0)
        return clean
