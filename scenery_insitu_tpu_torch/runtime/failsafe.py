"""Per-callable failure isolation of the session's sinks.

A frame sink, tile sink or ``on_steer`` callback runs in the render
loop's process but on the other side of a failure domain: an exception
inside one must not abort a long in-situ run. ``SinkGuard`` catches per
callable, counts CONSECUTIVE failures, and quarantines (disables + a
``session.sink`` ledger row) any callable that fails ``max_failures``
times in a row; a success in between resets the count.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable

from scenery_insitu_tpu_torch import obs as _obs


def _name_of(fn: Callable) -> str:
    return getattr(fn, "__qualname__",
                   getattr(fn, "__name__", type(fn).__name__))


class SinkGuard:
    """Failure-isolation wrapper around a list of callables the render
    loop must survive. State is keyed on the callable's identity, so the
    public sink lists (``sess.sinks`` / ``sess.tile_sinks`` /
    ``sess.on_steer``) stay plain lists users append to."""

    def __init__(self, max_failures: int = 3, log=None,
                 domain: str = "session"):
        if max_failures < 1:
            raise ValueError(f"max_failures must be >= 1, "
                             f"got {max_failures}")
        self.max_failures = max_failures
        self.log = log or (lambda s: None)
        self.domain = domain
        # state is keyed on id(fn) but each entry HOLDS the callable:
        # the strong reference pins the object alive, so a freed sink's
        # address can never be recycled into another callable's
        # quarantine/failure record
        self._failures = {}        # id(fn) -> (count, fn)
        self._quarantined = {}     # id(fn) -> fn
        self.quarantined_names = []
        # the guard is shared between the render loop and the delivery
        # executor's worker threads (runtime/delivery.py), so the
        # count/quarantine bookkeeping must be atomic — the guarded
        # callables themselves run OUTSIDE the lock (a slow sink must
        # not serialize the other workers)
        self._lock = threading.Lock()

    def is_quarantined(self, fn: Callable) -> bool:
        with self._lock:
            return id(fn) in self._quarantined

    def reset(self, fn: Callable) -> bool:
        """Lift ``fn``'s quarantine and clear its failure count (an
        operator fixed the sink mid-run — re-admit it). Returns True
        when the callable was actually quarantined. Ledgered so the
        re-admission is as visible as the quarantine was."""
        key = id(fn)
        with self._lock:
            was = self._quarantined.pop(key, None) is not None
            self._failures.pop(key, None)
            if was:
                name = _name_of(fn)
                if name in self.quarantined_names:
                    self.quarantined_names.remove(name)
        if was:
            _obs.degrade(
                "session.sink", f"quarantined {_name_of(fn)}",
                "re-admitted",
                "quarantine reset by the operator; failure count "
                "cleared", warn=False)
        return was

    def call(self, fn: Callable, *args, kind: str = "sink") -> bool:
        """Run ``fn(*args)`` inside the guard; returns True on success,
        False when it failed or is quarantined. Never raises.
        Thread-safe: callable from delivery worker threads."""
        key = id(fn)
        with self._lock:
            if key in self._quarantined:
                return False
        try:
            fn(*args)
        except Exception as e:
            rec = _obs.get_recorder()
            rec.count("sink_failures")
            name = _name_of(fn)
            with self._lock:
                n = self._failures.get(key, (0, fn))[0] + 1
                self._failures[key] = (n, fn)
                quarantine = n >= self.max_failures
                if quarantine and key not in self._quarantined:
                    self._quarantined[key] = fn
                    self.quarantined_names.append(name)
                else:
                    quarantine = False
            self.log(f"{kind} {name!r} failed "
                     f"({n}/{self.max_failures}): {e!r}")
            if quarantine:
                rec.count("sinks_quarantined")
                _obs.degrade(
                    "session.sink", f"{kind} {name}", "quarantined",
                    f"failed {self.max_failures} consecutive times in "
                    f"{self.domain}; disabled for the rest of the run",
                    warn=False)
            return False
        with self._lock:
            self._failures.pop(key, None)   # consecutive failures only
        return True

    def run(self, fns: Iterable[Callable], *args,
            kind: str = "sink") -> int:
        """Run every callable in ``fns`` against ``args``; returns how
        many succeeded. Quarantined entries are skipped silently."""
        ok = 0
        for fn in list(fns):
            if self.call(fn, *args, kind=kind):
                ok += 1
        return ok
