"""Per-phase frame timing: running aggregates (n, sum, sumsq, min, max) per
phase, dumped with totals and windowed averages every ``window`` frames,
plus machine-greppable ``#TAG:rank:iter:sec#`` markers. O(1) memory over
arbitrarily long runs. A copy of the reference's ``runtime/timers.py``.
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional


class PhaseStats:
    __slots__ = ("n", "total", "sumsq", "vmin", "vmax")

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.sumsq = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def add(self, seconds: float) -> None:
        self.n += 1
        self.total += seconds
        self.sumsq += seconds * seconds
        self.vmin = min(self.vmin, seconds)
        self.vmax = max(self.vmax, seconds)

    @property
    def avg(self) -> float:
        return self.total / self.n if self.n else 0.0

    @property
    def stddev(self) -> float:
        if self.n < 2:
            return 0.0
        var = (self.sumsq - self.total * self.total / self.n) / (self.n - 1)
        return math.sqrt(max(var, 0.0))

    def csv(self) -> str:
        """`avg;min;max;stddev;n` — the reference's fps-CSV row format."""
        vmin = 0.0 if self.n == 0 else self.vmin
        vmax = 0.0 if self.n == 0 else self.vmax
        return (f"{self.avg:.6f};{vmin:.6f};{vmax:.6f};"
                f"{self.stddev:.6f};{self.n}")


class Timers:
    """Phase timer registry with windowed dumps.

    >>> t = Timers(window=100, log=print)
    >>> with t.phase("generate"): ...
    >>> t.frame_done()       # dumps stats every `window` frames

    ``frame_done`` also records the wall time between consecutive calls as
    the implicit "frame" phase, so ``fps()`` reports end-to-end frame rate.
    """

    def __init__(self, window: int = 100, log=None, rank: int = 0):
        self.window = window
        self.log = log or (lambda s: None)
        self.rank = rank
        self.stats: Dict[str, PhaseStats] = defaultdict(PhaseStats)
        self.window_stats: Dict[str, PhaseStats] = defaultdict(PhaseStats)
        self.frames = 0
        self._last_frame_t: Optional[float] = None
        # recorder spans feed record() from the delivery worker threads
        # too; the defaultdict first-touch and the PhaseStats
        # read-modify-write must be atomic across threads
        self._lock = threading.Lock()

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self.stats[name].add(seconds)
            self.window_stats[name].add(seconds)

    def marker(self, tag: str, iteration: int, seconds: float) -> None:
        """Machine-greppable marker (≅ #COMP:rank:iter:sec#)."""
        self.log(f"#{tag}:{self.rank}:{iteration}:{seconds:.6f}#")

    def frame_done(self) -> None:
        now = time.perf_counter()
        if self._last_frame_t is not None:
            self.record("frame", now - self._last_frame_t)
        self._last_frame_t = now
        self.frames += 1
        if self.frames % self.window == 0:
            self.dump_window()

    def dump_window(self) -> None:
        self.log(f"=== frame {self.frames} (window of {self.window}) ===")
        for name, st in sorted(self.window_stats.items()):
            self.log(f"  {name:>16}: avg {st.avg * 1e3:8.3f} ms  "
                     f"total {st.total:7.3f} s  n={st.n}")
        # reset so each dump is a true per-window average — without this
        # the "windowed" lines silently accumulate over the whole run
        self.window_stats = defaultdict(PhaseStats)

    def dump_totals(self) -> None:
        """Final dump: flush the partial window frame_done never reached
        (a 250-frame run at window=100 leaves 50 frames undumped), then
        the whole-run totals. Idempotent on the window part."""
        if any(st.n for st in self.window_stats.values()):
            self.log(f"=== frame {self.frames} (final partial window) ===")
            for name, st in sorted(self.window_stats.items()):
                self.log(f"  {name:>16}: avg {st.avg * 1e3:8.3f} ms  "
                         f"total {st.total:7.3f} s  n={st.n}")
            self.window_stats = defaultdict(PhaseStats)
        self.log(f"=== totals over {self.frames} frames ===")
        for name, st in sorted(self.stats.items()):
            self.log(f"  {name:>16}: avg {st.avg * 1e3:8.3f} ms  "
                     f"total {st.total:7.3f} s  n={st.n}")

    # alias so recorder/session teardown paths read naturally
    close = dump_totals

    def csv(self) -> str:
        lines = ["phase;avg;min;max;stddev;n"]
        for name, st in sorted(self.stats.items()):
            lines.append(f"{name};{st.csv()}")
        return "\n".join(lines)

    def fps(self, phase: str = "frame") -> float:
        st = self.stats.get(phase)
        return 1.0 / st.avg if st and st.avg > 0 else 0.0
