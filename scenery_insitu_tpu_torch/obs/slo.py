"""Live SLO engine: rolling-window latency objectives checked on the run.

A ``SLOEngine`` holds one rolling window per metric (``frame_ms``,
``staleness_frames``, ``camera_to_pixel_ms``, ``delivery_lag_ms`` and
per-phase ``phase:<name>_ms``), computes p50/p99 by nearest rank over
the window, and compares the p99 with its budget from the
``FrameworkConfig.slo`` block. A breach fires on the TRANSITION of a
metric's rolling p99 across its budget: one ``slo_breach`` event, one
``slo_breaches`` counter bump and one deduped ``slo.breach`` ledger row
per episode; the metric re-arms when its p99 returns under budget.
Budgets of 0 disable the gate, but the metric is still tracked for
``snapshot()``. Stdlib only. A copy of the reference's ``obs/slo.py``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

from scenery_insitu_tpu_torch.obs import recorder as _rec

# Constant by design: the ledger dedupes on (component, from, to,
# reason), so a per-metric reason string would bloat it.
_BREACH_REASON = ("rolling p99 crossed its configured budget "
                  "(docs/OBSERVABILITY.md 'SLO engine')")


def _nearest_rank(sorted_vals, q: float) -> float:
    """Nearest-rank quantile over a pre-sorted sequence."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    idx = min(n - 1, max(0, int(q * n + 0.5) - 1))
    return sorted_vals[idx]


class _Metric:
    __slots__ = ("name", "budget", "buf", "n_total", "last",
                 "breached", "breaches")

    def __init__(self, name: str, budget: float, window: int):
        self.name = name
        self.budget = budget          # 0 = tracked, not gated
        self.buf = deque(maxlen=window)
        self.n_total = 0
        self.last = 0.0
        self.breached = False
        self.breaches = 0


class SLOEngine:
    """Rolling-window SLO checks over live run metrics.

    ``observe(metric, value)`` is the whole write API; budgets come from
    the config block, unknown metrics are tracked gate-free, and
    ``snapshot()`` is the read API (JSON-able)."""

    #: metric name -> SLOConfig budget field
    _BUDGET_FIELDS = {
        "frame_ms": "frame_p99_ms",
        "staleness_frames": "staleness_p99_frames",
        "camera_to_pixel_ms": "camera_to_pixel_p99_ms",
        "delivery_lag_ms": "delivery_lag_p99_ms",
    }

    def __init__(self, cfg, recorder: Optional[_rec.Recorder] = None):
        self.cfg = cfg
        self.enabled = bool(cfg.enabled)
        self.window = int(cfg.window)
        self.min_samples = int(cfg.min_samples)
        self._recorder = recorder
        self._metrics: Dict[str, _Metric] = {}

    # ------------------------------------------------------------- write
    def _budget_for(self, metric: str) -> float:
        field = self._BUDGET_FIELDS.get(metric)
        if field is not None:
            return float(getattr(self.cfg, field))
        if metric.startswith("phase:"):
            return float(self.cfg.phase_p99_ms)
        return 0.0

    def observe(self, metric: str, value: float,
                frame: Optional[int] = None) -> None:
        """Feed one sample; runs the breach check once the window holds
        ``min_samples``. No-op when the engine is disabled."""
        if not self.enabled:
            return
        m = self._metrics.get(metric)
        if m is None:
            m = self._metrics[metric] = _Metric(
                metric, self._budget_for(metric), self.window)
        m.buf.append(float(value))
        m.n_total += 1
        m.last = float(value)
        if m.budget <= 0 or len(m.buf) < self.min_samples:
            return
        p99 = _nearest_rank(sorted(m.buf), 0.99)
        if p99 > m.budget:
            if not m.breached:
                m.breached = True
                m.breaches += 1
                self._mint_breach(m, p99, frame)
        else:
            m.breached = False          # re-arm for the next episode

    def _mint_breach(self, m: _Metric, p99: float,
                     frame: Optional[int]) -> None:
        rec = self._recorder or _rec.get_recorder()
        rec.count("slo_breaches")
        rec.event("slo_breach", frame=frame, metric=m.name,
                  p99=round(p99, 3), budget=m.budget,
                  window_n=len(m.buf))
        _rec.degrade("slo.breach", m.name, "breached", _BREACH_REASON,
                     warn=False)

    def observe_phase(self, name: str, seconds: float,
                      frame: Optional[int] = None) -> None:
        """Per-phase budget feed (``slo.phase_p99_ms``), in seconds to
        match Timers.record."""
        self.observe(f"phase:{name}_ms", seconds * 1e3, frame=frame)

    # -------------------------------------------------------------- read
    def quantile(self, metric: str, q: float) -> float:
        m = self._metrics.get(metric)
        return _nearest_rank(sorted(m.buf), q) if m else 0.0

    def breached(self, metric: Optional[str] = None) -> bool:
        """Currently-breached state of one metric (or any, when None)."""
        if metric is not None:
            m = self._metrics.get(metric)
            return bool(m and m.breached)
        return any(m.breached for m in self._metrics.values())

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able health record: per-metric rolling p50/p99 against
        budget, current breach state and total breach episodes. This is
        the machine-readable signal downstream controllers poll."""
        metrics = {}
        for name, m in sorted(self._metrics.items()):
            s = sorted(m.buf)
            metrics[name] = {
                "n": m.n_total,
                "window_n": len(s),
                "last": round(m.last, 3),
                "p50": round(_nearest_rank(s, 0.50), 3),
                "p99": round(_nearest_rank(s, 0.99), 3),
                "budget": m.budget,
                "breached": m.breached,
                "breaches": m.breaches,
            }
        return {"type": "slo_report", "enabled": self.enabled,
                "window": self.window, "min_samples": self.min_samples,
                "metrics": metrics,
                "total_breaches": sum(m.breaches
                                      for m in self._metrics.values()),
                "healthy": not any(m.breached
                                   for m in self._metrics.values())}
