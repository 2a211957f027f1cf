"""Bounded exponential backoff — the bench.py platform-retry pattern
(``min(base * 2**attempt, cap)``) extracted so every reconnecting
endpoint paces identically (docs/ROBUSTNESS.md "Liveness supervision").

Used by ``runtime/streaming.py`` (``VDISubscriber`` / ``SteeringEndpoint``
reconnects after a liveness deadline). Pure stdlib, safe at module load
from anywhere. A copy of the reference's ``utils/retry.py``.
"""

from __future__ import annotations


def backoff_delay(attempt: int, base_s: float = 0.5, cap_s: float = 30.0,
                  factor: float = 2.0) -> float:
    """Delay before retry ``attempt`` (0-based): ``base * factor**attempt``
    capped at ``cap_s``. Deterministic — chaos tests replay exactly."""
    if attempt < 0:
        attempt = 0
    return min(base_s * factor ** attempt, cap_s)


class Backoff:
    """Stateful wrapper: ``next_delay()`` walks the bounded exponential
    ladder, ``reset()`` (call on success / first sign of life) rewinds it
    to the base delay."""

    def __init__(self, base_s: float = 0.5, cap_s: float = 30.0,
                 factor: float = 2.0):
        if base_s <= 0 or cap_s < base_s or factor < 1.0:
            raise ValueError(
                f"need 0 < base_s <= cap_s and factor >= 1, got "
                f"base_s={base_s}, cap_s={cap_s}, factor={factor}")
        self.base_s = base_s
        self.cap_s = cap_s
        self.factor = factor
        self.attempt = 0

    def next_delay(self) -> float:
        d = backoff_delay(self.attempt, self.base_s, self.cap_s,
                          self.factor)
        self.attempt += 1
        return d

    def reset(self) -> None:
        self.attempt = 0
