"""Exponential reconnect/retry backoff for producers; a copy of the JAX
package's ``ingest/backoff.py``.

Reference parity: the PipeWire session loop's retry policy
(``src/infra/pipewire/runtime.rs:26-131``): session reconnects back off
exponentially 250 ms -> 8 s; resource retries 1 s -> 30 s; success resets.
Producers feeding :class:`~openmeters_tpu_torch.ingest.Transport` reuse the same
policy for their upstream connections.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Backoff:
    """Exponential backoff with the reference's session-retry envelope."""

    initial: float = 0.25  # runtime.rs:29
    maximum: float = 8.0  # runtime.rs:30
    factor: float = 2.0
    _current: float = dataclasses.field(default=0.0, init=False)
    _next_at: float = dataclasses.field(default=0.0, init=False)

    @staticmethod
    def session() -> "Backoff":
        return Backoff(0.25, 8.0)

    @staticmethod
    def resource() -> "Backoff":
        return Backoff(1.0, 30.0)  # runtime.rs:31-32

    def failure(self, now: float | None = None) -> float:
        """Record a failure; returns the delay before the next attempt."""
        now = time.monotonic() if now is None else now
        self._current = (
            self.initial if self._current == 0.0
            else min(self._current * self.factor, self.maximum)
        )
        self._next_at = now + self._current
        return self._current

    def success(self) -> None:
        self._current = 0.0
        self._next_at = 0.0

    def ready(self, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        return now >= self._next_at
