"""Shared virtual clock for discrete-event simulation (DESIGN.md §9).

One heap of ``(time, seq, fn, args)`` events. A single engine owns a
private clock; a :class:`~repro_torch.serving.federation.FederationRunner`
hands the SAME clock to every per-region engine, so all regions advance
through one globally-ordered event stream — peer peeks observe sibling
caches at the exact virtual instant the probe arrives, and replaying the
same seeds yields the same interleaving (the ``seq`` tie-break makes
simultaneous events deterministic regardless of region count).
"""
from __future__ import annotations

import heapq
import itertools


class VirtualClock:
    """Monotonic virtual time + the event heap that advances it."""

    def __init__(self):
        self.now = 0.0
        self._events: list = []
        self._seq = itertools.count()

    def push(self, t: float, fn, *args) -> None:
        heapq.heappush(self._events, (t, next(self._seq), fn, args))

    @property
    def pending(self) -> int:
        return len(self._events)

    def step(self) -> None:
        """Pop and fire the next event. Time never moves backwards: an
        event scheduled in the past (by a caller that pre-advanced its own
        local time, e.g. retry backoff) fires at the current instant."""
        t, _, fn, args = heapq.heappop(self._events)
        self.now = max(self.now, t)
        fn(*args) if args else fn(self.now)
