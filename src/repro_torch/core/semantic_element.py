"""Semantic Element (SE) — Cortex's core caching unit (paper §4.1, Fig 5).

An SE encapsulates one discrete agent↔tool interaction: the agent's query
(semantic key), the retrieved knowledge (value), the embedding fingerprint,
and the performance-aware metadata driving eviction/TTL decisions:

  * staticity  1–10  — expected validity duration class (judge-estimated):
                       10 = stable fact, 5 = moderate, 1 = ephemeral.
  * cost ($), latency (s) — what the remote fetch cost; retained items
                       with high fetch cost are worth more per byte.
  * freq       — confirmed semantic-hit count (only validated hits count).
  * size       — bytes of the cached value.

Since the SoA refactor (DESIGN.md §8) the per-SE state lives in the
``SEStore`` parallel arrays; ``SemanticElement`` is a thin *live view*
onto one store row. Attribute reads/writes go straight to the arrays, so
``se.freq += 1`` is visible to the vectorized eviction path and vice
versa. The class keeps the old dataclass surface (same field names,
``expired``/``ttl_remaining``/``lcfu_score``)."""
from __future__ import annotations

from typing import Any, Optional

import numpy as np


def _field(name, cast):
    def get(self):
        return cast(getattr(self._store, name)[self._row])

    def set_(self, v):
        getattr(self._store, name)[self._row] = v

    return property(get, set_)


class SemanticElement:
    __slots__ = ("_store", "_row", "se_id")

    # storage tier this view lives in; the warm tier's view class
    # (core/tiers.py::WarmElement) reports "warm" so retrieval/hit paths
    # can route promotions without isinstance checks across modules
    tier = "hot"

    def __init__(self, store, row: int):
        self._store = store
        self._row = int(row)
        self.se_id = int(store.se_id[row])

    # numeric metadata: live views into the SoA arrays
    freq = _field("freq", int)
    size = _field("size", int)
    staticity = _field("staticity", int)
    cost = _field("cost", float)
    latency = _field("latency", float)
    created_at = _field("created_at", float)
    expires_at = _field("expires_at", float)
    # freshness (core/freshness.py): origin knowledge version this value
    # was fetched at + when; a refresh bumps both in place. revalidating
    # = known stale, refetch in flight, not servable meanwhile
    version = _field("version", int)
    fetched_at = _field("fetched_at", float)
    freq_at_fetch = _field("freq_at_fetch", int)
    revalidating = _field("revalidating", bool)
    last_access = _field("last_access", float)
    prefetched = _field("prefetched", bool)

    @property
    def key(self) -> str:
        return self._store.key[self._row]

    @property
    def value(self) -> Any:
        return self._store.value[self._row]

    @property
    def intent(self) -> Optional[int]:
        return self._store.intent[self._row]

    @property
    def origin(self) -> Optional[int]:
        """Provenance: region id this value was transferred from, or None
        if this cache's own region fetched it from the origin service."""
        return self._store.origin[self._row]

    @property
    def row(self) -> int:
        return self._row

    @property
    def valid(self) -> bool:
        """False once this row was evicted (or reused by another SE)."""
        return int(self._store.se_id[self._row]) == self.se_id

    # ------------------------------------------------------------ logic

    def expired(self, now: float) -> bool:
        return now >= self.expires_at

    def ttl_remaining(self, now: float) -> float:
        return self.expires_at - now

    def lcfu_score(self, now: float) -> float:
        """Algorithm 2 CalScore: log-composite value per byte (delegates
        to the store's vectorized kernel so view and batch paths agree
        bit-for-bit)."""
        return float(
            self._store.lcfu_scores(np.asarray([self._row]), now)[0]
        )

    def __repr__(self) -> str:
        return (f"SemanticElement(se_id={self.se_id}, key={self.key!r}, "
                f"freq={self.freq}, size={self.size})")


def ttl_from_staticity(staticity: int, max_ttl: float,
                       min_ttl: float = 30.0) -> float:
    """Map the 1–10 staticity class to a TTL. Exponential in the class so
    ephemeral items (1–3) expire in minutes while stable facts (9–10) live
    at the user-defined ceiling (paper §4.1/§4.3 aging mechanism)."""
    frac = (max(1, min(10, staticity)) - 1) / 9.0
    return min_ttl * (max_ttl / min_ttl) ** frac
