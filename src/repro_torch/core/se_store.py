"""SEStore — structure-of-arrays runtime for Semantic Elements (DESIGN.md §8).

The cache core used to be a ``dict[int, SemanticElement]`` of dataclasses:
every TTL purge walked the dict in Python, every LCFU eviction pass did a
full ``sorted(...)`` with a per-item Python score, and stage-1 retrieval
touched one query at a time. This module flips the layout: one parallel
numpy array per SE field, row-aligned with the ``VectorIndex`` embedding
matrix, so

  * TTL purge is a boolean mask (``active & (expires_at <= now)``),
  * ``lcfu_score`` is one vectorized expression over all rows,
  * victim selection is ``argpartition`` (O(n) expected) instead of an
    O(n log n) sort — with exact tie-break parity against the legacy
    stable sort (score, then se_id == insertion order),
  * batched lookups score candidates for a whole query block at once.

``SemanticElement`` (semantic_element.py) remains the public per-item API,
now as a thin live view onto one row of this store.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Iterator

import numpy as np

from repro_torch.core.semantic_element import SemanticElement


class SEStore:
    """Per-field parallel arrays for up to ``capacity`` SEs.

    Rows are assigned by the companion ``VectorIndex`` (same free-list), so
    ``store.freq[r]`` and ``index.emb[r]`` always describe the same SE.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.se_id = np.full(capacity, -1, np.int64)
        self.freq = np.zeros(capacity, np.int64)
        self.size = np.zeros(capacity, np.int64)
        self.last_access = np.zeros(capacity, np.float64)
        self.created_at = np.zeros(capacity, np.float64)
        self.expires_at = np.zeros(capacity, np.float64)
        self.cost = np.zeros(capacity, np.float64)
        self.latency = np.zeros(capacity, np.float64)
        self.staticity = np.zeros(capacity, np.int32)
        # freshness metadata (core/freshness.py): the origin knowledge
        # version this value was fetched at, and when the fetch happened
        # (refreshes update it; created_at keeps the first admission).
        # ``revalidating`` marks a row KNOWN stale (change-feed notice)
        # whose refetch is in flight — non-servable until refreshed.
        # ``freq_at_fetch`` snapshots freq at the last (re)fetch, so
        # "hits earned since last renewal" is freq - freq_at_fetch —
        # the refresh-ahead worthiness signal (lifetime freq would renew
        # dead entries forever).
        self.version = np.zeros(capacity, np.int64)
        self.fetched_at = np.zeros(capacity, np.float64)
        self.freq_at_fetch = np.zeros(capacity, np.int64)
        self.revalidating = np.zeros(capacity, bool)
        self.prefetched = np.zeros(capacity, bool)
        self.active = np.zeros(capacity, bool)
        self.key = np.empty(capacity, object)
        self.value = np.empty(capacity, object)
        self.intent = np.empty(capacity, object)
        # provenance: region id the value was transferred from (None =
        # fetched from the origin service by this cache's own region)
        self.origin = np.empty(capacity, object)
        self.id2row: dict[int, int] = {}
        # intent -> live se_ids: O(matching) change-feed fan-out instead
        # of an O(n) scan per invalidation notice
        self.by_intent: dict = {}

    # ---------------------------------------------------------- mutation

    def add(self, row: int, se_id: int, *, key, value, staticity, cost,
            latency, size, created_at, expires_at, freq, last_access,
            prefetched, intent, origin=None, version=0,
            fetched_at=None, freq_at_fetch=None) -> SemanticElement:
        if self.active[row]:
            # a silent clobber would leave the displaced SE's id2row entry
            # pointing at a row that now describes a different element
            raise ValueError(
                f"row {row} already holds live SE {int(self.se_id[row])}"
            )
        self.se_id[row] = se_id
        self.freq[row] = freq
        self.size[row] = size
        self.last_access[row] = last_access
        self.created_at[row] = created_at
        self.expires_at[row] = expires_at
        self.cost[row] = cost
        self.latency[row] = latency
        self.staticity[row] = staticity
        self.version[row] = version
        self.fetched_at[row] = created_at if fetched_at is None else fetched_at
        self.freq_at_fetch[row] = freq if freq_at_fetch is None \
            else freq_at_fetch
        self.revalidating[row] = False
        self.prefetched[row] = prefetched
        self.active[row] = True
        self.key[row] = key
        self.value[row] = value
        self.intent[row] = intent
        self.origin[row] = origin
        self.id2row[se_id] = row
        if intent is not None:
            self.by_intent.setdefault(intent, set()).add(se_id)
        return SemanticElement(self, row)

    def add_block(self, rows, se_ids, *, keys, values, staticity, cost,
                  latency, size, created_at, expires_at, freq=1,
                  prefetched=False, version=0) -> None:
        """Vectorized :meth:`add` for a uniform block (bulk prefill —
        ``CortexCache.insert_block``): per-row ids/keys/values, scalar
        economics broadcast, one fancy-indexed store per field instead
        of n scalar calls. Freshness metadata takes the same defaults
        scalar ``add`` derives (fetched_at = created_at, freq_at_fetch
        = freq); intent/origin stay None (bulk fills carry no
        change-feed subscription)."""
        ra = np.asarray(rows, np.int64)
        ids = np.asarray(se_ids, np.int64)
        if self.active[ra].any():
            raise ValueError("add_block would clobber live rows")
        self.se_id[ra] = ids
        self.freq[ra] = freq
        self.size[ra] = size
        self.last_access[ra] = created_at
        self.created_at[ra] = created_at
        self.expires_at[ra] = expires_at
        self.cost[ra] = cost
        self.latency[ra] = latency
        self.staticity[ra] = staticity
        self.version[ra] = version
        self.fetched_at[ra] = created_at
        self.freq_at_fetch[ra] = freq
        self.revalidating[ra] = False
        self.prefetched[ra] = prefetched
        self.active[ra] = True
        ko = np.empty(len(ra), object)
        ko[:] = list(keys)
        vo = np.empty(len(ra), object)
        vo[:] = list(values)
        self.key[ra] = ko
        self.value[ra] = vo
        self.intent[ra] = None
        self.origin[ra] = None
        self.id2row.update(zip(ids.tolist(), ra.tolist()))

    def snapshot_row(self, row: int) -> dict:
        """Full metadata copy of one live row as python scalars, keyed by
        the ``add`` kwarg names plus ``se_id`` — the tier-lifecycle
        handoff (core/tiers.py). Paired with ``add_meta`` so a
        demote/promote round trip copies every field by construction."""
        s = self
        return dict(
            se_id=int(s.se_id[row]), key=s.key[row], value=s.value[row],
            staticity=int(s.staticity[row]), cost=float(s.cost[row]),
            latency=float(s.latency[row]), size=int(s.size[row]),
            created_at=float(s.created_at[row]),
            expires_at=float(s.expires_at[row]),
            freq=int(s.freq[row]), last_access=float(s.last_access[row]),
            prefetched=bool(s.prefetched[row]), intent=s.intent[row],
            origin=s.origin[row], version=int(s.version[row]),
            fetched_at=float(s.fetched_at[row]),
            freq_at_fetch=int(s.freq_at_fetch[row]),
        )

    def add_meta(self, row: int, meta: dict) -> SemanticElement:
        """Re-home a ``snapshot_row`` dict at ``row``."""
        m = dict(meta)
        return self.add(row, m.pop("se_id"), **m)

    def remove_row(self, row: int) -> int:
        """Deactivate one row; returns the freed byte count."""
        size = int(self.size[row])
        se_id = int(self.se_id[row])
        del self.id2row[se_id]
        intent = self.intent[row]
        if intent is not None:
            ids = self.by_intent.get(intent)
            if ids is not None:
                ids.discard(se_id)
                if not ids:
                    del self.by_intent[intent]
        self.active[row] = False
        self.se_id[row] = -1
        self.key[row] = None
        self.value[row] = None
        self.intent[row] = None
        self.origin[row] = None
        return size

    # ------------------------------------------------------------ views

    def view(self, se_id: int) -> SemanticElement:
        return SemanticElement(self, self.id2row[se_id])

    # --------------------------------------------------------- vectorized

    def expired_rows(self, now: float) -> np.ndarray:
        """Row indices of all expired live SEs — the TTL-purge mask."""
        return np.flatnonzero(self.active & (now >= self.expires_at))

    def lcfu_scores(self, rows: np.ndarray, now: float) -> np.ndarray:
        """Algorithm 2 CalScore for a row block, one vector expression."""
        score = (
            np.log(self.freq[rows] + 1.0)
            * np.log(self.cost[rows] * 1e3 + 1.0)
            * np.log(self.latency[rows] + 1.0)
            * np.log(self.staticity[rows] + 1.0)
        )
        size = self.size[rows]
        live = (size > 0) & (self.expires_at[rows] - now > 0)
        return np.where(live, score / np.maximum(size, 1), 0.0)

    def _victim_keys(self, rows: np.ndarray, now: float, policy: str):
        """(primary, minor-tie keys) replicating the legacy sort orders:
        lcfu -> (score, se_id); lru -> (last_access, se_id);
        lfu -> (freq, last_access, se_id). se_id ascending == the old
        stable sort over dict insertion order."""
        if policy == "lru":
            return self.last_access[rows], (self.se_id[rows],)
        if policy == "lfu":
            return (self.freq[rows].astype(np.float64),
                    (self.last_access[rows], self.se_id[rows]))
        return self.lcfu_scores(rows, now), (self.se_id[rows],)

    def _smallest_in_order(self, rows, primary, ties, k: int) -> np.ndarray:
        """The k globally-smallest rows by (primary, *ties), in eviction
        order. argpartition selects a candidate superset (expanded to cover
        boundary ties), then only that superset is key-sorted."""
        m = len(rows)
        k = min(k, m)
        if k <= 0:
            return rows[:0]
        if k >= m:
            sel = np.arange(m)
        else:
            part = np.argpartition(primary, k - 1)[:k]
            thr = primary[part].max()
            sel = np.flatnonzero(primary <= thr)
        # np.lexsort keys: minor first, primary last
        order = np.lexsort(
            tuple(t[sel] for t in reversed(ties)) + (primary[sel],)
        )
        return rows[sel[order][:k]]

    def victim_rows(self, now: float, policy: str, *, n: int = 0,
                    need_bytes: int = 0) -> np.ndarray:
        """Rows to evict, in order: either exactly ``n`` victims, or just
        enough to free ``need_bytes``. Expected O(n_live) via argpartition
        with doubling-k, vs the legacy full sort."""
        rows = np.flatnonzero(self.active)
        if len(rows) == 0:
            return rows
        primary, ties = self._victim_keys(rows, now, policy)
        if n:
            return self._smallest_in_order(rows, primary, ties, n)
        k = min(32, len(rows))
        while True:
            cand = self._smallest_in_order(rows, primary, ties, k)
            freed = np.cumsum(self.size[cand])
            if freed[-1] >= need_bytes or len(cand) == len(rows):
                cut = int(np.searchsorted(freed, need_bytes)) + 1
                return cand[:cut] if freed[-1] >= need_bytes else cand
            k *= 2

    @property
    def usage(self) -> int:
        return int(self.size[self.active].sum())

    def __len__(self) -> int:
        return len(self.id2row)


class SEStoreMapping(Mapping):
    """dict-compatible read view (``cache.store``): se_id -> live SE view.

    Keeps the legacy ``dict[int, SemanticElement]`` API working — iteration
    order is insertion order (se_id ascending), membership is O(1)."""

    def __init__(self, store: SEStore):
        self._s = store

    def __getitem__(self, se_id: int) -> SemanticElement:
        return self._s.view(se_id)

    def __iter__(self) -> Iterator[int]:
        return iter(list(self._s.id2row))

    def __len__(self) -> int:
        return len(self._s.id2row)

    def __contains__(self, se_id) -> bool:
        return se_id in self._s.id2row
