"""CortexCache — the cache abstraction layered on Seri (paper §4.3).

Turns probabilistic similarity into deterministic cache semantics:

* semantic-aware HIT — only after the full two-stage pipeline validates a
  candidate; a hit increments the SE's frequency.
* admission — every remote fetch result is inserted as a new SE with
  judge-estimated staticity → TTL; prefetched items enter with freq=0.
* LCFU eviction (Algorithm 2) — TTL purge first, then evict lowest
  value-score until under capacity.
* capacity is byte-based (cache_ratio × workload footprint in the
  benchmarks, matching the paper's "cache size ratio" axis).

Runtime layout (DESIGN.md §8): SE metadata lives in ``SEStore`` parallel
arrays row-aligned with the ``VectorIndex``, so the TTL purge is a boolean
mask, LCFU scoring is one vectorized expression, and victim selection uses
``argpartition`` instead of a full sort. ``lookup``/``insert`` are
one-element wrappers over ``lookup_batch``/``insert_batch`` internals, so
the scalar and batched paths share semantics by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.core.se_store import SEStore, SEStoreMapping
from repro_torch.core.semantic_element import SemanticElement, ttl_from_staticity
from repro_torch.core.seri import Seri, SeriResult, VectorIndex
from repro_torch.obs.metrics import ScanMetrics


@dataclasses.dataclass
class CacheStats:
    lookups: int = 0
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    ttl_evictions: int = 0
    invalidations: int = 0    # dropped by change-feed notice (freshness)
    judge_calls: int = 0
    prefetch_inserts: int = 0
    prefetch_hits: int = 0
    bytes_stored: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class CortexCache:
    def __init__(
        self,
        seri: Seri,
        *,
        capacity_bytes: int,
        max_ttl: float = 3600.0,
        min_ttl: float = 30.0,
        eviction: str = "lcfu",  # lcfu | lru | lfu (paper Table 6 ablation)
    ):
        self.seri = seri
        self.capacity_bytes = capacity_bytes
        self.max_ttl = max_ttl
        self.min_ttl = min_ttl
        self.eviction = eviction
        self.soa = SEStore(seri.index.capacity)
        self.store = SEStoreMapping(self.soa)  # dict-like se_id -> SE view
        self.usage = 0
        self.stats = CacheStats()
        # stage-1 scan accounting (DESIGN.md §12/§15). Deliberately NOT
        # in CacheStats: scan volume is batch-granularity dependent (a
        # scalar replay scans the index once per QUERY, a batched run
        # once per PASS), and CacheStats holds only quantities the
        # scalar and batched paths must agree on — same reasoning that
        # keeps warm_lookups in TierStats. First-class home:
        # obs.metrics.ScanMetrics (caveats documented there); the legacy
        # attribute names remain as read-only properties below.
        self.scan = ScanMetrics()
        self._next_id = 0
        # freshness seam: the tiered cache fires this when a warm entry
        # re-enters HOT, so the FreshnessManager can re-arm its
        # refresh-ahead timer (the timer dies while an entry sits warm)
        self.on_promote = None

    @property
    def rows(self) -> dict[int, int]:
        """se_id -> index row (row-aligned SoA: the store's own map)."""
        return self.soa.id2row

    # legacy scan-counter names (pre-§15), now backed by ScanMetrics.
    # ``last_scan_rows`` is the most recent pass (both tiers), consumed
    # synchronously by the engine for the scan-proportional latency term;
    # ``rows_scanned`` is the running total; the *_shard variants are the
    # §13 max-over-shards companions (equal whenever stage1_shards == 1).

    @property
    def last_scan_rows(self) -> int:
        return self.scan.last_rows

    @property
    def rows_scanned(self) -> int:
        return self.scan.total_rows

    @property
    def last_scan_shard_rows(self) -> int:
        return self.scan.last_max_shard_rows

    @property
    def rows_scanned_max_shard(self) -> int:
        return self.scan.total_max_shard_rows

    @property
    def stage1_shards(self) -> int:
        """Mesh shards the stage-1 index is partitioned over (DESIGN.md
        §13); 1 = unsharded. Both tiers share the shard count (the warm
        router is built from the same ClusterConfig)."""
        rt = self.seri.index.router
        return rt.n_shards if rt is not None else 1

    # ------------------------------------------------------------ lookup

    def account_hit(self, se: SemanticElement, now: float) -> None:
        """Shared hit bookkeeping — EVERY validated-hit path (full lookup,
        staged finalize, the engine's ANN-only ablation) must route through
        here so freq/last_access/hits/prefetch_hits stay comparable across
        modes."""
        se.freq += 1
        se.last_access = now
        self.stats.hits += 1
        if se.prefetched and se.freq == 1:
            self.stats.prefetch_hits += 1

    def lookup(self, query: str, q_emb: np.ndarray, now: float) -> SeriResult:
        return self.lookup_batch([query], q_emb[None], now)[0]

    def _stage1_blocks(self, q_embs: np.ndarray, now: float):
        """Stage 1 for a query block. Returns ``(blocks, flags)``:
        per-query ``(cands, sims)`` with sims ALIGNED to the surviving
        (unexpired) candidates, plus a per-query slow-tier-consult flag
        (always False here). The single stage-1 seam — the tiered cache
        overrides this to consult its warm tier, and every lookup flavor
        below goes through it."""
        # gate at the admission band's lower edge when a band is armed
        # (DESIGN.md §14): borderline candidates surface so the judge
        # can recover them; τ_sim exactly otherwise
        found = self.seri.index.search_batch(
            np.asarray(q_embs), self.seri.top_k, self.seri.stage1_gate
        )
        self.scan.note_pass(self.seri.index.last_scanned,
                            self.seri.index.last_scanned_max_shard)
        out = []
        for se_ids, sims in found:
            # revalidating rows are KNOWN stale (change-feed notice,
            # refetch in flight) — a miss now is a correct answer later
            keep = [
                j for j, i in enumerate(se_ids)
                if i in self.store and not self.store[i].expired(now)
                and not self.store[i].revalidating
            ]
            out.append(([self.store[se_ids[j]] for j in keep],
                        np.asarray(sims[keep], np.float32)))
        return out, [False] * len(out)

    def _judge_blocks(self, queries: Sequence[str], blocks,
                      now: float) -> list[SeriResult]:
        """Stage 2 over pre-fetched stage-1 blocks: candidates of every
        query validated in ONE ``score_pairs`` call (pair order = query
        order, candidate order — exactly the order sequential scalar
        calls would use, so per-pair-seeded judges draw identical
        scores), then per-query ``finalize`` applies hit bookkeeping in
        query order. Admission-band bypass (DESIGN.md §14) is applied
        per block BEFORE flattening: a block whose best similarity
        clears the band's upper edge serves its top candidate without
        judging (``judge_calls=0``; ``best_score`` then reports the
        stage-1 similarity, not a judge score). With no band armed every
        non-empty block is judged — identical to the legacy path."""
        pipe = self.seri.pipeline
        results: list[Optional[SeriResult]] = [None] * len(queries)
        flat_q: list[str] = []
        flat_key: list[str] = []
        judged: list[int] = []
        for i, (query, (cands, sims)) in enumerate(zip(queries, blocks)):
            if not cands:
                self.stats.misses += 1
                results[i] = SeriResult(False, None, 0, 0, 0.0, sims)
                continue
            if pipe.admit(sims, self.seri.tau_sim) == "bypass":
                se = self._rebind(cands[0], now)
                if se is not None:
                    self.account_hit(se, now)
                    results[i] = SeriResult(True, se, len(cands), 0,
                                            float(sims[0]), sims)
                    continue
                # top candidate vanished between stages — judge the rest
            flat_q.extend([query] * len(cands))
            flat_key.extend(c.key for c in cands)
            judged.append(i)
        flat_scores = (
            pipe.score_pairs(flat_q, flat_key) if flat_q
            else np.zeros(0, np.float32)
        )
        off = 0
        for i in judged:
            cands, sims = blocks[i]
            m = len(cands)
            results[i] = self.finalize(queries[i], cands,
                                       flat_scores[off:off + m], now,
                                       sims=sims)
            off += m
        return results

    def lookup_batch(self, queries: Sequence[str], q_embs: np.ndarray,
                     now: float) -> list[SeriResult]:
        """Batched full lookup: stage 1 for the whole block in one masked
        matmul / ``ann_topk`` launch, stage 2 in one judge call. Hit
        bookkeeping is applied in query order, so the hit/miss sequence is
        identical to sequential scalar lookups from the same state."""
        self.stats.lookups += len(queries)
        blocks, _ = self._stage1_blocks(q_embs, now)
        return self._judge_blocks(queries, blocks, now)

    # ---------------------------------------------------- staged lookup
    # The serving engine needs the two Seri stages split so the judge can
    # run as an async (deferrable) accelerator job (paper §4.4): stage1 =
    # ANN candidates; finalize = apply judge scores -> deterministic hit.

    def stage1(self, query: str, q_emb: np.ndarray, now: float):
        return self.stage1_batch([query], q_emb[None], now)[0]

    def stage1_batch(self, queries: Sequence[str], q_embs: np.ndarray,
                     now: float) -> list[list[SemanticElement]]:
        """ANN candidates for a query block (engine micro-batching)."""
        blocks, _ = self.stage1_batch_flagged(queries, q_embs, now)
        return [cands for cands, _ in blocks]

    def stage1_batch_flagged(self, queries: Sequence[str],
                             q_embs: np.ndarray, now: float):
        """``stage1_batch`` plus per-query slow-tier-consult flags (all
        False for the single-tier cache). Returns ``(blocks, flags)``
        with blocks = per-query ``(cands, sims)`` — the engine needs the
        aligned similarities for admission-band classification. The
        engine reads the flags for per-tier latency accounting — the
        consult policy is the cache's, and the engine must never
        re-derive it."""
        self.stats.lookups += len(queries)
        return self._stage1_blocks(q_embs, now)

    def _rebind(self, se, now: float):
        """Return the live HOT-tier view for a judge-validated winner, or
        None if it vanished between stage 1 and judge completion — or
        went revalidating meanwhile (serving it would serve known-stale
        knowledge). The tiered subclass overrides this to promote
        warm-tier winners."""
        if se.se_id not in self.store:
            return None
        live = self.store[se.se_id]
        return None if live.revalidating else live

    def finalize(self, query: str, cands, scores, now: float,
                 sims: Optional[np.ndarray] = None) -> SeriResult:
        self.stats.judge_calls += len(cands)
        if sims is None:
            sims = np.zeros(0, np.float32)
        # full-sort audit: the COMPLETE descending order is
        # semantically required here — the loop walks past winners whose
        # rows vanished between stage 1 and judge completion — and
        # len(scores) ≤ top_k (≤ 4 by default), so argpartition has
        # nothing to win. Hot-path top-k selections use
        # ``seri.topk_desc``/``topk_desc_stable`` instead.
        order = np.argsort(-np.asarray(scores))
        best = float(scores[order[0]]) if len(cands) else 0.0
        for j in order:
            if scores[j] >= self.seri.tau_lsm:
                se = self._rebind(cands[j], now)
                if se is None:  # evicted meanwhile
                    continue
                self.account_hit(se, now)
                return SeriResult(True, se, len(cands), len(cands), best,
                                  sims)
        self.stats.misses += 1
        return SeriResult(False, None, len(cands), len(cands), best, sims)

    def miss_no_candidates(self) -> None:
        self.stats.misses += 1

    # ------------------------------------------------------------ admit

    def insert(
        self,
        query: str,
        q_emb: np.ndarray,
        value: Any,
        *,
        now: float,
        cost: float,
        latency: float,
        size: int,
        staticity: Optional[int] = None,
        prefetched: bool = False,
        intent: Optional[int] = None,
        ttl: Optional[float] = None,
        origin: Optional[int] = None,
        version: int = 0,
        fetched_at: Optional[float] = None,
    ) -> SemanticElement:
        # `is None`, not truthiness: staticity 0 is a legitimate caller
        # override and must not trigger a judge re-estimate
        if staticity is None:
            staticity = self.seri.pipeline.staticity(query)
        if ttl is None:
            # explicit ttl: federated transfers admit with the SOURCE
            # entry's remaining lifetime so a copy never outlives its origin
            ttl = ttl_from_staticity(staticity, self.max_ttl, self.min_ttl)
        self._make_room(size, now)
        if self.seri.index.full:
            self._evict_n(1, now)
        se_id = self._next_id
        self._next_id += 1
        row = self.seri.index.add(se_id, q_emb)
        se = self.soa.add(
            row, se_id,
            key=query,
            value=value,
            staticity=staticity,
            cost=cost,
            latency=latency,
            size=size,
            created_at=now,
            expires_at=now + ttl,
            # the triggering miss counts as an access; only speculative
            # prefetches enter cold (paper §4.3: "prefetched items enter
            # with zero frequency")
            freq=0 if prefetched else 1,
            last_access=now,
            prefetched=prefetched,
            intent=intent,
            origin=origin,
            version=version,
            fetched_at=fetched_at,
        )
        self.usage += size
        self.stats.insertions += 1
        if prefetched:
            self.stats.prefetch_inserts += 1
        self.stats.bytes_stored = self.usage
        return se

    def insert_batch(self, items: Sequence[dict], *,
                     now: float) -> list[SemanticElement]:
        """Admit a block of fetch results. Staticity estimation is batched
        through the judge up front; the admissions themselves apply in
        order (each may trigger eviction that the next must observe), so
        the eviction sequence matches sequential ``insert`` calls."""
        staticities = [
            it["staticity"] if it.get("staticity") is not None
            else self.seri.pipeline.staticity(it["query"])
            for it in items
        ]
        out = []
        for it, st in zip(items, staticities):
            kw = dict(it)
            q = kw.pop("query")
            emb = kw.pop("q_emb")
            value = kw.pop("value")
            kw["staticity"] = st
            out.append(self.insert(q, emb, value, now=now, **kw))
        return out

    def insert_block(self, queries: Sequence[str], q_embs: np.ndarray,
                     values: Sequence[Any], *, now: float, cost: float,
                     latency: float, size: int, staticity: int,
                     ttl: float) -> np.ndarray:
        """Bulk admission for large prefills (the million-entry scaling
        sweeps): one index ``add_batch`` + one SoA ``add_block`` instead
        of n scalar ``insert`` calls. No judge, no eviction — every
        entry shares the scalar economics and the CALLER guarantees
        capacity (index rows checked here; byte budget is the caller's).
        Returns the assigned se_ids."""
        n = len(queries)
        if self.seri.index.capacity - len(self.seri.index) < n:
            raise RuntimeError("insert_block needs free index capacity")
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._next_id += n
        rows = self.seri.index.add_batch(ids, q_embs)
        self.soa.add_block(
            rows, ids, keys=queries, values=values, staticity=staticity,
            cost=cost, latency=latency, size=size, created_at=now,
            expires_at=now + ttl,
        )
        self.usage += size * n
        self.stats.insertions += n
        self.stats.bytes_stored = self.usage
        return ids

    def peek_semantic_scored(self, query: str, q_emb: np.ndarray,
                             now: float):
        """Best live stage-1 match WITHOUT any bookkeeping (no stats, no
        freq bump, no judge), as ``(se, sim)`` — or None. The gate is
        ``seri.stage1_gate``, so an armed admission band also widens the
        peek (in-band peers become lease candidates the pipeline can
        validate); with no band this is the τ_sim gate exactly."""
        se_ids, sims = self.seri.index.search(
            q_emb, self.seri.top_k, self.seri.stage1_gate
        )
        for i, sim in zip(se_ids, sims):  # similarity-descending
            if i in self.store:
                se = self.store[i]
                if not se.expired(now) and not se.revalidating:
                    return se, float(sim)
        return None

    def peek_semantic(self, query: str, q_emb: np.ndarray,
                      now: float) -> Optional[SemanticElement]:
        """Scored peek minus the similarity. Used by the prefetcher's
        presence check. NOTE: this trusts the ANN gate alone — callers
        that ship the value somewhere (federation leases) go through
        ``peek_lease`` so a stage-1 false positive (e.g. a confusable
        pair above τ_sim) can be caught by the judge pipeline instead of
        propagating as an info_accuracy loss."""
        hit = self.peek_semantic_scored(query, q_emb, now)
        return hit[0] if hit is not None else None

    def peek_lease(self, query: str, q_emb: np.ndarray,
                   now: float) -> Optional[SemanticElement]:
        """Federation's peek/lease validation through the one judge
        seam (DESIGN.md §14): ANN peek, then
        ``JudgePipeline.validate_lease`` decides whether the candidate
        ships — trust-band leases stay ANN-only (every lease, when no
        band is armed — the legacy protocol exactly), in-band leases pay
        one judge score at the HOLDER and must clear τ_lsm."""
        hit = self.peek_semantic_scored(query, q_emb, now)
        if hit is None:
            return None
        se, sim = hit
        if not self.seri.pipeline.validate_lease(
            query, se.key, sim, self.seri.tau_sim, self.seri.tau_lsm
        ):
            return None
        return se

    def contains_semantic(self, query: str, q_emb: np.ndarray,
                          now: float) -> bool:
        """Peek (no stats, no freq bump) — used by the prefetcher."""
        return self.peek_semantic(query, q_emb, now) is not None

    # --------------------------------------------------------- freshness
    # Mechanism only — the *policy* (drop vs revalidate, who refreshes a
    # federated copy) lives in core/freshness.py:FreshnessManager.

    def ses_for_intent(self, intent) -> list:
        """Live SE views whose admission-time intent equals ``intent``,
        in se_id (insertion) order — the invalidation fan-out set,
        O(matching) via the store's intent index. The tiered subclass
        appends its warm-tier views."""
        ids = self.soa.by_intent.get(intent)
        return [self.store[i] for i in sorted(ids)] if ids else []

    def has_intent(self, intent) -> bool:
        """Any live entry for this intent? O(1) — the change feed's
        keep-watching predicate."""
        return intent in self.soa.by_intent

    def invalidate_se(self, se_id: int, now: float) -> bool:
        """Drop one entry because its origin knowledge changed. Counted
        as ``invalidations`` — NOT an eviction (it did not lose a
        capacity contest) and NOT a TTL lapse. Never demotes: a
        known-stale value is not worth keeping in any tier."""
        row = self.soa.id2row.get(se_id)
        if row is None:
            return False
        self._drop_rows(np.asarray([row]))
        self.stats.invalidations += 1
        return True

    def refresh_entry(self, se_id: int, *, value: Any, version: int,
                      now: float,
                      ttl: Optional[float] = None
                      ) -> Optional[SemanticElement]:
        """Revalidate an entry IN PLACE: new value + version, fetch
        timestamp bumped, expiry renewed (staticity-derived TTL unless
        given). The row, se_id, embedding, and hit statistics all
        survive — live ``SemanticElement`` views across the refresh keep
        working, which is what lets refresh-ahead renew an entry while a
        judge micro-batch still holds views on it. Size is unchanged by
        construction (a refresh re-fetches the same intent's value)."""
        row = self.soa.id2row.get(se_id)
        if row is None:
            return None
        if ttl is None:
            ttl = ttl_from_staticity(
                int(self.soa.staticity[row]), self.max_ttl, self.min_ttl
            )
        self.soa.value[row] = value
        self.soa.version[row] = version
        self.soa.fetched_at[row] = now
        self.soa.freq_at_fetch[row] = self.soa.freq[row]
        self.soa.expires_at[row] = now + ttl
        self.soa.revalidating[row] = False
        return self.store[se_id]

    # ------------------------------------------------------------ evict

    def _remove(self, se_id: int, *, ttl: bool) -> None:
        row = self.soa.id2row[se_id]
        self._remove_rows(np.asarray([row]), ttl=ttl)

    def _drop_rows(self, rows: np.ndarray) -> None:
        """Free hot rows (index + SoA + usage) WITHOUT eviction stats —
        the shared tail of eviction, TTL purge, and tier demotion."""
        freed = int(self.soa.size[rows].sum())
        self.seri.index.remove_rows(rows)
        for r in rows:
            self.soa.remove_row(int(r))
        self.usage -= freed
        self.stats.bytes_stored = self.usage

    def _remove_rows(self, rows: np.ndarray, *, ttl: bool) -> None:
        """Batched removal: index rows + SoA fields in one pass."""
        n = len(rows)
        if not n:
            return
        self._drop_rows(rows)
        if ttl:
            self.stats.ttl_evictions += n
        else:
            self.stats.evictions += n

    def purge_expired(self, now: float) -> int:
        """TTL purge as one boolean mask over the SoA arrays."""
        dead = self.soa.expired_rows(now)
        self._remove_rows(dead, ttl=True)
        return len(dead)

    def _retire_victims(self, victims: np.ndarray, now: float) -> None:
        """Victim sink: base cache evicts outright; the tiered cache
        overrides this to demote into its warm tier instead."""
        self._remove_rows(victims, ttl=False)

    def _make_room(self, incoming: int, now: float) -> None:
        if self.usage + incoming <= self.capacity_bytes:
            return
        self.purge_expired(now)  # TTL purge first (Algorithm 2 line 6)
        need = self.usage + incoming - self.capacity_bytes
        if need <= 0:
            return
        victims = self.soa.victim_rows(now, self.eviction, need_bytes=need)
        self._retire_victims(victims, now)

    def _evict_n(self, n: int, now: float) -> None:
        victims = self.soa.victim_rows(now, self.eviction, n=n)
        self._retire_victims(victims, now)

    # ------------------------------------------------------------ misc

    def __len__(self) -> int:
        return len(self.store)


def make_cache(
    *,
    capacity_bytes: int,
    dim: int,
    judge,
    index_capacity: int = 8192,
    tau_sim: float = 0.9,
    tau_lsm: float = 0.9,
    top_k: int = 4,
    eviction: str = "lcfu",
    max_ttl: float = 3600.0,
    backend: str = "kernel",
    device="cuda",
    cluster=None,
) -> CortexCache:
    """``backend="kernel"`` runs stage 1 on the CUDA kernels over an index
    mirrored on ``device``; ``backend="numpy"`` is the host path.
    ``cluster`` (a ``core.clustering.ClusterConfig``) switches stage 1 to
    the clustered IVF routing (DESIGN.md §12); None = brute force."""
    router = None
    if cluster is not None:
        from repro_torch.core.clustering import ClusterRouter

        router = ClusterRouter(index_capacity, dim, cluster)
    index = VectorIndex(index_capacity, dim, backend=backend, router=router,
                        device=device)
    seri = Seri(index, judge, tau_sim=tau_sim, tau_lsm=tau_lsm, top_k=top_k)
    return CortexCache(
        seri, capacity_bytes=capacity_bytes, max_ttl=max_ttl,
        eviction=eviction,
    )
