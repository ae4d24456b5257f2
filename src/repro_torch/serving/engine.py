"""Virtual-time discrete-event serving engine.

Reproduces the paper's end-to-end pipeline (Fig 4/6): agent think rounds on
the accelerator, tool calls intercepted by the data client, two-stage cache
lookups with the judge as a *deferrable* accelerator job (timeout ⇒ treated
as a miss — the paper's degradation-not-blocking property), remote fetches
through the rate-limited WAN service, LCFU admission/eviction, Markov
prefetching, and periodic threshold recalibration.

Concurrent requests are *micro-batched* (DESIGN.md §8): stage-1 lookups
that land within one host-path window are flushed together through
``CortexCache.stage1_batch`` (one masked matmul over the whole query
block), and the judge dispatcher drains its backlog in micro-batches —
one accelerator job and ONE ``score_pairs`` call per batch, with the
shared prompt prefill amortized across co-batched requests (§4.4).

Modes: "vanilla" (no cache), "exact" (exact-match KV cache),
"cortex" (full), "cortex-nojudge" (ANN-only ablation, Fig 13).

Events live on a :class:`~repro_torch.serving.clock.VirtualClock`. A solo
engine owns a private clock; under federation (DESIGN.md §9) every
per-region engine shares ONE clock, and an optional ``router`` redirects
cache misses through the cross-region peek/transfer path before the
origin WAN fetch.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.core.cache import CortexCache
from repro_torch.core.prefetch import MarkovPrefetcher
from repro_torch.core.semantic_element import ttl_from_staticity
from repro_torch.core.recalibrate import EvalRecord, recalibrate
from repro_torch.data.workloads import Request
from repro_torch.data.world import SemanticWorld
from repro_torch.obs.metrics import (STALE_AGE_EDGES, FixedHistogram,
                               MetricsRegistry, percentile)
from repro_torch.obs.sampler import limiter_headroom
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.clock import VirtualClock
from repro_torch.serving.gpu import GPU, GPUConfig, judge_batch_tokens
from repro_torch.serving.remote import RemoteDataService


@dataclasses.dataclass
class EngineConfig:
    think_tokens: float = 160.0
    answer_tokens: float = 160.0
    judge_tokens: Optional[float] = None  # prefill-only classification
                                        # job cost; None (default) =
                                        # derive from the judge model
                                        # config's prefill FLOPs via the
                                        # cache's JudgePipeline
                                        # (DESIGN.md §14). A float pins
                                        # the legacy hand-set cost.
    t_cache_cpu: float = 0.02           # embed + ANN fixed cost (Fig 11)
    t_cache_per_row: float = 0.0        # stage-1 cost PER ROW SCANNED:
                                        # the full pass costs
                                        # t_cache_cpu + per_row · rows,
                                        # so index size (and the IVF
                                        # router's sublinear scan,
                                        # DESIGN.md §12) shows up in
                                        # end-to-end latency. 0 = legacy
                                        # flat-cost model.
    t_shard_merge: float = 0.0          # cross-shard top-k merge cost
                                        # per stage-1 pass (§13): added
                                        # to the scan term only when the
                                        # cache's stage-1 index is
                                        # partitioned (stage1_shards>1)
    judge_timeout: float = 0.25         # deferred validation ⇒ miss
    judge_batch_max: int = 8            # judge micro-batch size cap (§4.4)
    judge_batch_marginal: float = 0.5   # marginal prefill cost per co-batched req
    cache_access_latency: float = 0.0   # RTT to a non-local (global) cache
    t_cache_warm: float = 0.01          # extra stage-1 latency when the
                                        # WARM tier is consulted (§10)
    closed_loop: Optional[int] = None   # concurrency, or None = open loop
    prefetch: bool = True
    prefetch_confidence: float = 0.55
    prefetch_min_headroom: float = 0.2
    recalibrate_every: Optional[float] = None  # seconds; None = off
    recal_samples: int = 16             # ground-truth fetches per tick
    recal_smooth: float = 0.5           # EMA weight on the new tau estimate
    p_target: float = 0.99
    em_p_base: float = 0.79             # EM | correct info (per dataset)
    em_p_wrong: float = 0.10            # EM | wrong cached info
    gpu_cost_per_hour: float = 1.49     # Table 5
    warmup_frac: float = 0.0            # exclude first fraction from stats
    stale_age_reservoir: Optional[int] = None  # bound the stale-age
                                        # histogram's raw-sample list to
                                        # a seeded reservoir of this size
                                        # (long burst runs, §16); None =
                                        # raw retention, the
                                        # stale_age_mean bit-parity mode
    seed: int = 0


@dataclasses.dataclass
class RequestRecord:
    rid: int
    arrival: float
    t_done: float = 0.0
    latency: float = 0.0
    agent_time: float = 0.0
    cache_time: float = 0.0
    remote_time: float = 0.0
    rounds: int = 0
    cache_hits: int = 0
    remote_calls: int = 0
    peer_transfers: int = 0   # remote calls served by a sibling region
    info_correct: bool = True
    em_correct: bool = False


@dataclasses.dataclass
class _ReqState:
    req: Request
    rec: RequestRecord
    round: int = 0
    round_t0: float = 0.0
    info_values: list = dataclasses.field(default_factory=list)


class ExactCache:
    """Exact-key baseline (Agent_exact): byte-identical query match, LRU.

    Freshness parity with the semantic cache: inserts that carry a
    staticity class age through the same ``ttl_from_staticity`` curve, so
    the exact and semantic baselines expire comparably instead of the
    exact cache serving every entry for the full ``max_ttl``."""

    def __init__(self, capacity_bytes: int, max_ttl: float = 3600.0,
                 min_ttl: float = 30.0):
        self.capacity = capacity_bytes
        self.max_ttl = max_ttl
        self.min_ttl = min_ttl
        self.d: dict[str, tuple[Any, float, int]] = {}  # val, expires, size
        # LRU order; deque so the evict-side popleft is O(1) (the
        # recency-bump ``remove`` stays O(n) either way)
        self.order: collections.deque[str] = collections.deque()
        self.usage = 0
        self.hits = 0
        self.lookups = 0

    def lookup(self, query: str, now: float):
        self.lookups += 1
        ent = self.d.get(query)
        if ent is None:
            return None
        if now >= ent[1]:
            # expired: reclaim the bytes NOW — leaving the entry resident
            # kept its size counted in `usage` forever, silently shrinking
            # effective capacity with every TTL lapse
            self.usage -= self.d.pop(query)[2]
            self.order.remove(query)
            return None
        self.hits += 1
        self.order.remove(query)
        self.order.append(query)
        return ent[0]

    def insert(self, query: str, value, size: int, now: float,
               staticity: int | None = None):
        if query in self.d:
            # refresh value + TTL in place (a stale entry would otherwise
            # never be replaced and the key would permanently miss)
            self.usage -= self.d.pop(query)[2]
            self.order.remove(query)
        while self.usage + size > self.capacity and self.order:
            victim = self.order.popleft()
            self.usage -= self.d.pop(victim)[2]
        ttl = self.max_ttl if staticity is None else ttl_from_staticity(
            staticity, self.max_ttl, self.min_ttl
        )
        self.d[query] = (value, now + ttl, size)
        self.order.append(query)
        self.usage += size

    @property
    def hit_rate(self):
        return self.hits / self.lookups if self.lookups else 0.0


class Engine:
    def __init__(
        self,
        *,
        world: SemanticWorld,
        requests: list[Request],
        mode: str = "cortex",
        cache: Optional[CortexCache] = None,
        exact: Optional[ExactCache] = None,
        remote: Optional[RemoteDataService] = None,
        gpu: Optional[GPU] = None,
        cfg: Optional[EngineConfig] = None,
        clock: Optional[VirtualClock] = None,
        router=None,
        region_id: int = 0,
        freshness=None,
        tracer=None,
        overload=None,
        faults=None,
    ):
        self.world = world
        self.requests = requests
        self.mode = mode
        self.cache = cache
        self.exact = exact
        self.remote = remote or RemoteDataService()
        self.gpu = gpu or GPU(GPUConfig())
        self.cfg = cfg or EngineConfig()
        self.clock = clock or VirtualClock()
        # Federation seam: when set, cache misses route through the
        # cross-region peek/transfer path instead of going straight to the
        # origin service (serving/federation.py).
        self.router = router
        self.region_id = region_id
        # Freshness seam (core/freshness.py): when set, admissions arm
        # change-feed watches + refresh-ahead timers, and cache hits are
        # checked against the world's CURRENT knowledge version.
        self.freshness = freshness
        # Observability seam (DESIGN.md §15): span tracing + the unified
        # metrics registry. The tracer only *records* virtual instants
        # the event flow already computes — it never pushes clock events
        # — so a traced run is bit-identical in virtual time to an
        # untraced one, and NULL_TRACER makes the disabled path free.
        self.trace = tracer if tracer is not None else NULL_TRACER
        # Robustness seam (DESIGN.md §17): an armed OverloadController
        # actuates shed-to-nojudge / background-pause / serve-stale
        # policies off the §16 telemetry; an armed FaultSchedule injects
        # deterministic failure windows (judge slowdown is read here,
        # brownouts live in RemoteDataService, outages in Federation).
        # Both default to None and every consult is None-gated, so
        # fault-free runs stay bit-identical.
        self.overload = overload
        self.faults = faults
        self.stale_hits = 0
        self.stale_age_hist = FixedHistogram(
            STALE_AGE_EDGES, max_samples=self.cfg.stale_age_reservoir,
            seed=self.cfg.seed,
        )
        self.rng = np.random.default_rng(self.cfg.seed)
        self.prefetcher = MarkovPrefetcher(
            confidence=self.cfg.prefetch_confidence
        )
        self.records: list[RequestRecord] = []
        self.eval_log: list[EvalRecord] = []
        self.recal_history: list[tuple[float, float]] = []
        self.recal_cost = 0.0
        self._pending = collections.deque(requests)
        self._active = 0
        self._judge_backlog: collections.deque[dict] = collections.deque()
        self._stage1_pending: list[tuple] = []
        self._stage1_open: Optional[float] = None  # current pass open time
        # instant the host finishes streaming the current pass's scanned
        # rows (scan-proportional latency model, DESIGN.md §12); a new
        # pass cannot open before it
        self._stage1_busy_until = 0.0
        self._done = 0
        self._warm_cut = int(len(requests) * self.cfg.warmup_frac)
        self._warm_snap = None
        self.metrics = MetricsRegistry()
        self._register_metrics()
        if self.trace.enabled:
            # bind the background-span emitters (holder-side lease
            # validation, refresh fetches, invalidation drops) — only
            # when tracing, so untraced construction is untouched
            if self.cache is not None:
                self.cache.seri.pipeline.bind_tracer(
                    self.trace, self.clock, self.region_id
                )
            if self.freshness is not None:
                self.freshness.bind_tracer(self.trace, self.region_id)

    @property
    def stale_ages(self) -> list[float]:
        """Legacy name: raw stale-age samples, now held by the §15
        FixedHistogram (which needs the raw values for a bit-identical
        mean)."""
        return self.stale_age_hist.values

    def _register_metrics(self) -> None:
        """Populate the MetricsRegistry (DESIGN.md §15) with *pull*
        collectors over the existing counter objects. Pull-based means
        every increment site keeps its exact legacy code path — the
        registry observes state at ``snapshot()`` time — which is what
        lets ``summary()`` be rebuilt on top of the registry while
        staying byte-identical. Collectors for absent components return
        ``{}``, so the snapshot's key set reflects the engine's actual
        configuration."""
        reg = self.metrics
        reg.register("engine", lambda: {
            "stale_hits": self.stale_hits,
            "stale_age_mean": self.stale_age_hist.mean,
            "stale_age_hist": self.stale_age_hist.to_dict(),
            "recal_cost": self.recal_cost,
        })
        reg.register("remote", lambda: {
            "calls": self.remote.calls,
            "attempts": self.remote.attempts,
            "retries": self.remote.retries,
            "failed": getattr(self.remote, "failed", 0),
            "total_cost": self.remote.total_cost,
            "throttled_wait": getattr(self.remote, "throttled_wait", 0.0),
        })

        def overload_ns():
            # §17 actuation counters; read dynamically so a controller
            # attached after construction is still observed
            if self.overload is None:
                return {}
            return self.overload.metrics()

        reg.register("overload", overload_ns)
        reg.register("gpu", lambda: {
            "n_chips": self.gpu.n_chips,
            "agent_lane_tokens": float(self.gpu.agent.busy_tokens),
            "judge_lane_tokens": float(self.gpu.judge.busy_tokens),
        })

        def gauge_ns():
            # live pressure gauges (DESIGN.md §16): instantaneous state
            # the cumulative counters can't see — sampled by the
            # TimeSeriesSampler, never projected into summary(), and
            # every read is pure (limiter headroom via the non-mutating
            # peek, NOT TokenBucket.headroom)
            from repro_torch.obs.sampler import limiter_headroom

            g = {
                "inflight": self._active,
                "judge_backlog": len(self._judge_backlog),
                "stage1_pending": len(self._stage1_pending),
                "limiter_headroom": limiter_headroom(
                    self.remote, self.clock.now
                ),
            }
            g.update(self.gpu.occupancy())
            return g

        reg.register("gauge", gauge_ns)

        def cache_ns():
            if self.cache is None:
                return {}
            d = dataclasses.asdict(self.cache.stats)
            d["items"] = len(self.cache)
            return d

        def scan_ns():
            # ScanMetrics fields (batch-granularity caveats documented
            # on the dataclass): total_rows / total_max_shard_rows feed
            # the summary's rows_scanned / rows_scanned_max_shard
            if self.cache is None:
                return {}
            return dataclasses.asdict(self.cache.scan)

        def pipeline_ns():
            if self.cache is None:
                return {}
            pipe = self.cache.seri.pipeline
            d = dataclasses.asdict(pipe.stats)
            d["band_width"] = (float(pipe.band.width)
                               if pipe.band is not None else 0.0)
            d["base_tokens"] = float(pipe.base_tokens)
            return d

        def shard_ns():
            if self.cache is None:
                return {}
            shards = getattr(self.cache, "stage1_shards", 1)
            if shards <= 1:
                return {}
            rt = self.cache.seri.index.router
            reb, mig, chunks = (rt.rebalances, rt.migrated_rows,
                                rt.migration_chunks)
            wix = getattr(self.cache, "warm", None)
            if wix is not None and wix.index.router is not None:
                wrt = wix.index.router
                reb += wrt.rebalances
                mig += wrt.migrated_rows
                chunks += wrt.migration_chunks
            return {"shards": shards, "rebalances": reb,
                    "migrated_rows": mig, "migration_chunks": chunks}

        def tier_ns():
            ts = getattr(self.cache, "tier_stats", None)
            if ts is None:
                return {}
            d = dataclasses.asdict(ts)
            d["warm_items"] = len(self.cache.warm)
            d["warm_bytes"] = self.cache.warm.usage
            return d

        def freshness_ns():
            if self.freshness is None:
                return {}
            return dataclasses.asdict(self.freshness.stats)

        def exact_ns():
            if self.exact is None:
                return {}
            return {"hits": self.exact.hits,
                    "lookups": self.exact.lookups}

        reg.register("cache", cache_ns)
        reg.register("scan", scan_ns)
        reg.register("pipeline", pipeline_ns)
        reg.register("shard", shard_ns)
        reg.register("tier", tier_ns)
        reg.register("freshness", freshness_ns)
        reg.register("exact", exact_ns)

    # ------------------------------------------------------------ events

    @property
    def _now(self) -> float:
        return self.clock.now

    @property
    def done(self) -> bool:
        return self._done >= len(self.requests)

    def _push(self, t: float, fn, *args):
        self.clock.push(t, fn, *args)

    def _push_lane_event(self, lane):
        nxt = lane.next_completion()
        if nxt is not None:
            ver = lane.version
            self._push(nxt, self._lane_tick, lane, ver)

    def _lane_tick(self, lane, ver):
        if ver != lane.version:
            return  # stale
        done = lane.complete_due(self._now)
        for job in done:
            job.callback(self._now)
        self._push_lane_event(lane)
        self._dispatch_judges()
        if self.gpu.rebalance(self._now):
            self._push_lane_event(self.gpu.agent)

    def _submit(self, lane, tokens, cb):
        lane.submit(self._now, tokens, cb)
        if self.gpu.rebalance(self._now):
            self._push_lane_event(self.gpu.agent)
        self._push_lane_event(lane)

    # ------------------------------------------------------------ fsm

    def _start_request(self, req: Request):
        rec = RequestRecord(rid=req.rid, arrival=req.arrival)
        st = _ReqState(req=req, rec=rec)
        self._active += 1
        self._begin_round(st)

    def _begin_round(self, st: _ReqState):
        st.round_t0 = self._now
        t0 = self._now

        def think_done(now):
            st.rec.agent_time += now - t0
            self.trace.span(st.rec.rid, "agent_think", t0, now,
                            self.region_id)
            self._tool_call(st)

        self._submit(self.gpu.agent, self.cfg.think_tokens, think_done)

    def _tool_call(self, st: _ReqState):
        q = st.req.query_for_round(st.round)
        if self.mode == "vanilla" or (
            self.mode == "exact" and self.exact is None
        ):
            self._go_remote(st)
            return
        if self.mode == "exact":
            val = self.exact.lookup(q, self._now)
            if val is not None:
                self._observe(st, val, from_cache=True)
            else:
                self._go_remote(st)
            return
        # cortex / cortex-nojudge: embed+ANN on host, then judge on chip.
        # The host runs one batched stage-1 pass at a time: requests
        # arriving at the pass's open instant ride it; later arrivals
        # queue for the next pass (which opens when this one flushes), so
        # every request pays at least one full t_cache_cpu and the batch
        # contents are frozen when the pass starts.
        self._stage1_pending.append((st, q, self._now))
        if self._stage1_open is None:
            # the host may still be streaming the previous pass's scan
            # (scan-proportional model): the new pass opens when it ends
            open_at = max(self._now, self._stage1_busy_until)
            self._stage1_open = open_at
            self._push(open_at + self._stage1_latency(), self._stage1_flush)

    def _stage1_latency(self) -> float:
        """Host embed+ANN time, plus the network RTT when the cache is a
        shared global one homed in another region (federation's
        single-global-cache baseline, DESIGN.md §9)."""
        return self.cfg.t_cache_cpu + self.cfg.cache_access_latency

    def _stage1_flush(self, now=None):
        open_t = self._stage1_open
        batch = [e for e in self._stage1_pending if e[2] <= open_t]
        self._stage1_pending = [
            e for e in self._stage1_pending if e[2] > open_t
        ]
        self._stage1_open = None
        if not batch:
            if self._stage1_pending:  # next pass opens as this one retires
                self._stage1_open = self._now
                self._push(self._now + self._stage1_latency(),
                           self._stage1_flush)
            return
        now = self._now
        queries = [q for _, q, _ in batch]
        q_embs = np.stack([self.world.embed(q) for q in queries])
        # every warm CONSULT pays the tier's extra access latency before
        # proceeding (§10 per-tier stage-1 cost) — including consults
        # that came back empty. The cache reports the consult fact per
        # query; the engine must not re-derive that policy.
        blocks, consults = self.cache.stage1_batch_flagged(
            queries, q_embs, now
        )
        # scan-proportional stage-1 cost (§12): the flush instant covers
        # the FIXED host cost (embed + routing); streaming the scanned
        # rows takes per_row · rows_scanned longer, during which the
        # host is busy (next pass waits) and this batch's resolutions
        # are deferred. per_row = 0 reproduces the legacy flat model
        # exactly — same events, same order. Under a sharded stage 1
        # (§13) the shards stream in parallel, so the pass charges the
        # BUSIEST shard's rows plus one cross-shard merge term; at
        # stage1_shards == 1 the expression reduces to the §12 model
        # verbatim (last_scan_shard_rows == last_scan_rows, no merge).
        shards = getattr(self.cache, "stage1_shards", 1)
        t_scan = self.cfg.t_cache_per_row * self.cache.last_scan_shard_rows
        if shards > 1:
            t_scan += self.cfg.t_shard_merge
        self._stage1_busy_until = now + t_scan
        if self.trace.enabled:
            # stage1_queue_wait = tool-call arrival -> pass opening;
            # stage1_scan = the pass itself (fixed host cost + optional
            # RTT + scan streaming). scan_end is the exact instant the
            # deferred _scan_resolve fires (same float expression).
            scan_end = now + t_scan
            for bst, _, t_arr in batch:
                self.trace.span(bst.rec.rid, "stage1_queue_wait", t_arr,
                                open_t, self.region_id)
                self.trace.span(bst.rec.rid, "stage1_scan", open_t,
                                scan_end, self.region_id)
        if self._stage1_pending:  # next pass opens as the scan retires
            self._stage1_open = now + t_scan
            self._push(self._stage1_open + self._stage1_latency(),
                       self._stage1_flush)
        entries = list(zip(batch, blocks, consults))
        if t_scan > 0:
            self._push(
                now + t_scan,
                lambda now2, e=entries: self._scan_resolve(e, now2, True),
            )
        else:
            self._scan_resolve(entries, now, False)

    def _scan_resolve(self, entries, now: float, revalidate: bool):
        """Resolve a stage-1 pass once its scan time has elapsed.
        ``revalidate`` is set when the pass was deferred (t_scan > 0):
        clock events in the scan window may have evicted/expired/
        promoted candidates, so their views are re-examined first."""
        deferred = []
        for (st, q, t0), (cands, sims), warm in entries:
            if revalidate:
                cands, sims = self._revive(cands, sims, now)
            if warm:
                deferred.append((st, q, t0, cands, sims))
                continue
            self._stage1_resolve(st, q, t0, cands, sims, now)
        if deferred:
            if self.trace.enabled:
                for dst, _, _, _, _ in deferred:
                    self.trace.span(dst.rec.rid, "warm_consult", now,
                                    now + self.cfg.t_cache_warm,
                                    self.region_id)
            self._push(
                now + self.cfg.t_cache_warm,
                lambda now2, d=deferred: self._warm_resolve(d, now2),
            )
        # one dispatch for the whole flush: requests that arrived in the
        # same stage-1 window ride the same judge micro-batch (dispatching
        # inside _judge_request would submit solo batches whenever the
        # judge lane has free slots)
        self._dispatch_judges()

    def _revive(self, cands, sims, now: float):
        """Re-examine candidate views after a deferral window: rebind
        views whose entry promoted meanwhile, drop evicted/expired/
        revalidating ones. Sims stay ALIGNED with the surviving views
        (the admission band classifies on them)."""
        live = []
        keep = []
        for j, c in enumerate(cands):
            if not c.valid and c.se_id in self.cache.store:
                c = self.cache.store[c.se_id]  # promoted meanwhile
            if c.valid and not c.expired(now) and \
                    not getattr(c, "revalidating", False):
                live.append(c)
                keep.append(j)
        return live, np.asarray(sims)[keep].astype(np.float32)

    def _stage1_resolve(self, st: _ReqState, q: str, t0: float, cands,
                        sims, now: float):
        st.rec.cache_time += now - t0
        if not cands:
            # under an armed band a sub-lo best match never surfaced
            # here — the straight-to-origin shortcut IS this path
            self.cache.miss_no_candidates()
            self._go_remote(st)
            return
        if self.mode == "cortex-nojudge":
            # ANN-only ablation: accept nearest candidate blindly —
            # but through the SHARED hit accounting, so prefetch_hits
            # and freq bookkeeping stay comparable with full cortex.
            # Snapshot key/value FIRST: accounting a warm winner
            # promotes it, which retires the warm row behind the view.
            se = cands[0]
            key, value = se.key, se.value
            self._note_stale(se, now)
            self.cache.account_hit(se, now)
            st.rec.cache_hits += 1
            self._after_validated(st, key)
            self._observe(st, value, from_cache=True)
            return
        # adaptive admission (DESIGN.md §14): a best-similarity above the
        # band's trust edge is served without judge latency — through the
        # same shared hit accounting as the nojudge ablation. With no
        # band armed, admit() is a constant "judge" and this is the
        # legacy judge-everything engine, event for event. Under
        # overload (§17) a judge-classified request may be SHED to the
        # same trust path: the band effectively widens toward trust
        # while the latency SLO is breached or the backlog is capped.
        verdict = self.cache.seri.pipeline.admit(
            sims, self.cache.seri.tau_sim
        )
        shed = (verdict == "judge" and self.overload is not None
                and self.overload.shed_judge(
                    now, len(self._judge_backlog),
                    best_sim=float(sims[0]),
                    tau=self.cache.seri.tau_sim))
        if verdict == "bypass" or shed:
            self.trace.marker(st.rec.rid,
                              "shed_nojudge" if shed else "band_bypass",
                              now, self.region_id)
            se = cands[0]
            key, value = se.key, se.value
            self._note_stale(se, now)
            self.cache.account_hit(se, now)
            st.rec.cache_hits += 1
            self._after_validated(st, key)
            self._observe(st, value, from_cache=True)
            return
        self._judge_request(st, q, cands, sims)

    def _warm_resolve(self, deferred, now: float):
        """Warm-consulting requests resume after t_cache_warm; their
        judge jobs dispatch as one micro-batch of their own. Candidates
        are re-examined: clock events between the flush and this wakeup
        may have promoted a warm view (rebind to the live hot row — it
        is still a perfectly good candidate), evicted it, or expired it."""
        for st, q, t0, cands, sims in deferred:
            live, live_sims = self._revive(cands, sims, now)
            self._stage1_resolve(st, q, t0, live, live_sims, now)
        self._dispatch_judges()

    def _judge_request(self, st: _ReqState, q: str, cands, sims):
        # done/timed_out live on the ENTRY, not the request: a request has
        # one judge job per round, and a stale timed-out entry from an
        # earlier round must never be revived by a later round's flags.
        # snapshot keys/values now: candidates may be evicted (and their
        # SoA rows reused) while the judge job waits on the accelerator.
        # sims ride along so eval-log records carry the stage-1 cosine
        # the band recalibration sweeps.
        entry = dict(
            st=st, q=q, cands=cands, t0=self._now,
            keys=[c.key for c in cands], values=[c.value for c in cands],
            sims=[float(s) for s in sims],
            done=False, timed_out=False, t_dispatch=None,
        )
        self._judge_backlog.append(entry)
        self._push(self._now + self.cfg.judge_timeout,
                   self._judge_timeout, entry)
        # no dispatch here — the caller (_stage1_flush) dispatches once
        # for the whole window so co-arrived requests share a micro-batch

    def _judge_timeout(self, entry):
        if entry["done"]:
            return
        entry["timed_out"] = True
        self.cache.stats.misses += 1
        if self.trace.enabled:
            # close the judge spans at the timeout instant: the request
            # proceeds as a miss NOW; the (abandoned) batch result is
            # attributed to nothing when it lands later
            rid = entry["st"].rec.rid
            td = entry["t_dispatch"]
            if td is None:
                self.trace.span(rid, "judge_queue_wait", entry["t0"],
                                self._now, self.region_id, "timeout")
            else:
                self.trace.span(rid, "judge_queue_wait", entry["t0"],
                                td, self.region_id)
                self.trace.span(rid, "judge_compute", td, self._now,
                                self.region_id, "timeout")
        self._go_remote(entry["st"])  # deferred validation = miss (§4.4)

    def _dispatch_judges(self):
        """Drain the backlog in micro-batches: one accelerator job and one
        ``score_pairs`` call per batch of up to judge_batch_max requests,
        with the shared prompt prefill amortized (paper §4.4)."""
        while self._judge_backlog and self.gpu.judge_admission_ok() and \
                self.gpu.judge.n_waiting == 0:
            batch = []
            while self._judge_backlog and \
                    len(batch) < self.cfg.judge_batch_max:
                e = self._judge_backlog.popleft()
                if e["timed_out"]:
                    continue  # already proceeded as a miss
                batch.append(e)
            if not batch:
                return
            for e in batch:
                e["t_dispatch"] = self._now
            # cost of the micro-batch: model-config-derived via the
            # pipeline unless the config pins a legacy hand-set base
            if self.cfg.judge_tokens is None:
                tokens = self.cache.seri.pipeline.batch_tokens(
                    len(batch), self.cfg.judge_batch_marginal
                )
            else:
                tokens = judge_batch_tokens(
                    self.cfg.judge_tokens, len(batch),
                    self.cfg.judge_batch_marginal,
                )
            if self.faults is not None:
                # judge-device slowdown (§17): the micro-batch costs
                # mult× the tokens while the fault window is active
                tokens *= self.faults.judge_mult(self.region_id,
                                                 self._now)
            self._submit(
                self.gpu.judge, tokens,
                lambda now, b=batch: self._judge_batch_done(b, now),
            )

    def _judge_batch_done(self, batch, now):
        live = [e for e in batch if not e["timed_out"]]
        for e in live:
            e["done"] = True
        if not live:
            return
        # one flattened judge call for the whole micro-batch
        flat_q, flat_k = [], []
        for e in live:
            flat_q.extend([e["q"]] * len(e["cands"]))
            flat_k.extend(e["keys"])
        scores = self.cache.seri.pipeline.score_pairs(flat_q, flat_k)
        off = 0
        for e in live:
            m = len(e["cands"])
            sc = scores[off:off + m]
            off += m
            st = e["st"]
            st.rec.cache_time += now - e["t0"]
            if self.trace.enabled:
                self.trace.span(st.rec.rid, "judge_queue_wait", e["t0"],
                                e["t_dispatch"], self.region_id)
                self.trace.span(st.rec.rid, "judge_compute",
                                e["t_dispatch"], now, self.region_id)
            for key, val, s, sim in zip(e["keys"], e["values"], sc,
                                        e["sims"]):
                self.eval_log.append(
                    EvalRecord(e["q"], key, val, float(s), sim=sim)
                )
            res = self.cache.finalize(e["q"], e["cands"], sc, now)
            if res.hit:
                self._note_stale(res.se, now)
                st.rec.cache_hits += 1
                self._after_validated(st, res.se.key)
                self._observe(st, res.se.value, from_cache=True)
            else:
                self._go_remote(st)

    def _note_stale(self, se, now: float) -> None:
        """Freshness accounting for a cache-served value: compare the
        SE's fetch-time knowledge version against the world's CURRENT
        version of its intent. Exactly 0 stale hits on a static world
        (every version is 0), so the static suites double as a
        regression guard on this path."""
        if se is None:
            return
        intent = se.intent
        cur = (
            self.world.intent_version(int(intent), now)
            if intent is not None
            else self.world.version_at(se.key, now)
        )
        if se.version < cur:
            self.stale_hits += 1
            self.stale_age_hist.add(now - se.fetched_at)

    def _go_remote(self, st: _ReqState):
        q = st.req.query_for_round(st.round)
        st.rec.remote_calls += 1
        t0 = self._now
        if self.router is not None:
            # federation: peek sibling regions before the origin WAN fetch
            self.router.route(self, st, q, t0)
            return
        out = self.remote.fetch(
            self._now,
            latency_mult=self.world.latency_mult(q),
            cost_mult=self.world.cost_mult(q),
        )
        if out.failed:
            self.fetch_failed(st, q, t0, out)
            return
        self.trace.span(st.rec.rid, "origin_fetch", t0, out.finish,
                        self.region_id)
        self._push(
            out.finish,
            lambda now: self.remote_done(st, q, t0, now, value=None,
                                         cost=out.cost),
        )

    def fetch_failed(self, st: _ReqState, q: str, t0: float, out,
                     t_start: Optional[float] = None):
        """Answer through a degraded path after a terminal fetch failure
        (origin brownout + retries exhausted, DESIGN.md §17). The request
        must never hang: serve a known-stale but present cache entry if
        the controller allows it, else re-enter ``_go_remote`` at the
        failure horizon (``out.finish`` — the virtual instant the last
        backoff expired) and try again; brownout windows are finite, so
        the retry chain terminates.

        ``t_start`` is where the failed attempt's span opens (the last
        NAK's arrival on the federated path; ``t0`` otherwise)."""
        span_t0 = t0 if t_start is None else t_start
        self.trace.span(st.rec.rid, "origin_fetch", span_t0, out.finish,
                        self.region_id, "failed")
        ov = self.overload
        if (ov is not None and ov.serve_stale_ok()
                and self.cache is not None):
            se = self._stale_candidate(q)
            if se is not None:
                ov.stats.stale_served += 1
                self.trace.marker(st.rec.rid, "stale_serve", out.finish,
                                  self.region_id)
                # snapshot now: the entry can be evicted (its SoA row
                # reused) before the serve instant arrives
                value = se.value
                self._note_stale(se, self._now)

                def serve(now):
                    st.rec.remote_time += now - t0
                    self._observe(st, value, from_cache=True)

                self._push(out.finish, serve)
                return
        if ov is not None:
            ov.stats.failed_retries += 1
        self._push(out.finish, lambda now: self._go_remote(st))

    def _stale_candidate(self, q: str):
        """A present (possibly expired/stale) entry for the query's own
        intent — §17 serve-stale: better a known-stale answer than an
        error while the origin browns out."""
        ses = self.cache.ses_for_intent(self.world.intent_of(q))
        for se in ses:
            if se.valid and not getattr(se, "revalidating", False):
                return se
        return None

    def remote_done(self, st: _ReqState, q: str, t0: float, now: float, *,
                    value=None, cost: float = 0.0,
                    ttl: Optional[float] = None,
                    staticity: Optional[int] = None,
                    origin: Optional[int] = None,
                    size: Optional[int] = None,
                    version: Optional[int] = None,
                    fetched_at: Optional[float] = None,
                    src_intent: Optional[int] = None):
        """Complete one remote resolution (origin fetch or federated peer
        transfer): admit into the local cache and resume the request.

        ``value=None`` means "fetched from the origin" (ground truth from
        the world AS OF ``now``, stamped with the origin's current
        knowledge version); a peer transfer passes the sibling's cached
        value with ITS version/fetch-time, which — like any cache hit —
        may be stale or semantically wrong, and flows into accuracy and
        staleness accounting the same way."""
        st.rec.remote_time += now - t0
        peer = value is not None
        if not peer:
            value = self.world.fetch(q, now)
            version = self.world.version_at(q, now)
            fetched_at = now
        else:
            st.rec.peer_transfers += 1
        if size is None:
            size = self.world.value_size(q)
        if self.mode in ("cortex", "cortex-nojudge") and self.cache is not None:
            q_emb = self.world.embed(q)
            # a cross-intent peer lease (ANN-only peek) must be tracked
            # under the SOURCE entry's intent: the value's staleness and
            # invalidation follow the intent the knowledge belongs to
            se = self.cache.insert(
                q, q_emb, value, now=now, cost=cost,
                latency=now - t0, size=size,
                intent=(src_intent if src_intent is not None
                        else self.world.intent_of(q)),
                ttl=ttl, staticity=staticity, origin=origin,
                version=0 if version is None else version,
                fetched_at=fetched_at,
            )
            if self.freshness is not None:
                self.freshness.on_insert(se)
            if peer:
                # the transferred value is served to THIS request too —
                # staleness exposure counts like a local cache hit
                self._note_stale(se, now)
            self._after_validated(st, q)
        elif self.mode == "exact" and self.exact is not None:
            self.exact.insert(q, value, size, now,
                              staticity=self.world.staticity(q))
        self._observe(st, value, from_cache=False)

    def _after_validated(self, st: _ReqState, key: str):
        """Feed the prefetcher with the validated intent stream."""
        if not self.cfg.prefetch or self.mode != "cortex":
            return
        intent = self.world.intent_of(key)
        # keyed by session so interleaved concurrent requests don't
        # cross-contaminate the learned transition table
        self.prefetcher.observe(intent, key=st.req.session)
        pred = self.prefetcher.predict(intent)
        if pred is None:
            return
        pq = self.world.query(int(pred.state), 0)
        pq_emb = self.world.embed(pq)
        if self.cache.contains_semantic(pq, pq_emb, self._now):
            return
        # pure-read headroom (the same helper the §16 sampler uses), so
        # the on-path gate and the telemetry see one value and the read
        # never mutates limiter state
        headroom = limiter_headroom(self.remote, self._now)
        if headroom < self.cfg.prefetch_min_headroom:
            return
        if self.overload is not None and \
                not self.overload.allow_prefetch(headroom, self._now):
            # §17: prefetch paused under limiter-headroom / SLO pressure
            return
        out = self.remote.fetch(
            self._now,
            latency_mult=self.world.latency_mult(pq),
            cost_mult=self.world.cost_mult(pq),
        )
        if out.failed:
            return  # §17 brownout: drop the speculative fetch, no retry
        t0 = self._now

        def prefetched(now):
            se = self.cache.insert(
                pq, pq_emb, self.world.fetch(pq, now), now=now,
                cost=out.cost,
                latency=now - t0, size=self.world.value_size(pq),
                prefetched=True, intent=int(pred.state),
                version=self.world.version_at(pq, now), fetched_at=now,
            )
            if self.freshness is not None:
                self.freshness.on_insert(se)

        self._push(out.finish, prefetched)

    def _observe(self, st: _ReqState, value, *, from_cache: bool):
        q_round = st.req.query_for_round(st.round)
        correct = self.world.equivalent(
            value, self.world.answer_at(q_round, self._now)
        )
        st.info_values.append(correct)
        st.round += 1
        st.rec.rounds += 1
        if st.round < st.req.n_rounds:
            self._begin_round(st)
        else:
            t0 = self._now

            def answered(now):
                st.rec.agent_time += now - t0
                self.trace.span(st.rec.rid, "agent_answer", t0, now,
                                self.region_id)
                self._complete(st)

            self._submit(self.gpu.agent, self.cfg.answer_tokens, answered)

    def _complete(self, st: _ReqState):
        rec = st.rec
        rec.t_done = self._now
        # closed-loop arrivals are re-stamped at dispatch, so this single
        # expression is correct for both loop disciplines
        rec.latency = self._now - rec.arrival
        rec.info_correct = all(st.info_values)
        p = self.cfg.em_p_base if rec.info_correct else self.cfg.em_p_wrong
        rec.em_correct = bool(self.rng.random() < p)
        self.records.append(rec)
        self._active -= 1
        self._done += 1
        if self._done == self._warm_cut and self._warm_snap is None:
            # warm-up boundary: one registry snapshot (§15) — summary()
            # subtracts it via MetricsRegistry.delta for the
            # steady-state fields
            self._warm_snap = {
                "n_records": len(self.records),
                "t": self._now,
                "metrics": self.metrics.snapshot(),
            }
        if self.cfg.closed_loop is not None:
            self._dispatch_closed_loop()

    # --------------------------------------------------------- recal

    def _recal_tick(self):
        if self.eval_log:
            n = min(self.cfg.recal_samples, len(self.eval_log))

            def fetch_gt(q):
                self.recal_cost += self.remote.cost_per_call
                self.remote.calls += 1
                self.remote.total_cost += self.remote.cost_per_call
                return self.world.fetch(q, self._now)

            res = recalibrate(
                self.eval_log[-512:], fetch_gt, self.world.equivalent,
                p_target=self.cfg.p_target, sample_size=n,
                rng=self.rng,
            )
            # hysteresis: one noisy sample window must not swing the
            # serving threshold — blend toward the new estimate
            a = self.cfg.recal_smooth
            tau = (1.0 - a) * self.cache.seri.tau_lsm + a * res.tau
            self.cache.seri.tau_lsm = tau
            self.recal_history.append((self._now, tau))
            # admission-band recalibration (DESIGN.md §14): the same
            # labeled sample yields the smallest stage-1 similarity
            # whose precision meets the target — the trust edge. The
            # band's width re-centers on 2·(edge − τ_sim) under the
            # same EMA hysteresis as τ_lsm.
            band = self.cache.seri.pipeline.band
            if band is not None and band.adaptive and \
                    res.sim_tau is not None:
                w_target = 2.0 * max(
                    0.0, res.sim_tau - self.cache.seri.tau_sim
                )
                band.width = (1.0 - a) * band.width + a * w_target
        self._push(self._now + self.cfg.recalibrate_every, lambda now=None: self._recal_tick())

    # --------------------------------------------------------- run

    def _dispatch_closed_loop(self):
        n = self.cfg.closed_loop
        while self._pending and self._active < n:
            req = self._pending.popleft()
            req = dataclasses.replace(req, arrival=self._now)
            self._start_request(req)

    def prepare(self) -> None:
        """Schedule arrivals (and the recal timer) without running the
        loop — the federation runner prepares every region's engine, then
        drives their SHARED clock itself."""
        if self.cfg.closed_loop is not None:
            self._dispatch_closed_loop()
        else:
            for req in self._pending:
                self._push(req.arrival, lambda now=None, r=req: self._start_request(r))
            self._pending.clear()
        if self.cfg.recalibrate_every and self.mode == "cortex":
            self._push(self.cfg.recalibrate_every, lambda now=None: self._recal_tick())

    def run(self) -> dict:
        self.prepare()
        while self.clock.pending and not self.done:
            self.clock.step()
        return self.summary()

    # --------------------------------------------------------- metrics

    def summary(self) -> dict:
        snap = self._warm_snap
        recs = self.records[snap["n_records"]:] if snap else self.records
        if not recs:
            return {}
        # one registry snapshot is THE source for every counter-derived
        # field below (DESIGN.md §15) — the legacy keys are projections
        # of "namespace.key" entries, byte-identical by construction
        # because the collectors read the same counters the old code
        # read directly. Steady-state fields subtract the warm-up
        # snapshot through the registry's delta.
        m = self.metrics.snapshot()
        d = MetricsRegistry.delta(m, snap["metrics"] if snap else {})
        t_end = max(r.t_done for r in recs)
        t_start = snap["t"] if snap else min(r.arrival for r in recs)
        makespan = max(t_end - t_start, 1e-9)
        lat = np.array([r.latency for r in recs])
        gpu_hours = makespan / 3600 * m["gpu.n_chips"]
        out = {
            "mode": self.mode,
            "n": len(recs),
            "throughput_rps": len(recs) / makespan,
            "latency_mean": float(lat.mean()),
            "latency_p50": percentile(lat, 50),
            "latency_p99": percentile(lat, 99),
            "agent_time_mean": float(np.mean([r.agent_time for r in recs])),
            "cache_time_mean": float(np.mean([r.cache_time for r in recs])),
            "remote_time_mean": float(np.mean([r.remote_time for r in recs])),
            "remote_calls_per_req": float(
                np.mean([r.remote_calls for r in recs])
            ),
            "peer_transfers": int(sum(r.peer_transfers for r in recs)),
            "api_calls": d["remote.calls"],
            "api_attempts": d["remote.attempts"],
            "retry_ratio": (d["remote.retries"] / d["remote.attempts"]
                            if d["remote.attempts"] else 0.0),
            "api_cost": d["remote.total_cost"],
            "gpu_cost": gpu_hours * self.cfg.gpu_cost_per_hour,
            "em": float(np.mean([r.em_correct for r in recs])),
            "info_accuracy": float(np.mean([r.info_correct for r in recs])),
            "makespan": makespan,
        }
        # hit-path breakdown (all rounds served from cache): the paper's
        # Fig 11 steady-state per-request latency decomposition
        hit_recs = [r for r in recs if r.remote_calls == 0]
        if hit_recs:
            out["hitpath_latency"] = float(
                np.mean([r.latency for r in hit_recs])
            )
            out["hitpath_agent"] = float(
                np.mean([r.agent_time for r in hit_recs])
            )
            out["hitpath_cache"] = float(
                np.mean([r.cache_time for r in hit_recs])
            )
        if self.mode in ("cortex", "cortex-nojudge") and self.cache is not None:
            if snap:
                lk = d["cache.lookups"]
                out["hit_rate_steady"] = (
                    d["cache.hits"] / lk if lk else 0.0
                )
            out.update(
                hit_rate=(m["cache.hits"] / m["cache.lookups"]
                          if m["cache.lookups"] else 0.0),
                evictions=m["cache.evictions"],
                ttl_evictions=m["cache.ttl_evictions"],
                invalidations=m["cache.invalidations"],
                prefetch_inserts=m["cache.prefetch_inserts"],
                prefetch_hits=m["cache.prefetch_hits"],
                judge_calls=m["cache.judge_calls"],
                cache_items=m["cache.items"],
                # stage-1 scan volume (DESIGN.md §12): total rows the
                # stage-1 passes touched and the per-lookup average —
                # the sublinearity of the clustered index read straight
                # off the summary
                rows_scanned=m["scan.total_rows"],
                rows_per_lookup=(
                    m["scan.total_rows"] / m["cache.lookups"]
                    if m["cache.lookups"] else 0.0
                ),
                # judge economics (DESIGN.md §14): the per-job token
                # cost actually charged (model-config-derived unless the
                # config pinned a legacy constant) and the judge lane's
                # processed token-equivalents — changing the judge's
                # d_model moves BOTH, which is the "no constant left on
                # the path" property the colocation sweep gates on.
                judge_tokens_base=float(
                    self.cfg.judge_tokens
                    if self.cfg.judge_tokens is not None
                    else m["pipeline.base_tokens"]
                ),
                judge_lane_tokens=m["gpu.judge_lane_tokens"],
            )
            if m["pipeline.band_width"] > 0:
                # admission band (§14). Keyed OFF at width 0 so the
                # width-0 engine's summary stays byte-identical to the
                # band-free engine (the sweep's bit-identity gate).
                out.update(
                    band_width=m["pipeline.band_width"],
                    band_bypass_hits=m["pipeline.bypass_hits"],
                    band_judged=m["pipeline.band_judged"],
                    lease_validations=m["pipeline.lease_validations"],
                    lease_rejections=m["pipeline.lease_rejections"],
                )
            if "shard.shards" in m:
                # mesh-sharded stage 1 (§13). The shard collector
                # returns {} when unsharded, so pre-§13 summaries (and
                # the bit-identity gates that compare them) are
                # byte-identical.
                out.update(
                    stage1_shards=m["shard.shards"],
                    rows_scanned_max_shard=m["scan.total_max_shard_rows"],
                    shard_rebalances=m["shard.rebalances"],
                    shard_migrated_rows=m["shard.migrated_rows"],
                    shard_migration_chunks=m["shard.migration_chunks"],
                )
            # freshness accounting (DESIGN.md §11): every cache-served
            # value is version-checked, so these are exact, not sampled.
            # stale_hit_rate is per SERVED value (local hits + federated
            # peer transfers — a transferred value reaches the requester
            # just like a hit), the histogram buckets the age of the
            # stale values at serve time (now - fetched_at, seconds).
            # Denominator from THIS engine's records, not cache.stats —
            # the federation "global" topology shares one cache across
            # engines, and stale_hits is per engine.
            served = sum(
                r.cache_hits + r.peer_transfers for r in self.records
            )
            out["stale_hits"] = m["engine.stale_hits"]
            out["stale_hit_rate"] = (
                m["engine.stale_hits"] / served if served else 0.0
            )
            out["stale_age_hist"] = m["engine.stale_age_hist"]
            out["stale_age_mean"] = m["engine.stale_age_mean"]
            if self.freshness is not None:
                out.update(
                    refreshes=m["freshness.refreshes"],
                    refresh_cost=m["freshness.refresh_cost"],
                    refresh_skipped=m["freshness.refresh_skipped"],
                    feed_notices=m["freshness.notices"],
                    stale_found=m["freshness.stale_found"],
                )
            if "tier.demotions" in m:  # tiered storage (DESIGN.md §10)
                out.update(
                    demotions=m["tier.demotions"],
                    promotions=m["tier.promotions"],
                    warm_lookups=m["tier.warm_lookups"],
                    warm_hits=m["tier.warm_hits"],
                    warm_evictions=m["tier.warm_evictions"],
                    warm_items=m["tier.warm_items"],
                    warm_bytes=m["tier.warm_bytes"],
                )
        elif self.mode == "exact" and self.exact is not None:
            out.update(hit_rate=(m["exact.hits"] / m["exact.lookups"]
                                 if m["exact.lookups"] else 0.0))
        else:
            out.update(hit_rate=0.0)
        if self.faults is not None:
            # fault injection armed (§17): brownout outcome accounting.
            # Keyed off when fault-free so pre-§17 summaries stay
            # byte-identical (the neutrality gate).
            out["fetch_failed"] = d["remote.failed"]
            out["throttled_wait"] = d["remote.throttled_wait"]
        if self.overload is not None:
            # §17 actuation counters (same conditional-key contract)
            out["overload"] = {k: m[f"overload.{k}"]
                               for k in self.overload.metrics()}
        out["cost_total"] = out["api_cost"] + out["gpu_cost"]
        out["thpt_per_dollar"] = out["throughput_rps"] / max(
            out["cost_total"], 1e-9
        )
        return out
