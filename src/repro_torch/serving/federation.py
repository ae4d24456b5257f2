"""Cross-region cache federation (DESIGN.md §9).

Cortex is a *cross-region* architecture: the agent cluster and the data
source sit in different regions, and the cache's whole purpose is to keep
knowledge near the requester. This module adds the missing topology
dimension — several agent regions, each with its own local
:class:`~repro_torch.core.cache.CortexCache` and origin
:class:`~repro_torch.serving.remote.RemoteDataService` (region-specific WAN
latency / cost / QPM), joined by a :class:`Federation` router.

On a local cache miss the router broadcasts a *semantic peek* to every
sibling region: a probe flies one half-RTT, runs a stage-1
(``peek_semantic``) search against the sibling's cache at the virtual
instant it arrives, and the response carries a lease (value, absolute
expiry, staticity) back. The nearest positive response wins — responses
arrive in RTT order on the shared clock, so "first positive response"
IS "nearest holder" — and a transfer admits the value into the local
cache with

  * **provenance** — ``se.origin`` records the source region;
  * **adjusted TTL** — the copy expires at the SOURCE entry's absolute
    expiry, so federation never extends a value's lifetime;
  * **transfer economics** — admission cost is the (cheap) inter-region
    transfer cost, not the origin call price, so LCFU correctly treats
    federated copies as cheap to re-obtain.

Only when every sibling NAKs (or the lease would expire in flight) does
the request fall back to its region's origin WAN fetch, paying its own
rate limiter. Three topologies are benchmarked (``--only federation``):
per-region caches without peering ("local"), the full federation
("peered"), and one shared global cache homed in region 0 that remote
regions reach at inter-region RTT ("global").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.core.cache import CortexCache, make_cache
from repro_torch.core.judge import OracleJudge
from repro_torch.data.workloads import Request
from repro_torch.data.world import SemanticWorld
from repro_torch.obs.metrics import percentile
from repro_torch.obs.trace import BACKGROUND
from repro_torch.serving.clock import VirtualClock
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.gpu import GPU, GPUConfig
from repro_torch.serving.remote import RemoteDataService


@dataclasses.dataclass
class RegionConfig:
    """One agent region: its WAN link to the origin data service and the
    sizing of its local cache slice."""

    name: str = "region"
    wan_lat_lo: float = 0.3     # origin WAN latency band (paper §2.2)
    wan_lat_hi: float = 0.5
    wan_cost: float = 0.005     # $ per origin call
    qpm: Optional[float] = 100.0  # origin rate limit (per-region bucket)
    cache_ratio: float = 0.4    # capacity as fraction of world footprint


@dataclasses.dataclass
class Region:
    """Region bundle the router sees: local cache + origin service."""

    rid: int
    cfg: RegionConfig
    cache: CortexCache
    remote: RemoteDataService
    gpu: GPU
    engine: Optional[Engine] = None
    freshness: Optional[object] = None  # FreshnessManager (DESIGN.md §11)


@dataclasses.dataclass
class FederationStats:
    peeks: int = 0            # miss broadcasts sent
    probes: int = 0           # per-peer probe messages
    peer_hits: int = 0        # broadcasts resolved by a sibling transfer
    peer_misses: int = 0      # broadcasts that fell back to origin
    transfers: int = 0
    transfer_bytes: int = 0
    transfer_cost: float = 0.0
    expired_leases: int = 0   # positive peeks whose lease died in flight
    origin_fetches: int = 0
    warm_leases: int = 0      # positive peeks served from a WARM tier
    # robustness (DESIGN.md §17)
    peek_timeouts: int = 0    # probes resolved by the deadline, not a response
    breaker_skips: int = 0    # probes suppressed by an open circuit
    breaker_opens: int = 0    # circuit transitions closed/half-open -> open
    breaker_closes: int = 0   # circuit transitions half-open -> closed


@dataclasses.dataclass
class _Lease:
    """Snapshot a positive peek response carries home (the source pins
    the entry for the transfer, so eviction races are not modelled).
    ``version``/``fetched_at`` ride along so staleness accounting (and
    the provenance-based invalidation rule, DESIGN.md §11) follows the
    copy: a transferred value is exactly as fresh as its source."""

    value: Any
    expires_at: float
    staticity: int
    size: int
    version: int = 0
    fetched_at: float = 0.0
    # the SOURCE entry's intent: an ANN-only peek can lease across
    # intents (confusable pairs), and the copy's version/invalidation
    # must track the intent the VALUE belongs to, not the local query's
    intent: Optional[int] = None


class Federation:
    """Router over a set of regions sharing one virtual clock.

    ``rtt`` is a scalar (uniform mesh) or an (n, n) matrix of inter-region
    round-trip times. Transfers take one response half-RTT plus
    ``size / bandwidth`` serialization, and cost ``transfer_cost`` —
    an order of magnitude under the origin call price (egress, not API).
    """

    def __init__(
        self,
        regions: list[Region],
        clock: VirtualClock,
        *,
        rtt: float | np.ndarray = 0.08,
        transfer_cost: float = 5e-4,
        bandwidth: float = 50e6,   # bytes/s on inter-region links
        peering: bool = True,
        peek_timeout: Optional[float] = None,  # NAK a silent peer after
                                               # this deadline (§17)
        faults=None,               # FaultSchedule (DESIGN.md §17)
        breaker_k: int = 3,        # consecutive timeouts that open a circuit
        breaker_cooldown: float = 5.0,  # open -> half-open probe interval
    ):
        self.regions = regions
        self.clock = clock
        n = len(regions)
        r = np.asarray(rtt, dtype=np.float64)
        if r.ndim == 0:
            r = np.full((n, n), float(r))
            np.fill_diagonal(r, 0.0)
        if r.shape != (n, n):
            raise ValueError(f"rtt matrix must be ({n}, {n})")
        self.rtt_matrix = r
        self.transfer_cost = transfer_cost
        self.bandwidth = bandwidth
        self.peering = peering
        self.peek_timeout = peek_timeout
        self.faults = faults
        self.breaker_k = breaker_k
        self.breaker_cooldown = breaker_cooldown
        self.stats = FederationStats()
        # live queue depth (§16 gauges): broadcasts currently undecided,
        # per requesting region — incremented at route(), decremented
        # exactly once per broadcast (first positive claim OR last NAK,
        # where a peek timeout counts as that peer's NAK — §17)
        self._inflight_peeks = [0] * n
        # per-directed-link circuit breakers, lazily created, keyed
        # (src_rid, dst_rid): each region learns its own view of which
        # peers are dark from its own peek timeouts (DESIGN.md §17)
        self._breaker: dict = {}

    def rtt(self, a: int, b: int) -> float:
        return float(self.rtt_matrix[a, b])

    def gauges(self) -> dict:
        """Pressure gauges for the telemetry sampler (DESIGN.md §16):
        total and per-region in-flight peek broadcasts. Pure reads."""
        out = {"inflight_peeks": sum(self._inflight_peeks)}
        for rid, n in enumerate(self._inflight_peeks):
            out[f"inflight_peeks_r{rid}"] = n
        return out

    # ------------------------------------------------------------ routing

    def route(self, engine: Engine, st, q: str, t0: float) -> None:
        """Resolve a local miss: broadcast peek -> nearest-holder transfer
        -> origin fallback. Every hop is a clock event, so sibling caches
        are observed at the exact virtual instant the probe arrives."""
        region = self.regions[engine.region_id]
        peers = [p for p in self.regions if p.rid != region.rid]
        if not self.peering or not peers:
            self._origin(engine, st, q, t0)
            return
        if self.peek_timeout is not None:
            # circuit breakers (§17) only operate when timeouts can trip
            # them; without a deadline this filter is the identity
            peers = [p for p in peers
                     if self._breaker_admits(engine, region.rid, p.rid)]
            if not peers:
                # every peer's circuit is open: skip the peek entirely
                self._origin(engine, st, q, t0)
                return
        self.stats.peeks += 1
        self._inflight_peeks[region.rid] += 1
        q_emb = engine.world.embed(q)
        # one shared decision cell per broadcast: first positive response
        # claims it; the last NAK triggers the origin fallback. "resolved"
        # holds peers that already answered OR timed out, so a late
        # response after its timeout NAK cannot double-resolve (§17)
        state = {"decided": False, "pending": len(peers),
                 "src": region.rid, "resolved": set()}
        for peer in peers:
            rtt = self.rtt(region.rid, peer.rid)
            if self.faults is not None:
                rtt *= self.faults.link_mult(region.rid, peer.rid, t0)
            self.stats.probes += 1
            self.clock.push(
                t0 + rtt / 2.0, self._probe,
                engine, st, q, q_emb, t0, peer, rtt, state,
            )
            if self.peek_timeout is not None:
                self.clock.push(
                    t0 + self.peek_timeout, self._peek_timeout,
                    engine, st, q, t0, peer, state,
                )

    # ------------------------------------------------- circuit breaker

    def _br(self, src: int, dst: int) -> dict:
        key = (src, dst)
        br = self._breaker.get(key)
        if br is None:
            br = {"state": "closed", "consec": 0, "opened_at": 0.0}
            self._breaker[key] = br
        return br

    def _breaker_admits(self, engine, src: int, dst: int) -> bool:
        """May src probe dst right now? Open circuits are skipped until
        the cooldown elapses; then ONE half-open probe rides the next
        broadcast and its outcome closes or re-opens the circuit."""
        br = self._breaker.get((src, dst))
        if br is None or br["state"] == "closed":
            return True
        if br["state"] == "open":
            if self.clock.now - br["opened_at"] >= self.breaker_cooldown:
                br["state"] = "half_open"
                engine.trace.marker(BACKGROUND, "circuit_half_open",
                                    self.clock.now, src, f"r{src}->r{dst}")
                return True
            self.stats.breaker_skips += 1
            return False
        # half_open: one probe is already in flight — don't pile on
        self.stats.breaker_skips += 1
        return False

    def _peek_timeout(self, engine, st, q, t0, peer, state) -> None:
        """The deadline fired before ``peer`` answered: treat it as that
        peer's NAK, exactly once (a response that already arrived makes
        this a no-op; a response arriving later finds itself resolved)."""
        if state["decided"] or peer.rid in state["resolved"]:
            return
        state["resolved"].add(peer.rid)
        self.stats.peek_timeouts += 1
        br = self._br(state["src"], peer.rid)
        br["consec"] += 1
        if (br["state"] == "half_open"
                or (br["state"] == "closed"
                    and br["consec"] >= self.breaker_k)):
            br["state"] = "open"
            br["opened_at"] = self.clock.now
            self.stats.breaker_opens += 1
            engine.trace.marker(
                BACKGROUND, "circuit_open", self.clock.now,
                state["src"], f"r{state['src']}->r{peer.rid}",
            )
        state["pending"] -= 1
        if state["pending"] == 0:
            # the broadcast ends on the last timeout, same contract as
            # the last NAK: decrement in-flight exactly once, fall back
            self._inflight_peeks[state["src"]] -= 1
            if engine.trace.enabled:
                engine.trace.span(st.rec.rid, "peek_rtt", t0,
                                  self.clock.now, engine.region_id,
                                  "timeout")
            self.stats.peer_misses += 1
            self._origin(engine, st, q, t0)

    def _probe(self, engine, st, q, q_emb, t0, peer, rtt, state) -> None:
        """Probe arrives at the sibling: stage-1 peek against its cache
        as of NOW, validated through the peer's judge pipeline
        (``peek_lease``, DESIGN.md §14): with no admission band armed
        the peek stays ANN-only — the legacy protocol exactly — while an
        armed band judges in-band candidates at the holder before they
        ship (peer-side judge time folds into the probe's half-RTT)."""
        if (self.faults is not None
                and self.faults.region_down(peer.rid, self.clock.now)):
            # the peer is dark (§17): the probe lands on a region that
            # answers nothing — no response event is ever pushed, and
            # only an armed peek_timeout resolves this probe
            return
        lease = None
        if not state["decided"]:  # decided = probe logically cancelled
            # a tiered peer consults BOTH tiers: warm entries are
            # leasable too (the lease carries the decompressed value and
            # the ORIGINAL size — the transfer ships a full value)
            se = peer.cache.peek_lease(q, q_emb, self.clock.now)
            if se is not None:
                if getattr(se, "tier", "hot") == "warm":
                    self.stats.warm_leases += 1
                lease = _Lease(
                    value=se.value,
                    expires_at=float(se.expires_at),
                    staticity=int(se.staticity),
                    size=int(se.size),
                    version=int(se.version),
                    fetched_at=float(se.fetched_at),
                    intent=se.intent,
                )
        self.clock.push(
            t0 + rtt, self._response,
            engine, st, q, t0, peer, rtt, lease, state,
        )

    def _response(self, engine, st, q, t0, peer, rtt, lease, state) -> None:
        if state["decided"] or peer.rid in state["resolved"]:
            # broadcast already claimed, or this peer's timeout already
            # NAKed it — a late response must not double-resolve (§17)
            return
        state["resolved"].add(peer.rid)
        br = self._breaker.get((state["src"], peer.rid))
        if br is not None:
            if br["state"] == "half_open":
                br["state"] = "closed"
                self.stats.breaker_closes += 1
                engine.trace.marker(
                    BACKGROUND, "circuit_close", self.clock.now,
                    state["src"], f"r{state['src']}->r{peer.rid}",
                )
            br["consec"] = 0
        now = self.clock.now
        state["pending"] -= 1
        if lease is not None:
            t_arrive = now + rtt / 2.0 + lease.size / self.bandwidth
            if lease.expires_at > t_arrive:
                state["decided"] = True
                self._inflight_peeks[state["src"]] -= 1
                # §15 spans: broadcast -> winning response, then the
                # response half-RTT + serialization until the value
                # lands (t_arrive is the exact remote_done instant)
                if engine.trace.enabled:
                    engine.trace.span(st.rec.rid, "peek_rtt", t0, now,
                                      engine.region_id)
                    engine.trace.span(st.rec.rid, "lease_transfer", now,
                                      t_arrive, engine.region_id)
                self.stats.peer_hits += 1
                self.stats.transfers += 1
                self.stats.transfer_bytes += lease.size
                self.stats.transfer_cost += self.transfer_cost
                ttl = lease.expires_at - t_arrive
                self.clock.push(
                    t_arrive,
                    lambda now2: engine.remote_done(
                        st, q, t0, now2,
                        value=lease.value, cost=self.transfer_cost,
                        ttl=ttl, staticity=lease.staticity,
                        origin=peer.rid,
                        # admit the bytes actually moved: an ANN match
                        # across intents can have a different payload
                        # size than the local query's own value
                        size=lease.size,
                        version=lease.version,
                        fetched_at=lease.fetched_at,
                        src_intent=lease.intent,
                    ),
                )
                return
            self.stats.expired_leases += 1
        if state["pending"] == 0:
            # every sibling NAKed (or leased too close to expiry): the
            # peek ends with the LAST response; origin fetch starts here
            self._inflight_peeks[state["src"]] -= 1
            if engine.trace.enabled:
                engine.trace.span(st.rec.rid, "peek_rtt", t0, now,
                                  engine.region_id, "miss")
            self.stats.peer_misses += 1
            self._origin(engine, st, q, t0)

    def _origin(self, engine, st, q, t0) -> None:
        """Fall back to the region's own origin WAN fetch (its own rate
        limiter, its own latency band)."""
        self.stats.origin_fetches += 1
        out = engine.remote.fetch(
            self.clock.now,
            latency_mult=engine.world.latency_mult(q),
            cost_mult=engine.world.cost_mult(q),
        )
        if out.failed:
            # origin brownout exhausted the retry budget (§17): hand the
            # request to the engine's degraded-answer path
            engine.fetch_failed(st, q, t0, out, t_start=self.clock.now)
            return
        # starts at NOW (== t0 on the no-peering path, the last NAK's
        # arrival after a failed peek), ends when the fetch lands
        if engine.trace.enabled:
            engine.trace.span(st.rec.rid, "origin_fetch", self.clock.now,
                              out.finish, engine.region_id)
        self.clock.push(
            out.finish,
            lambda now2: engine.remote_done(st, q, t0, now2, value=None,
                                            cost=out.cost),
        )


class FederationRunner:
    """Build + run one multi-region experiment on a shared virtual clock.

    ``topology``:
      * ``"local"``  — per-region caches, no peering (each region alone);
      * ``"peered"`` — per-region caches + the Federation router;
      * ``"global"`` — ONE shared cache homed in region 0, remote regions
        pay ``rtt(r, 0)`` on every stage-1 access. Total cache bytes
        match the other topologies (n × per-region slice), so the sweep
        isolates *placement*, not capacity.

    Every stochastic component is seeded per region, so two runs with the
    same arguments produce identical summaries — and because all regions
    share one clock (seq-tie-broken heap), the interleaving itself is
    deterministic regardless of region count.

    ``backend``/``device`` pick every region's stage 1: by default the
    CUDA kernels over index mirrors on ``device`` (one per region and
    tier; the global topology's one cache has one), ``"numpy"`` the host
    path. The summary is the same either way.
    """

    def __init__(
        self,
        *,
        world: SemanticWorld,
        region_requests: list[list[Request]],
        topology: str = "peered",
        region_cfgs: Optional[list[RegionConfig]] = None,
        rtt: float | np.ndarray = 0.08,
        transfer_cost: float = 5e-4,
        bandwidth: float = 50e6,
        judge_acc: float = 0.98,
        judge_band: Optional[float] = None,  # admission-band width; also
                                             # arms judge-validated
                                             # peer leases (§14)
        engine_cfg: Optional[EngineConfig] = None,
        gpu_cfg: Optional[GPUConfig] = None,
        warm_frac: Optional[float] = None,
        cluster=None,  # ClusterConfig -> IVF stage-1 routing (§12)
        freshness=None,  # FreshnessConfig -> per-region managers (§11)
        tracer=None,  # one obs.Tracer shared by every region (§15)
        sample_interval: Optional[float] = None,  # §16 telemetry: sample
                                                  # the fleet every this
                                                  # many virtual seconds
        slos=None,  # SLO objects / spec strings for the §16 monitor
                    # (requires sample_interval)
        faults=None,  # FaultSchedule or spec strings (DESIGN.md §17)
        peek_timeout: Optional[float] = None,  # §17 peek deadline
        breaker_k: int = 3,
        breaker_cooldown: float = 5.0,
        overload: Optional[str] = None,  # None | "on" | "off" — arm a §17
                                         # OverloadController per region
        overload_cfg=None,  # OverloadConfig template (overrides on/off)
        backend: str = "kernel",  # every region's stage 1: the CUDA
                                  # kernels, or "numpy" (the host path)
        device="cuda",  # the device every region's index mirror lives on
        seed: int = 0,
    ):
        if topology not in ("local", "peered", "global"):
            raise ValueError(topology)
        n = len(region_requests)
        if region_cfgs is None:
            region_cfgs = [RegionConfig(name=f"r{i}") for i in range(n)]
        if len(region_cfgs) != n:
            raise ValueError("one RegionConfig per request stream")
        self.world = world
        self.topology = topology
        self.clock = VirtualClock()
        footprint = int(world._sizes.sum())
        base_cfg = engine_cfg or EngineConfig()
        if faults is not None and not hasattr(faults, "region_down"):
            from repro_torch.serving.faults import FaultSchedule

            faults = FaultSchedule.parse(faults)
        self.faults = faults

        # §16 monitor first (engines' §17 controllers read its breach
        # state); the sampler that FEEDS it is created after the engines
        self.monitor = None
        self.sampler = None
        if slos and sample_interval is None:
            raise ValueError("slos require sample_interval")
        if sample_interval is not None and slos:
            from repro_torch.obs.slo import SLOMonitor

            self.monitor = SLOMonitor(slos, tracer=tracer)

        # per-region router seeds: each region's cache clusters its OWN
        # rows (peek_semantic then routes peer probes through the same
        # sublinear scan, so federation peeks stay cheap at scale)
        self._next_region = 0

        def region_cluster():
            if cluster is None:
                return None
            ccfg = dataclasses.replace(
                cluster, seed=cluster.seed + 10 * self._next_region
            )
            self._next_region += 1
            return ccfg

        def wrap_judge(judge):
            # one JudgePipeline per cache (DESIGN.md §14): an armed band
            # gives every region adaptive admission locally AND
            # judge-validated in-band leases on the peek path
            if judge_band is None:
                return judge
            from repro_torch.core.judge_pipeline import (AdmissionBand,
                                                   JudgePipeline)

            return JudgePipeline(judge,
                                 band=AdmissionBand(width=judge_band))

        def build_cache(capacity: int, judge) -> CortexCache:
            # warm_frac splits each region's byte budget into a tiered
            # hot+warm pair at EQUAL total bytes (DESIGN.md §10) — peers
            # can then lease each other's warm entries via peek_semantic
            if warm_frac:
                from repro_torch.core.tiers import make_tiered_cache

                warm_bytes = int(capacity * warm_frac)
                return make_tiered_cache(
                    hot_bytes=capacity - warm_bytes, warm_bytes=warm_bytes,
                    dim=world.dim, judge=judge, cluster=region_cluster(),
                    backend=backend, device=device,
                )
            return make_cache(
                capacity_bytes=capacity, dim=world.dim, judge=judge,
                cluster=region_cluster(), backend=backend, device=device,
            )

        # one origin change feed shared by every region; each region
        # subscribes with ITS one-way WAN delay (half the mean fetch
        # RTT), so the eventual-consistency window is per-region —
        # exactly the asymmetry the provenance rule exists for
        self.feed = None
        if freshness is not None:
            from repro_torch.core.freshness import ChangeFeed

            self.feed = ChangeFeed(world, self.clock)

        self.regions: list[Region] = []
        shared_cache = None
        shared_mgr = None
        if topology == "global":
            judge = wrap_judge(
                OracleJudge(world, accuracy=judge_acc, seed=seed + 7)
            )
            shared_cache = build_cache(
                sum(int(rc.cache_ratio * footprint) for rc in region_cfgs),
                judge,
            )
        for rid, rc in enumerate(region_cfgs):
            if shared_cache is not None:
                cache = shared_cache
            else:
                judge = wrap_judge(OracleJudge(
                    world, accuracy=judge_acc, seed=seed + 101 * (rid + 1)
                ))
                cache = build_cache(
                    int(rc.cache_ratio * footprint), judge,
                )
            remote = RemoteDataService(
                lat_lo=rc.wan_lat_lo, lat_hi=rc.wan_lat_hi,
                cost_per_call=rc.wan_cost, qpm=rc.qpm,
                seed=seed + 13 * (rid + 1),
                faults=faults, region=rid,
            )
            gpu = GPU(gpu_cfg or GPUConfig())
            mgr = None
            if freshness is not None:
                if shared_cache is not None and shared_mgr is not None:
                    mgr = shared_mgr  # one manager for the one cache
                else:
                    from repro_torch.core.freshness import FreshnessManager

                    mgr = FreshnessManager(
                        cache=cache, remote=remote, world=world,
                        clock=self.clock,
                        cfg=dataclasses.replace(
                            freshness,
                            feed_delay=0.25 * (rc.wan_lat_lo + rc.wan_lat_hi),
                        ),
                        feed=self.feed,
                    )
                    if shared_cache is not None:
                        shared_mgr = mgr
            self.regions.append(
                Region(rid, rc, cache, remote, gpu, freshness=mgr)
            )

        self.federation = Federation(
            self.regions, self.clock, rtt=rtt,
            transfer_cost=transfer_cost, bandwidth=bandwidth,
            peering=(topology == "peered"),
            peek_timeout=peek_timeout, faults=faults,
            breaker_k=breaker_k, breaker_cooldown=breaker_cooldown,
        )
        self.overload = overload
        for region, reqs in zip(self.regions, region_requests):
            cfg = dataclasses.replace(
                base_cfg,
                seed=seed + 29 * (region.rid + 1),
                cache_access_latency=(
                    self.federation.rtt(region.rid, 0)
                    if topology == "global" else 0.0
                ),
            )
            ctrl = None
            if overload is not None:
                from repro_torch.serving.overload import (OverloadConfig,
                                                    OverloadController)

                cfg_o = (dataclasses.replace(overload_cfg)
                         if overload_cfg is not None
                         else OverloadConfig())
                cfg_o.enabled = (overload == "on")
                ctrl = OverloadController(
                    cfg_o, monitor=self.monitor, tracer=tracer,
                    region=region.rid,
                )
                if region.freshness is not None:
                    region.freshness.overload = ctrl
            region.engine = Engine(
                world=world,
                requests=reqs,
                mode="cortex",
                cache=region.cache,
                remote=region.remote,
                gpu=region.gpu,
                cfg=cfg,
                clock=self.clock,
                router=(self.federation if topology == "peered" else None),
                region_id=region.rid,
                freshness=region.freshness,
                tracer=tracer,
                overload=ctrl,
                faults=faults,
            )

        # §16 continuous telemetry: ONE sampler over the whole fleet
        # (shared clock), with the federation's queue-depth gauges and
        # an optional SLO monitor (created above, before the engines,
        # so §17 controllers can hold it) riding the sample stream.
        # Strictly observational — summaries stay byte-identical (gated).
        if sample_interval is not None:
            from repro_torch.obs.sampler import TimeSeriesSampler

            self.sampler = TimeSeriesSampler(
                self.clock, sample_interval, self.engines,
                federation=self.federation, monitor=self.monitor,
            )

    @property
    def engines(self) -> list[Engine]:
        return [r.engine for r in self.regions]

    def records_by_region(self) -> dict[int, list]:
        """Completed records keyed by region id — the shape
        ``obs.analyze`` wants, since per-region workloads reuse rid
        ranges (the unique request key is ``(region, rid)``)."""
        return {r.rid: r.engine.records for r in self.regions}

    def run(self) -> dict:
        for e in self.engines:
            e.prepare()
        if self.sampler is not None:
            self.sampler.start()
        while self.clock.pending and not all(e.done for e in self.engines):
            self.clock.step()
        if self.sampler is not None:
            self.sampler.finalize()
        return self.summary()

    # ----------------------------------------------------------- metrics

    def _caches(self) -> list[CortexCache]:
        """Distinct cache objects (the global topology shares one)."""
        return list({id(r.cache): r.cache for r in self.regions}.values())

    def _managers(self) -> list:
        """Distinct freshness managers (global topology shares one)."""
        return list({
            id(r.freshness): r.freshness for r in self.regions
            if r.freshness is not None
        }.values())

    def summary(self) -> dict:
        per_region = {
            r.cfg.name: r.engine.summary() for r in self.regions
        }
        recs = [rec for e in self.engines for rec in e.records]
        lat = np.array([r.latency for r in recs])
        fs = self.federation.stats
        agg = {
            "topology": self.topology,
            "n": len(recs),
            "latency_mean": float(lat.mean()),
            "latency_p50": percentile(lat, 50),
            "latency_p99": percentile(lat, 99),
            "remote_time_mean": float(
                np.mean([r.remote_time for r in recs])
            ),
            "cache_time_mean": float(
                np.mean([r.cache_time for r in recs])
            ),
            "cache_hits": int(sum(r.cache_hits for r in recs)),
            "hit_rate": _ratio(
                sum(c.stats.hits for c in self._caches()),
                sum(c.stats.lookups for c in self._caches()),
            ),
            "peer_transfers": int(sum(r.peer_transfers for r in recs)),
            "api_calls": sum(r.remote.calls for r in self.regions),
            "api_cost": float(
                sum(r.remote.total_cost for r in self.regions)
                + fs.transfer_cost
            ),
            "retry_ratio": _ratio(
                sum(r.remote.retries for r in self.regions),
                sum(r.remote.attempts for r in self.regions),
            ),
            "info_accuracy": float(
                np.mean([r.info_correct for r in recs])
            ),
            "peeks": fs.peeks,
            "peer_hit_rate": _ratio(fs.peer_hits, fs.peeks),
            "transfer_bytes": fs.transfer_bytes,
            "expired_leases": fs.expired_leases,
            "warm_leases": fs.warm_leases,
            # freshness (DESIGN.md §11): fleet-wide staleness exposure
            "stale_hits": int(sum(e.stale_hits for e in self.engines)),
            "stale_rate": _ratio(
                sum(e.stale_hits for e in self.engines),
                sum(r.cache_hits + r.peer_transfers for r in recs),
            ),
            "invalidations": int(
                sum(c.stats.invalidations for c in self._caches())
            ),
            "refreshes": int(sum(
                m.stats.refreshes for m in self._managers()
            )),
        }
        # per-region tail attribution through records_by_region() (§16):
        # the fleet p99 above hides WHICH region is slow — this names it,
        # via the same shared percentile the engine summaries use
        agg["latency_p99_by_region"] = {
            self.regions[rid].cfg.name: percentile(
                [rec.latency for rec in rrecs], 99
            )
            for rid, rrecs in self.records_by_region().items() if rrecs
        }
        shards = max(
            (getattr(c, "stage1_shards", 1) for c in self._caches()),
            default=1,
        )
        if shards > 1:
            # mesh-sharded stage 1 (DESIGN.md §13) — keyed off when
            # unsharded so pre-§13 aggregate summaries stay identical
            agg["stage1_shards"] = shards
        if self.sampler is not None:
            # telemetry-enabled runs get extra keys ONLY (the §16
            # neutrality gate strips these before byte-comparison)
            agg["timeseries_samples"] = len(self.sampler.samples)
            if self.monitor is not None:
                agg["slo_breaches"] = self.monitor.breaches
                agg["slo_recoveries"] = self.monitor.recoveries
        fed = self.federation
        if fed.peek_timeout is not None or fed.faults is not None:
            # §17 robustness keys, gated so fault-free pre-§17 summaries
            # stay byte-identical; hung_peeks MUST be 0 after run()
            agg["peek_timeouts"] = fs.peek_timeouts
            agg["breaker_skips"] = fs.breaker_skips
            agg["breaker_opens"] = fs.breaker_opens
            agg["breaker_closes"] = fs.breaker_closes
            agg["hung_peeks"] = int(sum(fed._inflight_peeks))
            agg["fetch_failed"] = int(
                sum(r.remote.failed for r in self.regions))
        if self.overload is not None:
            from repro_torch.serving.overload import OverloadStats

            tot = OverloadStats()
            for e in self.engines:
                for k, v in e.overload.metrics().items():
                    setattr(tot, k, getattr(tot, k) + v)
            agg["overload"] = dataclasses.asdict(tot)
        return {"aggregate": agg, "regions": per_region}


def _ratio(a, b) -> float:
    return a / b if b else 0.0
