"""The port's cross-region federation (``repro_torch.serving.federation``)
held to the reference's (``tests/test_federation.py``): the router's
local-hit / peer-hit / origin-fetch decision tree, transfer admission,
shared-clock determinism, the region-skewed workloads, and peek timeouts
with the per-peer circuit breaker. Every case runs the port with one
cache per region on its numpy backend and on its kernel backend on the
CPU (one index mirror per region; peers probe each other's mirror), and
its router statistics, results and summaries equal the reference's."""
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from repro_torch.data.workloads import region_workloads
from repro_torch.data.world import SemanticWorld
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import run_federated
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.federation import FederationRunner

torch.set_num_threads(1)

BACKENDS = ("numpy", "kernel")


def _canon(s):
    return json.dumps(s, sort_keys=True, default=float)


class _StubEngine:
    """Minimal engine surface the router touches."""

    def __init__(self, world, remote, region_id, null_tracer):
        self.world = world
        self.remote = remote
        self.region_id = region_id
        self.results = []
        self.trace = null_tracer

    def remote_done(self, st, q, t0, now, **kw):
        self.results.append(dict(q=q, t0=t0, now=now, **kw))


class _Side:
    """One package's federation surface: the port's on a backend, or the
    reference's (``backend=None``), so a scenario runs on both."""

    def __init__(self, backend):
        pkg = "repro" if backend is None else "repro_torch"
        mod = lambda path: importlib.import_module(f"{pkg}.{path}")  # noqa
        self.fed = mod("serving.federation")
        self.faults = mod("serving.faults")
        self.make_cache = mod("core.cache").make_cache
        self.make_tiered_cache = mod("core.tiers").make_tiered_cache
        self.OracleJudge = mod("core.judge").OracleJudge
        self.Remote = mod("serving.remote").RemoteDataService
        self.VirtualClock = mod("serving.clock").VirtualClock
        self.NULL_TRACER = mod("obs.trace").NULL_TRACER
        self.world = mod("data.world").SemanticWorld(n_intents=60, dim=32,
                                                     seed=3)
        self.kw = {} if backend is None else dict(backend=backend,
                                                  device="cpu")

    def region(self, rid, seed=0):
        judge = self.OracleJudge(self.world, accuracy=1.0, seed=seed + rid)
        cache = self.make_cache(capacity_bytes=500_000, dim=self.world.dim,
                                judge=judge, index_capacity=128, **self.kw)
        remote = self.Remote(qpm=None, seed=seed + 50 + rid)
        return self.fed.Region(rid, self.fed.RegionConfig(name=f"r{rid}"),
                               cache, remote, gpu=None)

    def federation(self, n_regions=2, rtt=0.08, bandwidth=1e9, faults=None,
                   **kw):
        if isinstance(faults, list):
            faults = self.faults.FaultSchedule.parse(faults)
        clock = self.VirtualClock()
        regions = [self.region(i) for i in range(n_regions)]
        fed = self.fed.Federation(regions, clock, rtt=rtt,
                                  bandwidth=bandwidth, faults=faults, **kw)
        engines = [_StubEngine(self.world, regions[i].remote, i,
                               self.NULL_TRACER) for i in range(n_regions)]
        return fed, clock, regions, engines

    def seed_peer(self, region, q, *, now=0.0, ttl=1000.0, staticity=7):
        w = self.world
        return region.cache.insert(
            q, w.embed(q), w.fetch(q), now=now, cost=0.005, latency=0.4,
            size=w.value_size(q), staticity=staticity, ttl=ttl)


def _drain(clock):
    guard = 0
    while clock.pending:
        clock.step()
        guard += 1
        assert guard < 10_000


def _observed(fed, engines, **extra):
    return dict(stats=dataclasses.asdict(fed.stats),
                results=[[{k: v for k, v in r.items() if k != "st"}
                          for r in e.results] for e in engines],
                inflight=list(fed._inflight_peeks), **extra)


def _held(scenario, backend):
    """``scenario(side)`` on the port's ``backend``, checked equal to the
    reference's; returns the port's observables."""
    got = scenario(_Side(backend))
    assert _canon(got) == _canon(scenario(_Side(None)))
    return got


# ---------------------------------------------------------- decision tree


def _peer_hit(side):
    fed, clock, regions, engines = side.federation(rtt=0.08)
    q = side.world.query(5, 0)
    src = side.seed_peer(regions[1], q, ttl=500.0)
    fed.route(engines[0], st=None, q=q, t0=0.0)
    _drain(clock)
    return _observed(fed, engines, src_size=src.size,
                     src_expiry=float(src.expires_at),
                     transfer_cost=fed.transfer_cost,
                     bandwidth=fed.bandwidth)


@pytest.mark.parametrize("backend", BACKENDS)
def test_peer_hit_transfers_value_with_provenance_and_ttl(backend):
    o = _held(_peer_hit, backend)
    s = o["stats"]
    assert (s["peeks"], s["peer_hits"], s["transfers"],
            s["origin_fetches"]) == (1, 1, 1, 0)
    [res] = o["results"][0]
    w = SemanticWorld(n_intents=60, dim=32, seed=3)
    q = w.query(5, 0)
    assert res["value"] == w.fetch(q)
    assert res["origin"] == 1
    assert res["staticity"] == 7
    assert res["size"] == o["src_size"]
    assert res["cost"] == pytest.approx(o["transfer_cost"])
    t_arrive = 0.08 + 0.04 + w.value_size(q) / o["bandwidth"]
    assert res["now"] == pytest.approx(t_arrive)
    assert res["ttl"] == pytest.approx(o["src_expiry"] - t_arrive)
    assert res["ttl"] < 500.0


def _all_nak(side):
    fed, clock, regions, engines = side.federation(rtt=0.08)
    fed.route(engines[0], st=None, q=side.world.query(5, 0), t0=0.0)
    _drain(clock)
    return _observed(fed, engines, transfer_cost=fed.transfer_cost,
                     lat_lo=regions[0].remote.lat_lo)


@pytest.mark.parametrize("backend", BACKENDS)
def test_all_peers_nak_falls_back_to_origin(backend):
    o = _held(_all_nak, backend)
    s = o["stats"]
    assert (s["peer_misses"], s["origin_fetches"], s["transfers"]) == \
        (1, 1, 0)
    [res] = o["results"][0]
    assert res["value"] is None
    assert res["cost"] > o["transfer_cost"]
    assert res["now"] >= 0.08 + o["lat_lo"]


def _expiring(side):
    fed, clock, regions, engines = side.federation(rtt=0.08)
    q = side.world.query(5, 0)
    side.seed_peer(regions[1], q, ttl=0.10)
    fed.route(engines[0], st=None, q=q, t0=0.0)
    _drain(clock)
    return _observed(fed, engines)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lease_expiring_in_flight_is_a_miss(backend):
    s = _held(_expiring, backend)["stats"]
    assert (s["expired_leases"], s["transfers"], s["origin_fetches"]) == \
        (1, 0, 1)


def _nearest(side):
    fed, clock, regions, engines = side.federation(
        n_regions=3, rtt=np.array([[0.0, 0.2, 0.05], [0.2, 0.0, 0.22],
                                   [0.05, 0.22, 0.0]]))
    q = side.world.query(5, 0)
    side.seed_peer(regions[1], q)
    side.seed_peer(regions[2], q)
    fed.route(engines[0], st=None, q=q, t0=0.0)
    _drain(clock)
    return _observed(fed, engines)


@pytest.mark.parametrize("backend", BACKENDS)
def test_nearest_holder_wins(backend):
    o = _held(_nearest, backend)
    assert o["stats"]["transfers"] == 1
    [res] = o["results"][0]
    assert res["origin"] == 2


def _warm_lease(side):
    fed, clock, regions, engines = side.federation(rtt=0.08)
    w = side.world
    judge = side.OracleJudge(w, accuracy=1.0, seed=1)
    tiered = side.make_tiered_cache(hot_bytes=500, warm_bytes=50_000,
                                    dim=w.dim, judge=judge,
                                    index_capacity=128, **side.kw)
    regions[1].cache = tiered
    q = w.query(5, 0)
    se = tiered.insert(q, w.embed(q), w.fetch(q), now=0.0, cost=0.005,
                       latency=0.4, size=100, staticity=7, ttl=500.0)
    for i in range(6, 12):
        qi = w.query(i, 0)
        tiered.insert(qi, w.embed(qi), w.fetch(qi), now=1.0, cost=0.005,
                      latency=0.4, size=100, staticity=7, ttl=500.0)
    demoted = se.se_id in tiered.warm.soa.id2row
    fed.route(engines[0], object(), w.query(5, 1), 0.0)
    _drain(clock)
    return _observed(fed, engines, demoted=demoted,
                     still_warm=se.se_id in tiered.warm.soa.id2row,
                     value=w.fetch(q))


@pytest.mark.parametrize("backend", BACKENDS)
def test_peer_leases_warm_tier_entry(backend):
    o = _held(_warm_lease, backend)
    assert o["demoted"] and o["still_warm"]
    res = o["results"][0][-1]
    assert res["value"] == o["value"]
    assert res["size"] == 100
    assert res["origin"] == 1
    assert o["stats"]["warm_leases"] == 1
    assert o["stats"]["peer_hits"] == 1


def _no_peering(side):
    fed, clock, regions, engines = side.federation(peering=False)
    side.seed_peer(regions[1], side.world.query(5, 0))
    fed.route(engines[0], st=None, q=side.world.query(5, 0), t0=0.0)
    _drain(clock)
    return _observed(fed, engines)


@pytest.mark.parametrize("backend", BACKENDS)
def test_peering_disabled_goes_straight_to_origin(backend):
    s = _held(_no_peering, backend)["stats"]
    assert s["peeks"] == 0 and s["origin_fetches"] == 1


# ------------------------------------------------------- runner / engine


def _tiny_runner(topology, backend, *, overlap=0.8, seed=0,
                 n_per_region=40):
    world = SemanticWorld(n_intents=80, dim=32, seed=9)
    streams = region_workloads(world, n_per_region, 2, overlap=overlap,
                               seed=10)
    return FederationRunner(
        world=world, region_requests=streams, topology=topology,
        engine_cfg=EngineConfig(prefetch=False), seed=seed,
        backend=backend, device="cpu")


_memo: dict = {}


def _ref_summary(topology, seed=0) -> str:
    from repro.data.workloads import region_workloads as ref_workloads
    from repro.data.world import SemanticWorld as RefWorld
    from repro.serving.engine import EngineConfig as RefEngineConfig
    from repro.serving.federation import FederationRunner as RefRunner

    if (topology, seed) not in _memo:
        world = RefWorld(n_intents=80, dim=32, seed=9)
        streams = ref_workloads(world, 40, 2, overlap=0.8, seed=10)
        _memo[topology, seed] = _canon(RefRunner(
            world=world, region_requests=streams, topology=topology,
            engine_cfg=RefEngineConfig(prefetch=False), seed=seed).run())
    return _memo[topology, seed]


def _run(runner, topology, seed=0) -> dict:
    s = runner.run()
    assert _canon(s) == _ref_summary(topology, seed)
    return s


@pytest.mark.parametrize("backend", BACKENDS)
def test_local_hit_never_consults_the_router(backend):
    runner = _tiny_runner("peered", backend)
    s = _run(runner, "peered")
    fed = runner.federation.stats
    hits = s["aggregate"]["cache_hits"]
    assert hits > 0
    total_rounds = sum(rec.rounds for e in runner.engines
                       for rec in e.records)
    assert fed.peeks == total_rounds - hits
    assert fed.peer_hits + fed.peer_misses == fed.peeks


@pytest.mark.parametrize("backend", BACKENDS)
def test_transferred_entries_carry_provenance_in_cache(backend):
    runner = _tiny_runner("peered", backend)
    _run(runner, "peered")
    origins = [se.origin for r in runner.regions
               for se in (r.cache.store[i] for i in r.cache.store)]
    transferred = [o for o in origins if o is not None]
    assert transferred
    assert all(o in (0, 1) for o in transferred)
    if backend == "kernel":
        # one device mirror per region, each holding its region's rows
        mirrors = [r.cache.seri.index for r in runner.regions]
        assert mirrors[0].emb_dev is not mirrors[1].emb_dev
        for ix in mirrors:
            assert ix.active_dev.numpy().tolist() == ix.active.tolist()


@pytest.mark.parametrize("backend", BACKENDS)
def test_peered_beats_local_on_overlapping_workload(backend):
    local = _run(_tiny_runner("local", backend), "local")["aggregate"]
    peered = _run(_tiny_runner("peered", backend), "peered")["aggregate"]
    assert peered["remote_time_mean"] < local["remote_time_mean"]
    assert peered["api_calls"] < local["api_calls"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_shared_clock_determinism(backend):
    for topology in ("peered", "global"):
        a = _run(_tiny_runner(topology, backend, seed=4), topology, seed=4)
        b = _tiny_runner(topology, backend, seed=4).run()
        assert a == b


@pytest.mark.parametrize("backend", BACKENDS)
def test_global_topology_shares_one_cache_and_pays_rtt(backend):
    runner = _tiny_runner("global", backend)
    assert runner.regions[0].cache is runner.regions[1].cache
    assert runner.engines[0].cfg.cache_access_latency == 0.0
    assert runner.engines[1].cfg.cache_access_latency == pytest.approx(0.08)
    s = _run(runner, "global")
    assert s["aggregate"]["peer_transfers"] == 0
    assert runner.federation.stats.peeks == 0


# ------------------------------------------------------- region workloads


def test_region_workloads_structure():
    from repro.data.workloads import region_workloads as ref_workloads
    from repro.data.world import SemanticWorld as RefWorld

    world = SemanticWorld(n_intents=200, dim=32, seed=1)
    streams = region_workloads(world, 100, 3, overlap=0.5, seed=2)
    assert len(streams) == 3
    rids = [r.rid for s in streams for r in s]
    assert len(set(rids)) == len(rids)
    for s in streams:
        assert all(a.arrival <= b.arrival for a, b in zip(s, s[1:]))
    ref = ref_workloads(RefWorld(n_intents=200, dim=32, seed=1), 100, 3,
                        overlap=0.5, seed=2)
    assert [[dataclasses.astuple(r) for r in s] for s in streams] == \
        [[dataclasses.astuple(r) for r in s] for s in ref]


def test_region_workload_overlap_controls_sharing():
    world = SemanticWorld(n_intents=200, dim=32, seed=1)

    def intent_sets(overlap):
        streams = region_workloads(world, 200, 2, overlap=overlap, seed=3)
        return [{world.intent_of(r.query) for r in s} for s in streams]

    a0, a1 = intent_sets(0.0)
    assert not a0 & a1
    b0, b1 = intent_sets(0.9)
    assert len(b0 & b1) / min(len(b0), len(b1)) > 0.5


# ------------------------------------- peek timeouts + circuit breaker


def _dark_peer(side):
    fed, clock, regions, engines = side.federation(
        peek_timeout=0.25, faults=["region_outage:0:1000:region=1"])
    q = side.world.query(5, 0)
    side.seed_peer(regions[1], q)
    fed.route(engines[0], st=None, q=q, t0=0.0)
    inflight = list(fed._inflight_peeks)
    _drain(clock)
    return _observed(fed, engines, inflight_during=inflight)


@pytest.mark.parametrize("backend", BACKENDS)
def test_peek_timeout_naks_dark_peer_and_decrements_inflight_once(backend):
    o = _held(_dark_peer, backend)
    s = o["stats"]
    assert o["inflight_during"][0] == 1
    assert (s["peek_timeouts"], s["peer_hits"], s["peer_misses"],
            s["origin_fetches"]) == (1, 0, 1, 1)
    assert o["inflight"] == [0, 0]
    assert len(o["results"][0]) == 1


def _late(side, peek_timeout):
    fed, clock, regions, engines = side.federation(peek_timeout=peek_timeout)
    q = side.world.query(5, 0)
    side.seed_peer(regions[1], q)
    fed.route(engines[0], st=None, q=q, t0=0.0)
    _drain(clock)
    return _observed(fed, engines)


@pytest.mark.parametrize("backend", BACKENDS)
def test_late_response_after_timeout_is_ignored(backend):
    o = _held(lambda side: _late(side, 0.05), backend)
    s = o["stats"]
    assert (s["peek_timeouts"], s["peer_hits"], s["transfers"],
            s["origin_fetches"]) == (1, 0, 0, 1)
    assert o["inflight"] == [0, 0]
    assert len(o["results"][0]) == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_response_before_timeout_keeps_legacy_path(backend):
    o = _held(lambda side: _late(side, 5.0), backend)
    s = o["stats"]
    assert (s["peek_timeouts"], s["peer_hits"], s["transfers"]) == (0, 1, 1)
    assert o["inflight"] == [0, 0]
    assert len(o["results"][0]) == 1


def _breaker(side, outage_end):
    fed, clock, regions, engines = side.federation(
        peek_timeout=0.25, faults=[f"region_outage:0:{outage_end}:region=1"])
    w, states = side.world, []

    def one_round(q):
        fed.route(engines[0], st=None, q=q, t0=clock.now)
        _drain(clock)
        br = fed._breaker[(0, 1)]
        states.append((br["state"], br["consec"],
                       dataclasses.asdict(fed.stats)))

    for i in range(3):
        one_round(w.query(5 + i, 0))
    if outage_end < 1000:
        one_round(w.query(8, 0))
    clock.push(clock.now + fed.breaker_cooldown + 1.0, lambda now: None)
    _drain(clock)
    one_round(w.query(9, 0))
    return _observed(fed, engines, states=states, k=fed.breaker_k)


@pytest.mark.parametrize("backend", BACKENDS)
def test_breaker_opens_after_k_timeouts_then_recloses_via_half_open(backend):
    o = _held(lambda side: _breaker(side, 5), backend)
    assert o["k"] == 3
    opened, skipped, closed = o["states"][2], o["states"][3], o["states"][4]
    assert opened[0] == "open"
    assert opened[2]["breaker_opens"] == 1
    assert opened[2]["peek_timeouts"] == 3
    assert skipped[2]["peeks"] == opened[2]["peeks"]
    assert skipped[2]["breaker_skips"] == 1
    assert closed[:2] == ("closed", 0)
    assert closed[2]["breaker_closes"] == 1
    assert o["inflight"] == [0, 0]


@pytest.mark.parametrize("backend", BACKENDS)
def test_half_open_probe_timeout_reopens_immediately(backend):
    o = _held(lambda side: _breaker(side, 1000), backend)
    assert o["states"][2][0] == "open"
    assert o["states"][-1][0] == "open"
    assert o["stats"]["breaker_opens"] == 2
    assert o["inflight"] == [0, 0]


@pytest.mark.parametrize("backend", BACKENDS)
def test_outage_runner_drains_with_zero_hung_peeks(backend):
    from repro.data.workloads import region_workloads as ref_workloads
    from repro.data.world import SemanticWorld as RefWorld
    from repro.serving.federation import FederationRunner as RefRunner

    kw = dict(topology="peered", faults=["region_outage:2:6:region=1"],
              peek_timeout=0.25, seed=0)
    world = SemanticWorld(n_intents=60, dim=32, seed=3)
    reqs = region_workloads(world, 30, 3, overlap=0.5, seed=4)
    s = FederationRunner(world=world, region_requests=reqs, backend=backend,
                         device="cpu", **kw).run()
    agg = s["aggregate"]
    assert agg["n"] == sum(len(r) for r in reqs)
    assert agg["hung_peeks"] == 0
    assert agg["peek_timeouts"] > 0
    rworld = RefWorld(n_intents=60, dim=32, seed=3)
    ref = RefRunner(world=rworld, region_requests=ref_workloads(
        rworld, 30, 3, overlap=0.5, seed=4), **kw).run()
    assert _canon(s) == _canon(ref)


# ------------------------------------------- the federated entry points

FED_CLI = ["--regions", "3", "--topology", "peered", "--peek-timeout",
           "0.25", "--faults", "region_outage:20:45:region=1",
           "--n-requests", "300"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_federated_and_cli_match_reference(backend, capsys):
    """run_federated (the reference README's outage command) and main
    --regions 3 give the reference's aggregate and per-region blocks."""
    from repro.launch.serve import main as ref_main

    s = serve_main(FED_CLI + ["--backend", backend, "--device", "cpu"])
    out = capsys.readouterr().out
    ref = ref_main(FED_CLI)
    assert capsys.readouterr().out == out
    assert _canon(s) == _canon(ref)
    assert s["aggregate"]["hung_peeks"] == 0
    assert set(s["regions"]) == {"r0", "r1", "r2"}
    assert _canon(run_federated(
        n_regions=3, topology="peered", peek_timeout=0.25,
        faults=["region_outage:20:45:region=1"], backend=backend,
        device="cpu")) == _canon(ref)


def test_federation_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    world = SemanticWorld(n_intents=20, dim=16, seed=0)
    streams = region_workloads(world, 5, 2, seed=1)
    with pytest.raises(RuntimeError, match="is_available"):
        FederationRunner(world=world, region_requests=streams)
    with pytest.raises(RuntimeError, match="is_available"):
        run_federated(n_requests=10)
    FederationRunner(world=world, region_requests=streams, device="cpu")
