"""The port's freshness subsystem (``repro_torch.core.freshness`` with
``MutableWorld``) held to the reference's (``tests/test_freshness.py``):
the mutable world's schedule, the change feed, the caches' refresh and
invalidation APIs, the manager's lifecycle, and the engine's staleness
accounting. Every cache-level case runs on the port's numpy backend and
on its kernel backend on the CPU (invalidation drops rows of the index
mirror, refresh-ahead rewrites a live entry in place), and its outcome
equals the reference's on the same seed; every summary equals
``repro.launch.serve.run_once``'s byte for byte."""
import importlib
import json

import numpy as np
import pytest
import torch

from repro.launch.serve import run_once as ref_run_once
from repro_torch.core.cache import make_cache
from repro_torch.core.freshness import ChangeFeed
from repro_torch.core.judge import OracleJudge
from repro_torch.data.world import MutableWorld, SemanticWorld
from repro_torch.launch.serve import run_once
from repro_torch.serving.clock import VirtualClock

torch.set_num_threads(1)

BACKENDS = ("numpy", "kernel")
MW_KW = dict(n_intents=80, dim=32, churn_min_period=10.0,
             churn_max_period=80.0, seed=3)
MW = MutableWorld(**MW_KW)


def _canon(s):
    return json.dumps(s, sort_keys=True, default=float)


class _Side:
    """One package's freshness surface: the port's on a backend, or the
    reference's (``backend=None``), so a scenario runs on both."""

    def __init__(self, backend):
        pkg = "repro" if backend is None else "repro_torch"
        mod = lambda path: importlib.import_module(f"{pkg}.{path}")  # noqa
        self.make_cache = mod("core.cache").make_cache
        self.make_tiered_cache = mod("core.tiers").make_tiered_cache
        f = mod("core.freshness")
        self.ChangeFeed, self.FreshnessConfig, self.FreshnessManager = \
            f.ChangeFeed, f.FreshnessConfig, f.FreshnessManager
        self.OracleJudge = mod("core.judge").OracleJudge
        self.MutableWorld = mod("data.world").MutableWorld
        self.VirtualClock = mod("serving.clock").VirtualClock
        self.RemoteDataService = mod("serving.remote").RemoteDataService
        self.kw = {} if backend is None else dict(backend=backend,
                                                  device="cpu")
        self.world = self.MutableWorld(**MW_KW)

    def cache(self, **kw):
        judge = self.OracleJudge(self.world, accuracy=1.0, seed=1)
        return self.make_cache(capacity_bytes=50_000, dim=self.world.dim,
                               judge=judge, index_capacity=128, **kw,
                               **self.kw)

    def manager(self, cfg=None, qpm=None):
        clock = self.VirtualClock()
        cache = self.cache()
        remote = self.RemoteDataService(qpm=qpm, seed=0)
        feed = self.ChangeFeed(self.world, clock)
        mgr = self.FreshnessManager(cache=cache, remote=remote,
                                    world=self.world, clock=clock,
                                    cfg=cfg and self.FreshnessConfig(**cfg),
                                    feed=feed)
        return clock, cache, remote, feed, mgr


def _held(scenario, backend):
    """``scenario(side)`` on the port's ``backend``, checked equal to the
    reference's; returns the port's observables."""
    got = scenario(_Side(backend))
    assert got == scenario(_Side(None))
    return got


# ------------------------------------------------------------- world


def test_mutable_world_versions_monotone_and_deterministic():
    from repro.data.world import MutableWorld as RefMutableWorld

    w2 = MutableWorld(**MW_KW)
    ref = RefMutableWorld(**MW_KW)
    for iid in range(0, 80, 7):
        prev = -1
        for t in np.linspace(0.0, 300.0, 40):
            v = MW.intent_version(iid, float(t))
            assert v >= prev
            assert v == w2.intent_version(iid, float(t))
            assert v == ref.intent_version(iid, float(t))
            prev = v


def test_mutable_world_answer_changes_exactly_at_updates():
    iid = next(i for i in range(80)
               if np.isfinite(MW._phase[i]) and MW._phase[i] < 100.0)
    q = MW.query(iid, 0)
    u1 = MW.next_update(iid, 0.0)
    eps = 1e-6
    assert MW.answer_at(q, u1 - eps) == f"answer-{iid}"
    assert MW.answer_at(q, u1 + eps) == f"answer-{iid}-v1"
    u2 = MW.next_update(iid, u1 + eps)
    assert u2 > u1
    assert MW.answer_at(q, u2 + eps) == f"answer-{iid}-v2"
    assert MW.fetch(q, u1 + eps) == MW.answer_at(q, u1 + eps)


def test_mutable_world_staticity_drives_period_inversely():
    stats = np.array([it.staticity for it in MW.intents])
    per = MW._period
    finite = np.isfinite(per)
    lo = per[finite & (stats == stats[finite].min())]
    hi = per[finite & (stats == stats[finite].max())]
    assert lo.max() < hi.min()
    assert per[finite].min() >= 10.0 - 1e-9


def test_mutable_world_next_update_strictly_advances():
    for iid in range(80):
        if not np.isfinite(MW._phase[iid]):
            continue
        t = 0.0
        for _ in range(50):
            nxt = MW.next_update(iid, t)
            assert nxt > t
            t = nxt


def test_static_world_freshness_surface_is_inert():
    w = SemanticWorld(n_intents=10, dim=16, seed=0)
    q = w.query(3, 0)
    assert w.version_at(q, 1e9) == 0
    assert w.next_update(3, 0.0) == float("inf")
    assert w.answer_at(q, 1e9) == w.answer(q)


def test_churn_frac_zero_is_static():
    w = MutableWorld(n_intents=40, dim=16, churn_min_period=5.0,
                     churn_frac=0.0, seed=1)
    for i in range(40):
        assert w.intent_version(i, 1e6) == 0
        assert w.next_update(i, 0.0) == float("inf")


# --------------------------------------------------------- change feed


def test_change_feed_notice_carries_wan_delay():
    clock = VirtualClock()
    feed = ChangeFeed(MW, clock)
    got = []
    feed.subscribe(lambda i, v, t: got.append((clock.now, i, v, t)), 0.5)
    iid = next(i for i in range(80)
               if np.isfinite(MW._phase[i]) and MW._phase[i] < 50.0)
    feed.watch(iid)
    feed.watch(iid)
    u1 = MW.next_update(iid, 0.0)
    while clock.pending and clock.now < u1 + 1.0:
        clock.step()
    assert got
    t_recv, i, v, t_up = got[0]
    assert i == iid and v == 1
    assert t_up == pytest.approx(u1)
    assert t_recv == pytest.approx(u1 + 0.5)


def test_change_feed_ignores_static_intents():
    clock = VirtualClock()
    w = MutableWorld(n_intents=20, dim=16, churn_frac=0.0, seed=2)
    feed = ChangeFeed(w, clock)
    feed.subscribe(lambda *a: None, 0.1)
    for i in range(20):
        feed.watch(i)
    assert clock.pending == 0


# ------------------------------------------------- cache refresh APIs


def _live_view(side):
    w, cache = side.world, side.cache()
    q = w.query(1, 0)
    se = cache.insert(q, w.embed(q), w.fetch(q, 0.0), now=0.0, cost=0.01,
                      latency=0.3, size=100, version=0)
    view = cache.store[se.se_id]
    old_expiry = view.expires_at
    assert cache.refresh_entry(se.se_id, value="fresh-v3", version=3,
                               now=50.0) is not None
    assert view.expires_at > old_expiry
    return (view.valid, view.value, view.version, view.fetched_at,
            view.revalidating, view.row == se.row, view.freq == se.freq,
            float(view.expires_at))


@pytest.mark.parametrize("backend", BACKENDS)
def test_live_view_survives_in_place_refresh(backend):
    got = _held(_live_view, backend)
    assert got[:7] == (True, "fresh-v3", 3, 50.0, False, True, True)


def _revalidating(side):
    w, cache = side.world, side.cache()
    q = w.query(2, 0)
    se = cache.insert(q, w.embed(q), w.fetch(q, 0.0), now=0.0, cost=0.01,
                      latency=0.3, size=100)
    q2 = w.query(2, 1)
    out = [cache.lookup(q2, w.embed(q2), 1.0).hit]
    se.revalidating = True
    out.append(cache.lookup(q2, w.embed(q2), 2.0).hit)
    out.append(cache.peek_semantic(q2, w.embed(q2), 2.0) is None)
    cache.refresh_entry(se.se_id, value="v1", version=1, now=3.0)
    out.append(cache.lookup(q2, w.embed(q2), 4.0).hit)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_revalidating_entry_is_not_servable(backend):
    assert _held(_revalidating, backend) == [True, False, True, True]


def _invalidated_mid_batch(side):
    w, cache = side.world, side.cache()
    q = w.query(4, 0)
    se = cache.insert(q, w.embed(q), w.fetch(q, 0.0), now=0.0, cost=0.01,
                      latency=0.3, size=100)
    q2 = w.query(4, 1)
    cands = cache.stage1(q2, w.embed(q2), 1.0)
    first = bool(cands) and cands[0].se_id == se.se_id
    dropped = cache.invalidate_se(se.se_id, 1.5)
    res = cache.finalize(q2, cands, np.ones(len(cands), np.float32), 2.0)
    return first, dropped, res.hit, cache.stats.invalidations, len(
        cache.seri.index)


@pytest.mark.parametrize("backend", BACKENDS)
def test_rebind_skips_candidate_invalidated_mid_batch(backend):
    assert _held(_invalidated_mid_batch, backend) == (True, True, False, 1, 0)


def _intent_invalidation(side):
    w, cache = side.world, side.cache()
    for i, para in ((7, 0), (7, 1), (9, 0)):
        q = w.query(i, para)
        cache.insert(q, w.embed(q), "v", now=0.0, cost=0.01, latency=0.3,
                     size=50, intent=i)
    ses = cache.ses_for_intent(7)
    out = [[se.intent for se in ses]]
    out.append([cache.invalidate_se(se.se_id, 1.0) for se in ses])
    out += [cache.ses_for_intent(7), len(cache.ses_for_intent(9)),
            cache.stats.invalidations, cache.invalidate_se(12345, 1.0),
            len(cache.seri.index)]
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_ses_for_intent_and_invalidate(backend):
    assert _held(_intent_invalidation, backend) == \
        [[7, 7], [True, True], [], 1, 2, False, 1]


# ------------------------------------------------- manager lifecycle


def _renew(side):
    clock, cache, remote, feed, mgr = side.manager(
        dict(refresh_margin=0.2, refresh_min_freq=1))
    w = side.world
    q = w.query(1, 0)
    se = cache.insert(q, w.embed(q), w.fetch(q, 0.0), now=0.0, cost=0.01,
                      latency=0.3, size=100, version=w.version_at(q, 0.0))
    mgr.on_insert(se)
    q2 = w.query(1, 1)
    hit = cache.lookup(q2, w.embed(q2), 1.0).hit
    expiry0 = se.expires_at
    while clock.pending and clock.now < expiry0 + 1.0 and \
            mgr.stats.refreshes == 0:
        clock.step()
    return (hit, mgr.stats.refreshes, se.valid, se.expires_at > expiry0,
            se.version == w.version_at(q, clock.now),
            mgr.stats.refresh_cost > 0.0, float(se.expires_at))


@pytest.mark.parametrize("backend", BACKENDS)
def test_refresh_ahead_renews_before_expiry(backend):
    assert _held(_renew, backend)[:6] == (True, 1, True, True, True, True)


def _refresh_chain(side):
    clock, cache, remote, feed, mgr = side.manager(
        dict(invalidation=False, refresh_margin=0.2, refresh_min_freq=1))
    w = side.world
    q = w.query(1, 0)
    se = cache.insert(q, w.embed(q), w.fetch(q, 0.0), now=0.0, cost=0.01,
                      latency=0.3, size=100)
    mgr.on_insert(se)
    q2 = w.query(1, 1)
    hit = cache.lookup(q2, w.embed(q2), 1.0).hit
    while clock.pending:
        clock.step()
    return hit, mgr.stats.refreshes, se.valid, se.expired(
        se.expires_at + 1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_refresh_chain_stops_when_hits_stop(backend):
    assert _held(_refresh_chain, backend) == (True, 1, True, True)


def _cold(side):
    clock, cache, remote, feed, mgr = side.manager(
        dict(refresh_margin=0.2, refresh_min_freq=5))
    w = side.world
    q = w.query(1, 0)
    se = cache.insert(q, w.embed(q), w.fetch(q, 0.0), now=0.0, cost=0.01,
                      latency=0.3, size=100)
    mgr.on_insert(se)
    expiry0 = se.expires_at
    while clock.pending and clock.now <= expiry0:
        clock.step()
    return mgr.stats.refreshes


@pytest.mark.parametrize("backend", BACKENDS)
def test_cold_entries_expire_instead_of_refreshing(backend):
    assert _held(_cold, backend) == 0


def _provenance(side):
    clock, cache, remote, feed, mgr = side.manager(
        dict(refresh_margin=0.1, refresh_min_freq=0, feed_delay=0.05))
    w = side.world
    iid = next(i for i in range(80)
               if np.isfinite(w._phase[i]) and 5.0 < w._phase[i] < 60.0)
    q_own, q_copy = w.query(iid, 0), w.query(iid, 1)
    own = cache.insert(q_own, w.embed(q_own), w.fetch(q_own, 0.0), now=0.0,
                       cost=0.01, latency=0.3, size=100, intent=iid,
                       version=0)
    copy = cache.insert(q_copy, w.embed(q_copy), w.fetch(q_copy, 0.0),
                        now=0.0, cost=0.001, latency=0.05, size=100,
                        intent=iid, version=0, origin=2)
    mgr.on_insert(own)
    mgr.on_insert(copy)
    own_id, copy_id = own.se_id, copy.se_id
    u1 = w.next_update(iid, 0.0)
    while clock.pending and clock.now < u1 + 5.0:
        clock.step()
    return (mgr.stats.notices >= 1, copy_id not in cache.store,
            own_id in cache.store, cache.store[own_id].version >= 1,
            cache.stats.invalidations >= 1, mgr.stats.refreshes >= 1,
            len(cache.seri.index))


@pytest.mark.parametrize("backend", BACKENDS)
def test_notice_drops_federated_copy_refreshes_own(backend):
    assert _held(_provenance, backend) == (True,) * 6 + (1,)


def _unwatch(side):
    clock, cache, remote, feed, mgr = side.manager(
        dict(refresh_ahead=False, feed_delay=0.05))
    w = side.world
    iid = next(i for i in range(80)
               if np.isfinite(w._phase[i]) and w._phase[i] < 50.0)
    q = w.query(iid, 0)
    se = cache.insert(q, w.embed(q), w.fetch(q, 0.0), now=0.0, cost=0.01,
                      latency=0.3, size=100, intent=iid)
    mgr.on_insert(se)
    out = [iid in feed._watched]
    period = float(w._period[iid])
    u1 = w.next_update(iid, 0.0)
    while clock.pending and clock.now < u1 + 2 * period + 1.0:
        clock.step()
    out += [se.se_id not in cache.store, iid not in feed._watched,
            len(cache.seri.index)]
    q1 = w.query(iid, 1)
    se2 = cache.insert(q1, w.embed(q1), "v", now=clock.now, cost=0.01,
                       latency=0.3, size=100, intent=iid)
    mgr.on_insert(se2)
    return out + [iid in feed._watched]


@pytest.mark.parametrize("backend", BACKENDS)
def test_feed_unwatches_intent_no_longer_cached(backend):
    assert _held(_unwatch, backend) == [True, True, True, 0, True]


def _promotion(side):
    clock = side.VirtualClock()
    w = side.world
    judge = side.OracleJudge(w, accuracy=1.0, seed=1)
    cache = side.make_tiered_cache(hot_bytes=50_000, warm_bytes=50_000,
                                   dim=w.dim, judge=judge,
                                   index_capacity=128, **side.kw)
    remote = side.RemoteDataService(qpm=None, seed=0)
    mgr = side.FreshnessManager(
        cache=cache, remote=remote, world=w, clock=clock,
        cfg=side.FreshnessConfig(invalidation=False, refresh_margin=0.2,
                                 refresh_min_freq=0))
    out = [cache.on_promote is not None]
    q = w.query(1, 0)
    se = cache.insert(q, w.embed(q), w.fetch(q, 0.0), now=0.0, cost=0.01,
                      latency=0.3, size=100, intent=1)
    se_id = se.se_id
    cache._evict_n(1, 0.5)
    out.append(se_id in cache.warm.soa.id2row)
    q2 = w.query(1, 1)
    res = cache.lookup(q2, w.embed(q2), 1.0)
    out.append(res.hit and se_id in cache.store)
    while clock.pending and mgr.stats.refreshes == 0:
        clock.step()
    return out + [mgr.stats.refreshes >= 1, se_id in cache.store]


@pytest.mark.parametrize("backend", BACKENDS)
def test_promotion_rearms_refresh_timer(backend):
    assert _held(_promotion, backend) == [True] * 5


def _rate_limited(side):
    clock, cache, remote, feed, mgr = side.manager(
        dict(refresh_margin=0.2, refresh_min_freq=0,
             refresh_min_headroom=2.0), qpm=60.0)
    w = side.world
    q = w.query(1, 0)
    se = cache.insert(q, w.embed(q), w.fetch(q, 0.0), now=0.0, cost=0.01,
                      latency=0.3, size=100)
    mgr.on_insert(se)
    expiry0 = se.expires_at
    while clock.pending and clock.now <= expiry0:
        clock.step()
    return mgr.stats.refreshes, mgr.stats.refresh_skipped >= 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_refresh_skipped_under_rate_limit_pressure(backend):
    assert _held(_rate_limited, backend) == (0, True)


# -------------------------------------------------------- engine e2e

E2E = dict(workload="churn", mode="cortex", n_requests=160, n_intents=120,
           dim=32, concurrency=8, seed=11, churn_period=12.0,
           churn_max_period=96.0, max_ttl=60.0, qpm=None, judge_acc=1.0,
           prefetch=False)
CASES = {"static": {**E2E, "churn_period": None, "churn_max_period": None},
         "ttl_only": E2E,
         "inval": dict(E2E, invalidation=True, refresh_ahead=True)}
_memo: dict = {}


def _run(case: str, backend: str) -> dict:
    """The port's summary on ``backend``, checked equal to the
    reference's byte for byte; each (case, backend) runs once."""
    if case not in _memo:
        _memo[case] = {"ref": _canon(ref_run_once(**CASES[case]))}
    if backend not in _memo[case]:
        got = _canon(run_once(backend=backend, device="cpu", **CASES[case]))
        assert got == _memo[case]["ref"], case
        _memo[case][backend] = got
    return json.loads(_memo[case][backend])


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_stale_hits_zero_without_churn(backend):
    s = _run("static", backend)
    assert s["stale_hits"] == 0
    assert s["stale_age_hist"]["0-30"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_invalidation_cuts_stale_hits(backend):
    ttl_only, inval = _run("ttl_only", backend), _run("inval", backend)
    assert ttl_only["stale_hits"] > 0
    assert inval["stale_hit_rate"] < ttl_only["stale_hit_rate"]
    assert inval["info_accuracy"] > ttl_only["info_accuracy"]
    assert inval["refreshes"] > 0
    assert sum(ttl_only["stale_age_hist"].values()) == ttl_only["stale_hits"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_same_seed_bit_identical_under_churn(backend):
    a = _run("inval", backend)
    b = run_once(backend=backend, device="cpu", **CASES["inval"])
    assert _canon(a) == _canon(b)


def _federation(side, freshness: bool):
    pkg = "repro" if not side.kw else "repro_torch"
    workloads = importlib.import_module(f"{pkg}.data.workloads")
    fed = importlib.import_module(f"{pkg}.serving.federation")
    if freshness:
        world = side.MutableWorld(n_intents=100, dim=32,
                                  churn_min_period=15.0,
                                  churn_max_period=120.0, seed=5)
        streams = workloads.region_workloads(world, 40, 2, overlap=0.7,
                                             seed=6)
        extra = dict(freshness=side.FreshnessConfig(refresh_min_freq=1))
    else:
        world = importlib.import_module(f"{pkg}.data.world").SemanticWorld(
            n_intents=80, dim=32, seed=5)
        streams = workloads.region_workloads(world, 25, 2, overlap=0.6,
                                             seed=6)
        extra = {}
    return _canon(fed.FederationRunner(
        world=world, region_requests=streams, topology="peered", seed=7,
        **extra, **side.kw).run())


@pytest.mark.parametrize("backend", BACKENDS)
def test_federation_invalidation_propagates(backend):
    a = json.loads(_held(lambda side: _federation(side, True),
                         backend))["aggregate"]
    assert a["peer_transfers"] > 0
    assert a["invalidations"] + a["refreshes"] > 0
    b = json.loads(_federation(_Side(backend), True))["aggregate"]
    assert _canon(a) == _canon(b)


@pytest.mark.parametrize("backend", BACKENDS)
def test_federation_without_freshness_unchanged(backend):
    a = json.loads(_held(lambda side: _federation(side, False),
                         backend))["aggregate"]
    assert a["stale_hits"] == 0
    assert a["refreshes"] == 0 and a["invalidations"] == 0


# ------------------------------------------------- exact-cache parity


def test_exact_cache_ttl_from_staticity():
    from repro_torch.core.semantic_element import ttl_from_staticity
    from repro_torch.serving.engine import ExactCache

    c = ExactCache(10_000, max_ttl=600.0, min_ttl=30.0)
    c.insert("ephemeral", "v", 100, now=0.0, staticity=1)
    c.insert("stable", "v", 100, now=0.0, staticity=10)
    c.insert("legacy", "v", 100, now=0.0)
    assert c.d["ephemeral"][1] == pytest.approx(30.0)
    assert c.d["stable"][1] == pytest.approx(600.0)
    assert c.d["legacy"][1] == pytest.approx(600.0)
    assert c.d["ephemeral"][1] == pytest.approx(
        ttl_from_staticity(1, c.max_ttl, c.min_ttl))
    assert c.lookup("ephemeral", now=31.0) is None
    assert c.lookup("stable", now=31.0) == "v"


def test_kernel_backend_mirror_drops_invalidated_rows():
    """Invalidation on the kernel backend clears the dropped rows of the
    device mirror (its live mask and its rows), not only the host arrays."""
    cache = make_cache(capacity_bytes=50_000, dim=MW.dim,
                       judge=OracleJudge(MW, accuracy=1.0, seed=1),
                       index_capacity=128, backend="kernel", device="cpu")
    ses = []
    for i in range(6):
        q = MW.query(i, 0)
        ses.append(cache.insert(q, MW.embed(q), "v", now=0.0, cost=0.01,
                                latency=0.3, size=50, intent=i))
    index = cache.seri.index
    rows = [se.row for se in ses[:3]]
    for se in ses[:3]:
        assert cache.invalidate_se(se.se_id, 1.0)
    assert not index.active_dev[rows].any()
    assert index.active_dev.numpy().tolist() == index.active.tolist()
    assert torch.count_nonzero(index.emb_dev[rows]) == 0
    assert torch.equal(index.emb_dev, torch.from_numpy(index.emb))
