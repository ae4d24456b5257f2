"""The port's cache invariants (``core/cache.py``, ``core/seri.py``,
``core/semantic_element.py``) against the JAX package's: analogues of
tests/test_cache_properties.py's 9 tests.

The reference's three property tests draw op sequences with
``hypothesis``, which is absent here (its tests skip), so each becomes
seeded, parametrised sequences from the same ranges (intent 0-119,
paraphrase 0-30, time offset 0-500, 1 to 60 ops). Every case drives the
port's cache (stage 1 on the kernel backend on ``device="cpu"``, the
plain versions; the numpy backend too) and the reference's through the
same ops, checks the reference test's invariant on the port's, and holds
each lookup's outcome (hit or miss, the key served) and the cache's
usage equal to the reference's, with no tolerance.
"""
import numpy as np
import pytest

from repro.core.cache import make_cache as ref_make_cache
from repro.core.judge import OracleJudge as RefJudge
from repro.core.semantic_element import \
    ttl_from_staticity as ref_ttl_from_staticity
from repro.data.world import SemanticWorld as RefWorld
from repro_torch.core.cache import make_cache
from repro_torch.core.judge import OracleJudge
from repro_torch.core.semantic_element import ttl_from_staticity
from repro_torch.data.world import SemanticWorld

WORLD = SemanticWorld(n_intents=120, dim=48, seed=7)
REF_WORLD = RefWorld(n_intents=120, dim=48, seed=7)
BACKENDS = ["kernel", "numpy"]


def fresh_cache(capacity=20_000, eviction="lcfu", acc=1.0, max_ttl=600.0,
                backend="kernel"):
    judge = OracleJudge(WORLD, accuracy=acc, seed=1)
    return make_cache(capacity_bytes=capacity, dim=WORLD.dim, judge=judge,
                      eviction=eviction, max_ttl=max_ttl,
                      index_capacity=256, backend=backend, device="cpu")


def ref_cache(capacity=20_000, eviction="lcfu", acc=1.0, max_ttl=600.0):
    judge = RefJudge(REF_WORLD, accuracy=acc, seed=1)
    return ref_make_cache(capacity_bytes=capacity, dim=REF_WORLD.dim,
                          judge=judge, eviction=eviction, max_ttl=max_ttl,
                          index_capacity=256)


def draw_ops(seed: int) -> list:
    """One op sequence from the reference strategy's ranges."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 61))
    return list(zip(rng.integers(0, 120, n).tolist(),
                    rng.integers(0, 31, n).tolist(),
                    rng.uniform(0.0, 500.0, n).tolist()))


def replay(seq, port, ref, world, ref_world, check) -> None:
    """``seq`` through both caches: lookup, insert on a miss; each
    lookup's outcome and the usage equal; ``check(cache, res, now, q)``
    on the port's after each lookup."""
    now = 0.0
    for intent, para, dt in seq:
        now += dt
        outcomes = []
        for cache, w in ((port, world), (ref, ref_world)):
            q = w.query(intent, para)
            emb = w.embed(q)
            res = cache.lookup(q, emb, now)
            outcomes.append((res.hit, res.se.key if res.hit else None))
            if cache is port:
                check(cache, res, now, q)
            if not res.hit:
                cache.insert(q, emb, w.fetch(q), now=now, cost=0.005,
                             latency=0.4, size=w.value_size(q))
        assert outcomes[0] == outcomes[1]
        assert port.usage == ref.usage


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(6))
def test_capacity_never_exceeded(seed, backend):
    def check(cache, res, now, q):
        assert cache.usage <= cache.capacity_bytes
        assert cache.usage == sum(se.size for se in cache.store.values())
        assert len(cache.store) == len(cache.rows)
        assert len(cache.seri.index) == len(cache.store)

    replay(draw_ops(seed), fresh_cache(backend=backend), ref_cache(), WORLD,
           REF_WORLD, check)


@pytest.mark.parametrize("seed", range(100, 104))
def test_no_expired_item_ever_hits(seed):
    def check(cache, res, now, q):
        if res.hit:
            assert not res.se.expired(now)

    replay(draw_ops(seed), fresh_cache(max_ttl=120.0),
           ref_cache(max_ttl=120.0), WORLD, REF_WORLD, check)


@pytest.mark.parametrize("seed", range(200, 204))
def test_semantic_hits_are_correct_with_perfect_judge(seed):
    """With a perfect judge every hit serves the right intent's answer."""
    def check(cache, res, now, q):
        if res.hit:
            assert res.se.value == WORLD.answer(q)

    replay(draw_ops(seed), fresh_cache(acc=1.0), ref_cache(acc=1.0), WORLD,
           REF_WORLD, check)


def _lcfu_run(cache, world):
    now, inserted = 0.0, []
    for i in range(30):
        q = world.query(i, 0)
        inserted.append(cache.insert(q, world.embed(q), world.fetch(q),
                                     now=now, cost=0.005, latency=0.4,
                                     size=world.value_size(q)))
        now += 1.0
    return now, inserted


def test_lcfu_evicts_lowest_score():
    cache = fresh_cache(capacity=5_000)
    now, inserted = _lcfu_run(cache, WORLD)
    surviving = set(cache.store)
    scores = {se.se_id: se.lcfu_score(now) for se in inserted}
    assert 0 < len(surviving) < len(inserted)
    max_evicted = max(s for i, s in scores.items() if i not in surviving)
    assert any(scores[i] >= max_evicted for i in surviving)
    ref = ref_cache(capacity=5_000)
    _, ref_inserted = _lcfu_run(ref, REF_WORLD)
    assert sorted(se.key for se in cache.store.values()) == \
        sorted(se.key for se in ref.store.values())
    assert [se.lcfu_score(now) for se in inserted] == \
        [se.lcfu_score(now) for se in ref_inserted]


def test_insert_honors_explicit_staticity_zero():
    """A caller's staticity 0 is kept (the guard is ``is None``), on the
    scalar and the batched path, as in the reference."""
    for cache, w, ttl in ((fresh_cache(), WORLD, ttl_from_staticity),
                          (ref_cache(), REF_WORLD, ref_ttl_from_staticity)):
        q = w.query(3, 0)
        se = cache.insert(q, w.embed(q), w.fetch(q), now=0.0, cost=0.005,
                          latency=0.4, size=100, staticity=0)
        assert se.staticity == 0
        assert se.expires_at == pytest.approx(
            ttl(0, cache.max_ttl, cache.min_ttl))
        [se2] = cache.insert_batch(
            [dict(query=w.query(4, 0), q_emb=w.embed(w.query(4, 0)),
                  value="v", cost=0.005, latency=0.4, size=100,
                  staticity=0)], now=0.0)
        assert se2.staticity == 0
        se3 = cache.insert(w.query(5, 0), w.embed(w.query(5, 0)), "v",
                           now=0.0, cost=0.005, latency=0.4, size=100)
        assert se3.staticity == w.staticity(w.query(5, 0)) >= 1
    assert fresh_cache().max_ttl == ref_cache().max_ttl


def test_shared_hit_accounting_counts_prefetch_hits():
    """account_hit bumps prefetch_hits at a prefetched entry's first
    confirmed hit only, as the reference's."""
    stats = []
    for cache, w in ((fresh_cache(), WORLD), (ref_cache(), REF_WORLD)):
        q = w.query(6, 0)
        se = cache.insert(q, w.embed(q), w.fetch(q), now=0.0, cost=0.005,
                          latency=0.4, size=100, prefetched=True)
        assert se.freq == 0
        cache.account_hit(se, now=1.0)
        assert cache.stats.prefetch_hits == 1 and cache.stats.hits == 1
        assert se.freq == 1 and se.last_access == 1.0
        cache.account_hit(se, now=2.0)
        assert cache.stats.prefetch_hits == 1
        stats.append((cache.stats.hits, cache.stats.prefetch_hits, se.freq))
    assert stats[0] == stats[1]


def test_ttl_from_staticity_monotone():
    ttls = [ttl_from_staticity(s, 3600.0) for s in range(1, 11)]
    assert ttls == [ref_ttl_from_staticity(s, 3600.0) for s in range(1, 11)]
    assert all(a < b for a, b in zip(ttls, ttls[1:]))
    assert ttls[0] == 30.0
    assert abs(ttls[-1] - 3600.0) < 1e-6


def test_ttl_from_staticity_clamps_at_class_bounds():
    for s in (-5, 0, 1):
        assert ttl_from_staticity(s, 3600.0) == ttl_from_staticity(1, 3600.0)
    for s in (10, 11, 99):
        assert ttl_from_staticity(s, 3600.0) == \
            ttl_from_staticity(10, 3600.0)
    assert ttl_from_staticity(0, 900.0, 15.0) == 15.0
    assert ttl_from_staticity(42, 900.0, 15.0) == pytest.approx(900.0)
    for args in ((-5, 3600.0), (99, 3600.0), (0, 900.0, 15.0),
                 (42, 900.0, 15.0), (5, 1800.0, 60.0)):
        assert ttl_from_staticity(*args) == ref_ttl_from_staticity(*args)


def _policy_run(cache, w):
    now = 0.0
    for i in range(5):        # expensive, once-validated items
        q = w.query(i, 0)
        cache.insert(q, w.embed(q), w.fetch(q), now=now, cost=0.5,
                     latency=2.0, size=100)
        q2 = w.query(i, 1)
        assert cache.lookup(q2, w.embed(q2), now).hit
        now += 1.0
    for i in range(5, 25):    # cheap one-shot items, each also hit once
        q = w.query(i, 0)
        cache.insert(q, w.embed(q), w.fetch(q), now=now, cost=1e-4,
                     latency=0.05, size=100)
        q2 = w.query(i, 1)
        cache.lookup(q2, w.embed(q2), now)
        now += 1.0
    return {w.intent_of(se.key) for se in cache.store.values()}


@pytest.mark.parametrize("eviction", ["lcfu", "lru", "lfu"])
def test_eviction_policies_differ(eviction):
    """LCFU keeps the expensive early items that LRU drops; each policy
    keeps the reference's intents."""
    kept = _policy_run(fresh_cache(capacity=1_500, eviction=eviction), WORLD)
    assert kept == _policy_run(ref_cache(capacity=1_500, eviction=eviction),
                               REF_WORLD)
    if eviction == "lcfu":
        assert any(i < 5 for i in kept)
    if eviction == "lru":
        assert not any(i < 5 for i in kept)
