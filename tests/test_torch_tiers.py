"""The port's tiered storage (``repro_torch.core.tiers``) against the JAX
package's (``repro.core.tiers``), analogues of tests/test_tiers.py.

Each test drives one operation sequence through the reference (numpy
backend) and the port, on its numpy backend and on its kernel backend with
the device mirror on the CPU (the kernels' plain PyTorch versions), and
compares the outcome and the cache state: stats, tier stats, which entry
lives in which tier and row, byte usage, and absolute expiries. The int8
coarse scores are exact on every path and the fp32 rescore is the same
host code, so results are compared bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.judge import OracleJudge as RefOracleJudge
from repro.core.tiers import QuantIndex as RefQuantIndex
from repro.core.tiers import make_tiered_cache as ref_make_tiered_cache
from repro.data.world import SemanticWorld as RefSemanticWorld
from repro_torch.convert import quant_index_from_numpy
from repro_torch.core.judge import OracleJudge
from repro_torch.core.tiers import QuantIndex, make_tiered_cache
from repro_torch.data.world import SemanticWorld
from repro_torch.kernels.ann_topk_quant import ann_topk_quant

torch.set_num_threads(1)

BACKENDS = ["numpy", "kernel"]
WORLDS = (RefSemanticWorld(n_intents=120, dim=48, seed=7),
          SemanticWorld(n_intents=120, dim=48, seed=7))


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pair(backend, seed=3, hot=15_000, warm=15_000, max_ttl=400.0,
          accuracy=0.98, **kw):
    """The reference's tiered cache and the port's, same arguments."""
    rw, pw = WORLDS
    ref = ref_make_tiered_cache(
        hot_bytes=hot, warm_bytes=warm, dim=rw.dim,
        judge=RefOracleJudge(rw, accuracy=accuracy, seed=seed),
        index_capacity=256, max_ttl=max_ttl, **kw)
    port = make_tiered_cache(
        hot_bytes=hot, warm_bytes=warm, dim=pw.dim,
        judge=OracleJudge(pw, accuracy=accuracy, seed=seed),
        index_capacity=256, max_ttl=max_ttl, backend=backend, device="cpu",
        **kw)
    return ref, port


def _insert(cache, world, intent, para=0, *, now, size=100):
    q = world.query(intent, para)
    return cache.insert(q, world.embed(q), world.fetch(q), now=now,
                        size=size, cost=0.01, latency=0.4)


def _state(cache):
    """Everything a user or the next operation can see of the cache."""
    w = cache.warm
    return {
        "stats": dataclasses.asdict(cache.stats),
        "tier_stats": dataclasses.asdict(cache.tier_stats),
        "hot": sorted((i, int(cache.soa.id2row[i]),
                       float(cache.store[i].expires_at),
                       int(cache.store[i].freq)) for i in cache.store),
        "warm": sorted((i, int(r), float(w.soa.expires_at[r]),
                        int(w.soa.freq[r])) for i, r in w.soa.id2row.items()),
        "usage": (cache.usage, w.usage),
        "hot_emb": cache.seri.index.emb.tobytes(),
        "warm_q": (w.index.emb_q.tobytes(), w.index.scale.tobytes()),
        "free": (list(cache.seri.index._free), list(w.index._free)),
    }


def _assert_mirrored(cache):
    """The kernel backend's device mirrors equal the host masters."""
    hot, warm = cache.seri.index, cache.warm.index
    if hot.emb_dev is None:
        return
    assert np.array_equal(hot.emb_dev.numpy(), hot.emb)
    assert np.array_equal(hot.active_dev.numpy(), hot.active)
    assert np.array_equal(warm.emb_q_dev.numpy(), warm.emb_q)
    assert np.array_equal(warm.scale_dev.numpy(), warm.scale)
    assert np.array_equal(warm.active_dev.numpy(), warm.active)


def _same(ref, port):
    assert _state(port) == _state(ref)
    _assert_mirrored(port)


# ------------------------------------------------------------ quant index

def _quant_indexes(n, d, cap, seed):
    rng = np.random.default_rng(seed)
    emb = _unit_rows(rng, n, d)
    ref = RefQuantIndex(cap, d, backend="numpy")
    ports = {be: QuantIndex(cap, d, backend=be, device="cpu")
             for be in BACKENDS}
    for i in range(n):
        for idx in (ref, *ports.values()):
            idx.add(i, emb[i])
    return rng, emb, ref, ports


def _assert_same_results(got, want):
    for (ids_g, sims_g), (ids_w, sims_w) in zip(got, want):
        assert ids_g == ids_w
        np.testing.assert_array_equal(sims_g, sims_w)


@pytest.mark.parametrize("backend", BACKENDS)
def test_quant_search_matches_reference_rowwise(backend):
    """Analogue of test_tiers.py:88 (numpy vs kernel, rowwise): the port's
    backends return the reference numpy path's rows and sims, bitwise."""
    rng, emb, ref, ports = _quant_indexes(300, 32, 512, seed=0)
    pick = rng.integers(0, 300, 16)
    q = emb[pick] + 0.05 * rng.standard_normal((16, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    before = ann_topk_quant.plain_calls
    want = ref.search_batch(q, 4, tau_sim=0.5)
    assert any(ids for ids, _ in want)
    _assert_same_results(ports[backend].search_batch(q, 4, tau_sim=0.5), want)
    assert ann_topk_quant.plain_calls == before + (backend == "kernel")
    assert ports[backend].last_scanned == ref.last_scanned


@pytest.mark.parametrize("backend", BACKENDS)
def test_quant_scalar_search_is_batched_row(backend):
    """Analogue of test_tiers.py:74."""
    rng, _, ref, ports = _quant_indexes(200, 32, 256, seed=3)
    q = _unit_rows(rng, 8, 32)
    batched = ports[backend].search_batch(q, 4, tau_sim=0.3)
    _assert_same_results(batched, ref.search_batch(q, 4, tau_sim=0.3))
    for i in range(8):
        ids_s, sims_s = ports[backend].search(q[i], 4, tau_sim=0.3)
        assert ids_s == batched[i][0]
        np.testing.assert_array_equal(sims_s, batched[i][1])


@pytest.mark.parametrize("backend", BACKENDS)
def test_quant_index_row_reuse_after_removal(backend):
    """Analogue of test_tiers.py:112: removal frees rows, the next add
    takes the row the reference takes, and the mirror follows."""
    rng = np.random.default_rng(5)
    emb = _unit_rows(rng, 8, 32)
    ref = RefQuantIndex(8, 32)
    port = QuantIndex(8, 32, backend=backend, device="cpu")
    rows = [(ref.add(i, emb[i]), port.add(i, emb[i])) for i in range(8)]
    assert all(a == b for a, b in rows) and port.full
    for idx in (ref, port):
        idx.remove_rows([r for r, _ in rows[:4]])
    assert len(port) == 4 and not port.full
    assert port.add(99, emb[0]) == ref.add(99, emb[0])
    np.testing.assert_array_equal(port.emb_q, ref.emb_q)
    np.testing.assert_array_equal(port.scale, ref.scale)
    np.testing.assert_array_equal(port.row_se, ref.row_se)
    if backend == "kernel":
        assert np.array_equal(port.emb_q_dev.numpy(), port.emb_q)
        assert np.array_equal(port.scale_dev.numpy(), port.scale)
        assert np.array_equal(port.active_dev.numpy(), port.active)


@pytest.mark.parametrize("backend", BACKENDS)
def test_quant_index_from_numpy_round_trip(backend):
    """The reference's warm index (free-list holes included) carried into
    the port: the same results, and the next add lands on the same row."""
    rng, emb, ref, _ = _quant_indexes(120, 32, 160, seed=6)
    ref.remove_rows([4, 77, 9])
    port = quant_index_from_numpy(ref.emb_q, ref.scale, ref.active,
                                  ref.row_se, ref._free, backend=backend,
                                  device="cpu")
    q = _unit_rows(rng, 6, 32)
    _assert_same_results(port.search_batch(q, 4, tau_sim=0.0),
                         ref.search_batch(q, 4, tau_sim=0.0))
    assert port.add(500, emb[0]) == ref.add(500, emb[0])


# -------------------------------------------------------------- lifecycle

@pytest.mark.parametrize("backend", BACKENDS)
def test_demote_then_promote_keeps_absolute_expiry(backend):
    """Analogue of test_tiers.py:126-170: LCFU victims demote (no true
    eviction), a paraphrase warm-hits and promotes with its original
    absolute expiry, on the reference and the port alike."""
    ref, port = _pair(backend, hot=500, warm=10_000, max_ttl=800.0, seed=1)
    (rw, pw), now, expiry = WORLDS, 0.0, {}
    for i in range(12):
        a = _insert(ref, rw, i, now=now)
        b = _insert(port, pw, i, now=now)
        assert (a.se_id, a.expires_at) == (b.se_id, b.expires_at)
        expiry[a.se_id] = a.expires_at
        now += 1.0
    _same(ref, port)
    assert port.tier_stats.demotions == 7 and port.stats.evictions == 0
    row = next(iter(ref.warm.soa.id2row.values()))
    intent = rw.intent_of(ref.warm.soa.key[row])
    q = rw.query(intent, 5)
    want = ref.lookup(q, rw.embed(q), now)
    got = port.lookup(q, pw.embed(q), now)
    assert want.hit and got.hit and got.se.se_id == want.se.se_id
    assert got.se.expires_at == expiry[got.se.se_id]
    np.testing.assert_array_equal(got.sims, want.sims)
    assert port.tier_stats.promotions == port.tier_stats.warm_hits == 1
    _same(ref, port)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["overflow", "oversized"])
def test_warm_overflow_and_oversized_victims(backend, case):
    """Analogues of test_tiers.py:187-211: a full warm tier truly evicts,
    and a victim too large for it drops; counts equal the reference's."""
    if case == "overflow":
        ref, port = _pair(backend, hot=200, warm=80, max_ttl=800.0, seed=3)
        n, want = 6, dict(warm_evictions=2, demotions=4)
    else:
        ref, port = _pair(backend, hot=500, warm=30, max_ttl=800.0, seed=4)
        n, want = 7, dict(demote_drops=2)
    for i in range(n):
        for cache, world in zip((ref, port), WORLDS):
            _insert(cache, world, i, now=float(i))
    _same(ref, port)
    assert port.stats.evictions == 2
    for key, value in want.items():
        assert getattr(port.tier_stats, key) == value


@pytest.mark.parametrize("backend", BACKENDS)
def test_rebind_survives_mid_batch_row_reuse(backend):
    """Analogue of test_tiers.py:266: one batch warm-hits W (its promotion
    demotes A and reuses A's row), then re-promotes A; every query binds
    the right entry on both sides."""
    ref, port = _pair(backend, hot=100, warm=10_000, max_ttl=800.0, seed=9,
                      accuracy=1.0)
    for cache, world in zip((ref, port), WORLDS):
        _insert(cache, world, 30, now=0.0)
        _insert(cache, world, 40, now=1.0)
    _same(ref, port)
    outs = []
    for cache, world in zip((ref, port), WORLDS):
        qs = [world.query(30, 1), world.query(40, 1), world.query(40, 2)]
        res = cache.lookup_batch(qs, np.stack([world.embed(q) for q in qs]),
                                 2.0)
        outs.append([(r.hit, r.se.se_id, r.se.value) for r in res])
    assert outs[1] == outs[0]
    assert [se for _, se, _ in outs[1]] == [0, 1, 1]
    _same(ref, port)


def _workload(cache, world, batched, seed):
    """test_tiers.py's _run_workload: a small hot slice under constant
    demote/promote pressure, scalar or batched."""
    rng = np.random.default_rng(seed)
    now, hits = 0.0, []
    for _ in range(40):
        now += float(rng.random() * 30)
        bs = int(rng.integers(1, 9))
        qs = [world.query(int(rng.integers(0, 120)), int(rng.integers(0, 30)))
              for _ in range(bs)]
        embs = np.stack([world.embed(q) for q in qs])
        if batched:
            results = cache.lookup_batch(qs, embs, now)
        else:
            results = [cache.lookup(q, e, now) for q, e in zip(qs, embs)]
        hits.extend(r.hit for r in results)
        misses = [(q, e) for (q, e), r in zip(zip(qs, embs), results)
                  if not r.hit]
        if batched:
            cache.insert_batch(
                [dict(query=q, q_emb=e, value=world.fetch(q), cost=0.005,
                      latency=0.4, size=world.value_size(q))
                 for q, e in misses], now=now)
        else:
            for q, e in misses:
                cache.insert(q, e, world.fetch(q), now=now, cost=0.005,
                             latency=0.4, size=world.value_size(q))
    return hits


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("batched", [False, True], ids=["scalar", "batched"])
def test_workload_matches_reference(backend, batched):
    """The tiered batched-equivalence workload (test_tiers.py:276-319) on
    the reference and the port: the same hit sequence and final state."""
    ref, port = _pair(backend, seed=11, hot=5_000, warm=5_000)
    hits = [_workload(c, w, batched, seed=11) for c, w in zip((ref, port),
                                                              WORLDS)]
    assert hits[1] == hits[0]
    assert port.tier_stats.demotions > 0 and port.tier_stats.promotions > 0
    _same(ref, port)
