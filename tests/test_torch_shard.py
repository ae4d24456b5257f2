"""The port's sharded stage 1 (DESIGN.md §13) against the JAX package's,
analogues of tests/test_mesh_shard.py.

The router's shard ownership and rebalancing are the reference's numpy
code, so the same mutation sequence must give bitwise the same cut points,
owners and migration counters. Searches run on the port's numpy backend
(bitwise the reference's) and on its kernel backend with the device
mirror on the CPU (the plain PyTorch versions of the sharded scans, fp32
sums in another order: sims within 2e-6, the reference's own
kernel-vs-numpy bar; int8 bitwise). Engine runs are held to the
reference's summaries byte for byte.
"""
import functools
import json
import math

import numpy as np
import pytest
import torch

from repro.core.clustering import _MIGRATE_CHUNK
from repro.core.clustering import ClusterConfig as RefClusterConfig
from repro.core.clustering import ClusterRouter as RefClusterRouter
from repro.core.seri import VectorIndex as RefVectorIndex
from repro.core.seri import sharded_topk_merge as ref_merge
from repro.core.seri import topk_desc as ref_topk_desc
from repro.core.tiers import QuantIndex as RefQuantIndex
from repro.data.world import SemanticWorld as RefSemanticWorld
from repro.launch.serve import main as ref_main
from repro.launch.serve import run_once as ref_run_once
from repro_torch.convert import (cluster_router_from_numpy,
                                 vector_index_from_numpy)
from repro_torch.core.clustering import ClusterConfig, ClusterRouter
from repro_torch.core.seri import VectorIndex, sharded_topk_merge
from repro_torch.core.tiers import QuantIndex
from repro_torch.kernels.ann_topk_sharded import (ann_topk_ivf_quant_sharded,
                                                  ann_topk_ivf_sharded)
from repro_torch.launch.serve import main as port_main
from repro_torch.launch.serve import run_once as port_run_once

torch.set_num_threads(1)

ATOL = 2e-6
SHARD_COUNTS = (1, 2, 8)
CLASSES = {"fp32": (RefVectorIndex, VectorIndex),
           "int8": (RefQuantIndex, QuantIndex)}
WRAPPERS = {"fp32": ann_topk_ivf_sharded, "int8": ann_topk_ivf_quant_sharded}


def _clustered_embs(n, dim, seed=0, paras=8):
    n_int = max(n // paras, 1)
    world = RefSemanticWorld(n_intents=n_int, dim=dim, seed=seed)
    return np.stack([world.embed(world.query((i // paras) % n_int, i % paras))
                     for i in range(n)])


def _cfg(shards, **kw):
    return dict(dict(n_clusters=16, nprobe=4, min_train=64, seed=3,
                     n_shards=shards), **kw)


def _build(cls, n, dim, embs, cfg, **kw):
    """cls(n + 32, dim) with a router of ``cfg`` (a dict) or none, filled
    with embs[:n]; the reference's classes get the reference's router."""
    port = cls.__module__.startswith("repro_torch")
    router = None
    if cfg:
        cc, cr = ((ClusterConfig, ClusterRouter) if port
                  else (RefClusterConfig, RefClusterRouter))
        router = cr(n + 32, dim, cc(**cfg))
    if port:
        kw.setdefault("device", "cpu")
    ix = cls(n + 32, dim, router=router, **kw)
    for i in range(n):
        ix.add(i, embs[i])
    return ix


def _queries(embs, rng, b):
    q = embs[rng.integers(0, len(embs), b)] + 0.03 * rng.standard_normal(
        (b, embs.shape[1])).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _assert_results(got, want, exact):
    for (ids_g, sims_g), (ids_w, sims_w) in zip(got, want):
        assert ids_g == ids_w
        if exact:
            np.testing.assert_array_equal(sims_g, sims_w)
        else:
            np.testing.assert_allclose(sims_g, sims_w, atol=ATOL)


def _assert_same_shards(port, ref):
    np.testing.assert_array_equal(port.centroids, ref.centroids)
    np.testing.assert_array_equal(port.assign, ref.assign)
    np.testing.assert_array_equal(port.shard_bounds, ref.shard_bounds)
    np.testing.assert_array_equal(port.shard_of, ref.shard_of)
    assert (port.refreshes, port.rebalances, port.migrated_rows,
            port.migration_chunks) == (ref.refreshes, ref.rebalances,
                                       ref.migrated_rows,
                                       ref.migration_chunks)


# --------------------------------------------------- sharded_topk_merge

def test_sharded_topk_merge_matches_reference():
    """Random and tie-heavy matrices over random owner partitions: the
    port's merge gives the reference's rows and values, which are
    topk_desc's."""
    rng = np.random.default_rng(0)
    for trial in range(40):
        b, m = int(rng.integers(1, 6)), int(rng.integers(1, 50))
        k, s_cnt = int(rng.integers(1, 12)), int(rng.integers(1, 9))
        if trial % 2:
            s = rng.choice(np.float32([-1.0, 0.25, 0.25, 0.7]), (b, m))
        else:
            s = rng.standard_normal((b, m)).astype(np.float32)
        owners = rng.integers(0, s_cnt, m)
        got = sharded_topk_merge(s, owners, s_cnt, k)
        for g, w, t in zip(got, ref_merge(s, owners, s_cnt, k),
                           ref_topk_desc(s.copy(), k)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, t)


def test_sharded_topk_merge_boundary_tie_straddle():
    """A tie group split across two shards resolves by ascending global
    column, as the reference's, and the input is left as it was."""
    s = np.array([[0.9, 0.5, 0.5, 0.5, 0.1, 0.5]], np.float32)
    owners = np.array([0, 0, 0, 1, 1, 1])
    rows, vals = sharded_topk_merge(s, owners, 2, 4)
    want_r, want_v = ref_merge(s, owners, 2, 4)
    np.testing.assert_array_equal(rows, want_r)
    np.testing.assert_array_equal(vals, want_v)
    assert rows[0].tolist() == [0, 1, 2, 3]
    assert s[0, 0] == np.float32(0.9)


# ------------------------------------------------- index-level sharding

@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_index_shard_count_invariance(kind, backend):
    """Same rows and queries at 1, 2 and 8 shards: the reference's ids and
    sims (bitwise on the numpy backend and for int8), the reference's
    rows scanned and busiest-shard share, which drops below the total."""
    ref_cls, cls = CLASSES[kind]
    n, dim, k = 600, 32, 4
    embs = _clustered_embs(n, dim, seed=1)
    q = _queries(embs, np.random.default_rng(0), 16)
    for s_cnt in SHARD_COUNTS:
        ref = _build(ref_cls, n, dim, embs, _cfg(s_cnt))
        ix = _build(cls, n, dim, embs, _cfg(s_cnt), backend=backend)
        assert ix.router.ready
        _assert_results(ix.search_batch(q, k, 0.0),
                        ref.search_batch(q, k, 0.0),
                        exact=backend == "numpy" or kind == "int8")
        assert (ix.last_scanned, ix.last_scanned_max_shard) == \
            (ref.last_scanned, ref.last_scanned_max_shard)
        assert (ix.last_scanned_max_shard < ix.last_scanned) == (s_cnt > 1)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_nprobe_all_sharded_equals_brute(backend):
    """nprobe=all at 8 shards over 4 clusters (S > C: empty shards) gives
    the brute index's ids, bitwise its sims on the numpy backend."""
    n, dim, k = 400, 32, 4
    embs = _clustered_embs(n, dim, seed=2)
    q = _queries(embs, np.random.default_rng(1), 8)
    brute = _build(VectorIndex, n, dim, embs, None, backend=backend)
    ivf = _build(VectorIndex, n, dim, embs,
                 _cfg(8, n_clusters=4, nprobe=None), backend=backend)
    assert ivf.router.ready and ivf.router.n_shards > ivf.router.cfg.n_clusters
    _assert_results(ivf.search_batch(q, k, 0.5), brute.search_batch(q, k, 0.5),
                    exact=backend == "numpy")


def test_add_batch_with_shards_matches_reference():
    """add_batch at 8 shards splits at the router's refresh points: the
    reference's rows, centroids, assignments and cut points, and the same
    search results as the reference's sequential adds."""
    n, dim, k = 700, 32, 4
    embs = _clustered_embs(n, dim, seed=5)
    cfg = _cfg(8, refresh_every=128)
    seq = _build(RefVectorIndex, n, dim, embs, cfg)
    port = VectorIndex(n + 32, dim, backend="kernel", device="cpu",
                       router=ClusterRouter(n + 32, dim, ClusterConfig(**cfg)))
    ref = RefVectorIndex(n + 32, dim, router=RefClusterRouter(
        n + 32, dim, RefClusterConfig(**cfg)))
    np.testing.assert_array_equal(port.add_batch(np.arange(n), embs),
                                  ref.add_batch(np.arange(n), embs))
    _assert_same_shards(port.router, ref.router)
    np.testing.assert_array_equal(port.router.shard_bounds,
                                  seq.router.shard_bounds)
    q = _queries(embs, np.random.default_rng(2), 8)
    _assert_results(port.search_batch(q, k, 0.0), seq.search_batch(q, k, 0.0),
                    exact=False)


def test_router_shards_match_reference_under_churn():
    """Analogue of test_mesh_shard.py:191 run on both packages side by
    side: after insert/remove churn across refreshes the port's cut
    points, owners and migration counters are bitwise the reference's,
    with at least one rebalance, and the contiguous-cut invariants hold."""
    n, dim = 400, 16
    embs = _clustered_embs(n, dim, seed=7)
    cfg = dict(n_clusters=8, nprobe=3, min_train=32, refresh_every=64,
               seed=8, n_shards=4)
    ref = RefVectorIndex(n, dim, router=RefClusterRouter(
        n, dim, RefClusterConfig(**cfg)))
    port = VectorIndex(n, dim, backend="kernel", device="cpu",
                       router=ClusterRouter(n, dim, ClusterConfig(**cfg)))
    rng = np.random.default_rng(9)
    live, nxt = [], 0
    for step in range(900):
        if live and (ref.full or rng.random() < 0.35):
            kill = rng.choice(len(live), size=min(2, len(live)),
                              replace=False)
            rows = [live[i] for i in kill]
            ref.remove_rows(rows)
            port.remove_rows(rows)
            live = [r for j, r in enumerate(live) if j not in set(kill)]
        else:
            row = ref.add(nxt, embs[nxt % n])
            assert port.add(nxt, embs[nxt % n]) == row
            live.append(row)
            nxt += 1
        if step % 150 == 0 and port.router.trained:
            _assert_same_shards(port.router, ref.router)
    rt = port.router
    _assert_same_shards(rt, ref.router)
    assert rt.refreshes >= 2 and rt.rebalances >= 1 and rt.migrated_rows > 0
    assert rt.migration_chunks >= max(rt.rebalances, math.ceil(
        rt.migrated_rows / _MIGRATE_CHUNK))
    b = rt.shard_bounds
    assert b[0] == 0 and b[-1] == cfg["n_clusters"] and np.all(np.diff(b) >= 0)
    for sh in range(rt.n_shards):
        assert np.all(rt.shard_of[b[sh]:b[sh + 1]] == sh)
    q = embs[:6]
    _assert_results(port.search_batch(q, 4, 0.0), ref.search_batch(q, 4, 0.0),
                    exact=False)
    assert (port.last_scanned, port.last_scanned_max_shard) == \
        (ref.last_scanned, ref.last_scanned_max_shard)


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_sharded_kernel_matches_numpy(kind):
    """Analogue of test_mesh_shard.py:236: the kernel backend's sharded
    scan (its plain version here) agrees with the numpy sharded path,
    which is bitwise the reference's: ids, sims, rows scanned and the
    busiest shard's share."""
    ref_cls, cls = CLASSES[kind]
    n, dim, k = 500, 32, 4
    embs = _clustered_embs(n, dim, seed=2)
    q = _queries(embs, np.random.default_rng(3), 8)
    want = _build(ref_cls, n, dim, embs, _cfg(8))
    want_res = want.search_batch(q, k, 0.0)
    np_ix = _build(cls, n, dim, embs, _cfg(8), backend="numpy")
    kr_ix = _build(cls, n, dim, embs, _cfg(8), backend="kernel")
    before = WRAPPERS[kind].plain_calls
    _assert_results(np_ix.search_batch(q, k, 0.0), want_res, exact=True)
    _assert_results(kr_ix.search_batch(q, k, 0.0), want_res,
                    exact=kind == "int8")
    assert WRAPPERS[kind].plain_calls == before + 1
    for ix in (np_ix, kr_ix):
        assert (ix.last_scanned, ix.last_scanned_max_shard) == \
            (want.last_scanned, want.last_scanned_max_shard)
    assert kr_ix.last_scanned_max_shard < kr_ix.last_scanned


@pytest.mark.parametrize("kind", sorted(CLASSES))
@pytest.mark.parametrize("n_clusters", [16, 4], ids=["c16", "c4_under_s8"])
def test_kernel_shard_buckets_match_reference(kind, n_clusters):
    """kernel_shard_buckets: shard_rows, shard_valid and the cut points
    are the reference's (S > C included); the device side is the
    unsharded layout and the cut points, cached until a mutation."""
    ref_cls, cls = CLASSES[kind]
    n, dim = 300, 32
    embs = _clustered_embs(n, dim, seed=12)
    quant = kind == "int8"
    cfg = _cfg(8, n_clusters=n_clusters)
    ref = _build(ref_cls, n, dim, embs, cfg)
    port = _build(cls, n, dim, embs, cfg, backend="kernel")
    for ix in (ref, port):
        ix.remove_rows([3, 40, 41, 200])
    _, wrows, wvalid, wbounds = ref.router.kernel_shard_buckets(ref,
                                                                quant=quant)
    sh = port.router.kernel_shard_buckets(port, quant=quant)
    np.testing.assert_array_equal(sh.shard_rows, wrows)
    np.testing.assert_array_equal(sh.shard_valid, wvalid)
    np.testing.assert_array_equal(sh.bounds, wbounds)
    assert sh.bounds.dtype == wbounds.dtype
    np.testing.assert_array_equal(sh.bounds_dev.numpy(), wbounds)
    assert sh.bounds_dev.dtype == torch.int32
    assert sh.layout is port.router.kernel_layout(port, quant=quant)
    assert port.router.kernel_shard_buckets(port, quant=quant) is sh
    port.add(999, embs[0])                        # a mutation rebuilds it
    assert port.router.kernel_shard_buckets(port, quant=quant) is not sh


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_sharded_router_carried_from_reference_continues_identically(backend):
    """cluster_router_from_numpy with n_shards > 1: a reference router's
    state, its cut points and migration counters included, carried into
    the port keeps making the reference's refreshes, re-cuts and
    assignments under further mutations."""
    n, dim = 500, 16
    embs = _clustered_embs(n, dim, seed=11)
    cfg = dict(n_clusters=8, nprobe=3, min_train=32, refresh_every=64,
               seed=2, n_shards=4)
    ref = RefVectorIndex(n, dim, router=RefClusterRouter(
        n, dim, RefClusterConfig(**cfg)))
    rng = np.random.default_rng(4)
    order = rng.permutation(n)
    for i in order[:250]:
        ref.add(int(i), embs[i])
    rt = ref.router
    assert rt.rebalances >= 1
    router = cluster_router_from_numpy(
        ClusterConfig(**cfg), rt.capacity, centroids=rt.centroids,
        counts=rt.counts, assign=rt.assign, members=rt._member_lists,
        rng_state=rt.rng.bit_generator.state, muts=rt._muts,
        mb_counts=rt._mb_counts, trained=rt.trained, refreshes=rt.refreshes,
        shard_bounds=rt.shard_bounds, rebalances=rt.rebalances,
        migrated_rows=rt.migrated_rows, migration_chunks=rt.migration_chunks)
    _assert_same_shards(router, rt)
    port = vector_index_from_numpy(ref.emb, ref.active, ref.row_se,
                                   ref._free, backend=backend, device="cpu",
                                   router=router)
    for i in order[250:450]:
        assert port.add(int(i), embs[i]) == ref.add(int(i), embs[i])
    for idx in (ref, port):
        idx.remove_rows(list(range(0, 60, 3)))
    assert port.router.refreshes > router.refreshes - 1 > 0
    _assert_same_shards(port.router, ref.router)
    q = _queries(embs, np.random.default_rng(3), 6)
    _assert_results(port.search_batch(q, 4, 0.0), ref.search_batch(q, 4, 0.0),
                    exact=backend == "numpy")
    with pytest.raises(ValueError, match="shard bounds"):
        cluster_router_from_numpy(
            ClusterConfig(**cfg), rt.capacity, centroids=rt.centroids,
            counts=rt.counts, assign=rt.assign, members=rt._member_lists,
            rng_state=rt.rng.bit_generator.state, muts=rt._muts,
            mb_counts=rt._mb_counts, trained=rt.trained,
            shard_bounds=[0, 8])


# ----------------------------------------------------- engine / cache

# tests/test_mesh_shard.py:286-288
ENGINE_KW = dict(workload="zipf", mode="cortex", n_requests=600,
                 n_intents=300, dim=32, concurrency=4, seed=21,
                 cache_ratio=0.9, cluster=True, n_clusters=8, nprobe=4)
TIERS = {"one_tier": {}, "warm": {"warm_frac": 0.5}}


@functools.lru_cache(maxsize=None)
def _reference(shards: int, tiers: str) -> str:
    return json.dumps(ref_run_once(shards=shards, **ENGINE_KW, **TIERS[tiers]),
                      sort_keys=True)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("tiers", sorted(TIERS))
@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_run_once_matches_reference_across_shard_counts(shards, tiers,
                                                        backend):
    """Analogue of test_mesh_shard.py:299: the port's summary equals the
    reference's byte for byte at 1, 2 and 8 shards, one tier or two, on
    both backends; at 8 shards the kernel backend reaches the sharded
    scan (its plain version)."""
    before = ann_topk_ivf_sharded.plain_calls
    got = port_run_once(shards=shards, backend=backend, device="cpu",
                        **ENGINE_KW, **TIERS[tiers])
    assert json.dumps(got, sort_keys=True) == _reference(shards, tiers)
    if shards > 1:
        assert got["stage1_shards"] == shards
    reached = ann_topk_ivf_sharded.plain_calls > before
    assert reached == (backend == "kernel" and shards > 1
                       and tiers == "one_tier")


def test_tiered_clustered_sharded_run_matches_reference():
    """Run (c) of PERF.md §4 at 8 shards on the kernel backend: both
    routers train and rebalance, the fp32 and the int8 sharded scans run
    (their plain versions), and the summary is the reference's byte for
    byte."""
    kw = dict(workload="longtail", n_intents=3000, n_requests=3000,
              tail_len=2800, concurrency=16, cache_ratio=0.3, warm_frac=0.5,
              cluster=True, shards=8)
    before = (ann_topk_ivf_sharded.plain_calls,
              ann_topk_ivf_quant_sharded.plain_calls)
    got = port_run_once(backend="kernel", device="cpu", **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(ref_run_once(**kw),
                                                         sort_keys=True)
    assert ann_topk_ivf_sharded.plain_calls > before[0]
    assert ann_topk_ivf_quant_sharded.plain_calls > before[1]
    assert got["shard_rebalances"] >= 1
    assert got["rows_scanned_max_shard"] < got["rows_scanned"]


def test_cache_contents_invariant_across_shard_counts():
    """Analogue of test_mesh_shard.py:318 on the kernel backend: hit
    decisions, the id→row map, the stored embeddings and the evictions at
    8 shards equal the port's at 1 shard and the reference's at 8, while
    the router rebalances and migrates underneath."""
    from repro.core.cache import make_cache as ref_make_cache
    from repro.core.judge import OracleJudge as RefOracleJudge
    from repro_torch.core.cache import make_cache
    from repro_torch.core.judge import OracleJudge
    from repro_torch.data.world import SemanticWorld

    def drive(shards, port):
        cc = ClusterConfig if port else RefClusterConfig
        cfg = cc(n_clusters=16, nprobe=4, min_train=32, refresh_every=64,
                 seed=11, n_shards=shards)
        if port:
            world = SemanticWorld(n_intents=120, dim=32, seed=9)
            cache = make_cache(capacity_bytes=80_000, dim=32,
                               judge=OracleJudge(world, accuracy=1.0,
                                                 seed=10),
                               index_capacity=512, cluster=cfg,
                               backend="kernel", device="cpu")
        else:
            world = RefSemanticWorld(n_intents=120, dim=32, seed=9)
            cache = ref_make_cache(capacity_bytes=80_000, dim=32,
                                   judge=RefOracleJudge(world, accuracy=1.0,
                                                        seed=10),
                                   index_capacity=512, cluster=cfg)
        rng = np.random.default_rng(12)
        decisions, now = [], 0.0
        for _ in range(500):
            iid = int(rng.zipf(1.3)) % 120
            q = world.query(iid, int(rng.integers(0, 4)))
            emb = world.embed(q)
            res = cache.lookup(q, emb, now)
            decisions.append(bool(res.hit))
            if not res.hit:
                cache.insert(q, emb, world.answer(q), now=now, cost=0.01,
                             latency=0.2, size=int(world.value_size(q)),
                             staticity=world.staticity(q))
            now += 0.25
        ix = cache.seri.index
        return (decisions, sorted(cache.soa.id2row.items()),
                ix.emb[ix.active].tobytes(), cache.stats.evictions), \
            ix.router

    one, _ = drive(1, port=True)
    assert one[3] > 0                         # eviction churn ran
    eight, rt = drive(8, port=True)
    want, ref_rt = drive(8, port=False)
    assert eight == one == want
    assert rt.rebalances >= 1 and rt.migrated_rows > 0
    _assert_same_shards(rt, ref_rt)


def test_engine_max_over_shards_latency():
    """Analogue of test_mesh_shard.py:365 on the kernel backend: with
    t_cache_per_row and t_shard_merge the 8-shard run charges the busiest
    shard's rows, so its cache time drops below the unsharded run's; both
    summaries are the reference's byte for byte."""
    kw = dict(workload="zipf", mode="cortex", n_requests=800,
              n_intents=400, dim=32, concurrency=1, seed=21,
              cache_ratio=0.9, cluster=True, n_clusters=16, nprobe=4,
              t_cache_per_row=2e-5)
    flat = port_run_once(backend="kernel", device="cpu", **kw)
    shard = port_run_once(shards=8, t_shard_merge=1e-4, backend="kernel",
                          device="cpu", **kw)
    assert json.dumps(shard, sort_keys=True) == json.dumps(
        ref_run_once(shards=8, t_shard_merge=1e-4, **kw), sort_keys=True)
    assert shard["rows_scanned"] == flat["rows_scanned"]
    assert shard["hit_rate"] == flat["hit_rate"]
    assert shard["rows_scanned_max_shard"] < shard["rows_scanned"]
    assert shard["cache_time_mean"] < flat["cache_time_mean"]
    assert shard["latency_mean"] < flat["latency_mean"]


def test_cli_shards_and_merge_cost_match_reference(capsys):
    """``--shards 8 --t-shard-merge 1e-4`` (which implies the router) on
    the port's kernel backend prints the reference's summary."""
    args = ["--n-requests", "300", "--shards", "8", "--t-shard-merge",
            "1e-4", "--t-cache-per-row", "2e-5", "--concurrency", "4"]
    ref_main(args)
    want = capsys.readouterr().out
    port_main(args + ["--backend", "kernel", "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert json.loads(got)["stage1_shards"] == 8
