"""The port's clustered stage 1 (``repro_torch.core.clustering``) against
the JAX package's, analogues of tests/test_clustering.py.

The router is the reference's numpy code, so the same mutation sequence
must give bitwise the same centroids, assignments, counts and member
lists. Searches run on the port's numpy backend (bitwise the reference's)
and on its kernel backend with the device mirror on the CPU (the plain
PyTorch versions of ``ann_topk_ivf``/``ann_topk_ivf_quant``, fp32 sums in
another order: sims within 2e-6, the reference's own kernel-vs-numpy bar).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.clustering import ClusterConfig as RefClusterConfig
from repro.core.clustering import ClusterRouter as RefClusterRouter
from repro.core.seri import VectorIndex as RefVectorIndex
from repro.core.tiers import QuantIndex as RefQuantIndex
from repro.data.world import SemanticWorld as RefSemanticWorld
from repro_torch.convert import cluster_router_from_numpy
from repro_torch.core.clustering import ClusterConfig, ClusterRouter
from repro_torch.core.seri import VectorIndex
from repro_torch.core.tiers import QuantIndex
from repro_torch.kernels.ann_topk_ivf import ann_topk_ivf, ann_topk_ivf_quant

torch.set_num_threads(1)

ATOL = 2e-6
CFG_ALL = dict(n_clusters=16, nprobe=None, min_train=64, seed=3)
CFG_SUB = dict(n_clusters=16, nprobe=4, min_train=64, seed=3)
CLASSES = {"fp32": (RefVectorIndex, VectorIndex),
           "int8": (RefQuantIndex, QuantIndex)}


def _clustered_embs(n, dim, seed=0, paras=8):
    world = RefSemanticWorld(n_intents=max(n // paras, 1), dim=dim, seed=seed)
    n_int = max(n // paras, 1)
    return np.stack([world.embed(world.query((i // paras) % n_int, i % paras))
                     for i in range(n)])


def _build(cls, n, dim, embs, cfg, **kw):
    """cls(n + 32, dim) with a router of ``cfg`` (a dict) or none, filled
    with embs[:n]; the reference's classes get ClusterConfig from the
    reference, the port's from the port."""
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


def _assert_same_router(port, ref):
    np.testing.assert_array_equal(port.centroids, ref.centroids)
    np.testing.assert_array_equal(port.assign, ref.assign)
    np.testing.assert_array_equal(port.counts, ref.counts)
    assert port._member_lists == ref._member_lists
    assert (port.trained, port.refreshes, port._muts) == \
        (ref.trained, ref.refreshes, ref._muts)


def _router_invariants(ix):
    """tests/test_clustering.py's free-list contract: assignments
    partition the active rows, counts match, members() is consistent."""
    rt = ix.router
    active = np.flatnonzero(ix.active)
    assert np.array_equal(active, np.flatnonzero(rt.assign >= 0))
    counts = np.bincount(rt.assign[active], minlength=rt.cfg.n_clusters)
    assert np.array_equal(counts, rt.counts)
    mem = rt.members()
    flat = np.sort(np.concatenate([m for m in mem if len(m)]))
    assert np.array_equal(flat, active)
    for c, m in enumerate(mem):
        assert np.all(rt.assign[m] == c)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_nprobe_all_parity_with_brute(kind, backend):
    """Analogue of test_clustering.py:46: probing every cluster gives the
    brute-force ids (and on the numpy backend bitwise the sims); both are
    the reference's."""
    ref_cls, cls = CLASSES[kind]
    n, dim, k = 600, 32, 4
    embs = _clustered_embs(n, dim, seed=1)
    q = _queries(embs, np.random.default_rng(0), 16)
    ref = _build(ref_cls, n, dim, embs, None).search_batch(q, k, 0.5)
    brute = _build(cls, n, dim, embs, None, backend=backend)
    ivf = _build(cls, n, dim, embs, CFG_ALL, backend=backend)
    assert ivf.router.ready
    _assert_results(ivf.search_batch(q, k, 0.5), brute.search_batch(q, k, 0.5),
                    exact=backend == "numpy")
    _assert_results(ivf.search_batch(q, k, 0.5), ref,
                    exact=backend == "numpy" or kind == "int8")


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_routed_kernel_matches_numpy(kind):
    """Analogue of test_clustering.py:65: the kernel backend's routed scan
    (routing through ann_topk, the bucket scan through the routed-scan
    kernel's plain version) agrees with the numpy routed path, which is
    bitwise the reference's."""
    ref_cls, cls = CLASSES[kind]
    n, dim, k = 500, 32, 4
    embs = _clustered_embs(n, dim, seed=2)
    q = _queries(embs, np.random.default_rng(1), 8)
    want = _build(ref_cls, n, dim, embs, CFG_SUB).search_batch(q, k, 0.0)
    np_ix = _build(cls, n, dim, embs, CFG_SUB, backend="numpy")
    kr_ix = _build(cls, n, dim, embs, CFG_SUB, backend="kernel")
    wrapper = ann_topk_ivf if kind == "fp32" else ann_topk_ivf_quant
    before = wrapper.plain_calls
    _assert_results(np_ix.search_batch(q, k, 0.0), want, exact=True)
    _assert_results(kr_ix.search_batch(q, k, 0.0), want,
                    exact=kind == "int8")
    assert wrapper.plain_calls == before + 1
    assert kr_ix.last_scanned == np_ix.last_scanned


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_scalar_equals_batch_routed(kind, backend):
    """Analogue of test_clustering.py:104."""
    _, cls = CLASSES[kind]
    n, dim, k = 400, 32, 4
    embs = _clustered_embs(n, dim, seed=6)
    ivf = _build(cls, n, dim, embs, CFG_SUB, backend=backend)
    q = _queries(embs, np.random.default_rng(2), 8)
    batched = ivf.search_batch(q, k, 0.0)
    for i in range(8):
        ids_s, sims_s = ivf.search(q[i], k, 0.0)
        assert ids_s == batched[i][0]
        np.testing.assert_allclose(sims_s, batched[i][1], atol=ATOL)


def test_router_state_matches_reference_under_churn():
    """Analogue of test_clustering.py:138, run on the reference and the
    port side by side: after every step of insert/remove churn across
    several refreshes the port's router (centroids, assign, counts,
    member lists) is bitwise the reference's, and the free-list
    invariants hold; the kernel backend's routed search still agrees."""
    n, dim = 300, 16
    embs = _clustered_embs(n, dim, seed=7)
    cfg = dict(n_clusters=8, nprobe=3, min_train=32, refresh_every=64, seed=8)
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
            rows = [live[i][1] for i in kill]
            ref.remove_rows(rows)
            port.remove_rows(rows)
            live = [e for j, e in enumerate(live) if j not in set(kill)]
        else:
            row = ref.add(nxt, embs[nxt % n])
            assert port.add(nxt, embs[nxt % n]) == row
            live.append((nxt, row))
            nxt += 1
        if step % 137 == 0 and port.router.ready:
            _router_invariants(port)
            _assert_same_router(port.router, ref.router)
    assert port.router.refreshes >= 2
    _router_invariants(port)
    _assert_same_router(port.router, ref.router)
    assert np.array_equal(port.emb_dev.numpy(), port.emb)
    _assert_results(port.search_batch(embs[:4], 4, 0.0),
                    ref.search_batch(embs[:4], 4, 0.0), exact=False)


def test_add_batch_matches_reference_router():
    """VectorIndex.add_batch stays scalar until the router trains, then
    allocates in refresh-bounded blocks: rows, router state and mirror
    equal the reference's."""
    n, dim = 700, 16
    embs = _clustered_embs(n, dim, seed=10)
    cfg = dict(n_clusters=8, nprobe=3, min_train=64, refresh_every=128,
               seed=1)
    ref = RefVectorIndex(n, dim, router=RefClusterRouter(
        n, dim, RefClusterConfig(**cfg)))
    port = VectorIndex(n, dim, backend="kernel", device="cpu",
                       router=ClusterRouter(n, dim, ClusterConfig(**cfg)))
    for lo, hi in ((0, 50), (50, 400), (400, 700)):
        want = ref.add_batch(np.arange(lo, hi), embs[lo:hi])
        np.testing.assert_array_equal(
            port.add_batch(np.arange(lo, hi), embs[lo:hi]), want)
    assert port.router.refreshes >= 3
    _assert_same_router(port.router, ref.router)
    assert np.array_equal(port.emb_dev.numpy(), port.emb)
    assert np.array_equal(port.active_dev.numpy(), port.active)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_router_carried_from_reference_continues_identically(backend):
    """cluster_router_from_numpy: a reference router's state (rng
    included) carried into the port keeps making the reference's
    refreshes and assignments under further mutations."""
    from repro_torch.convert import vector_index_from_numpy

    n, dim = 400, 16
    embs = _clustered_embs(n, dim, seed=11)
    cfg = dict(n_clusters=8, nprobe=3, min_train=32, refresh_every=64,
               seed=2)
    ref = RefVectorIndex(n, dim, router=RefClusterRouter(
        n, dim, RefClusterConfig(**cfg)))
    for i in range(200):
        ref.add(i, embs[i])
    rt = ref.router
    router = cluster_router_from_numpy(
        ClusterConfig(**cfg), rt.capacity, centroids=rt.centroids,
        counts=rt.counts, assign=rt.assign, members=rt._member_lists,
        rng_state=rt.rng.bit_generator.state, muts=rt._muts,
        mb_counts=rt._mb_counts, trained=rt.trained, refreshes=rt.refreshes)
    port = vector_index_from_numpy(ref.emb, ref.active, ref.row_se,
                                   ref._free, backend=backend, device="cpu",
                                   router=router)
    for i in range(200, 350):
        assert port.add(i, embs[i]) == ref.add(i, embs[i])
    for idx in (ref, port):
        idx.remove_rows(list(range(0, 60, 3)))
    assert port.router.refreshes > 1
    _assert_same_router(port.router, ref.router)
    q = _queries(embs, np.random.default_rng(3), 6)
    _assert_results(port.search_batch(q, 4, 0.0), ref.search_batch(q, 4, 0.0),
                    exact=backend == "numpy")


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_kernel_layout_matches_reference_buckets(kind):
    """kernel_layout: the host row map is the one the reference's
    kernel_buckets builds, and the payload gathered from the device mirror
    equals the reference's host (C, cap, D) layout."""
    ref_cls, cls = CLASSES[kind]
    n, dim = 300, 32
    embs = _clustered_embs(n, dim, seed=12)
    quant = kind == "int8"
    ref = _build(ref_cls, n, dim, embs, CFG_SUB)
    port = _build(cls, n, dim, embs, CFG_SUB, backend="kernel")
    for ix in (ref, port):
        ix.remove_rows([3, 40, 41, 200])
    (wp, wrows, wvalid) = ref.router.kernel_buckets(ref, quant=quant)
    lay = port.router.kernel_layout(port, quant=quant)
    np.testing.assert_array_equal(lay.bucket_rows.numpy(), wrows)
    np.testing.assert_array_equal(lay.bucket_valid.numpy(), wvalid > 0)
    gp = lay.payload
    for g, w in zip(gp if quant else (gp,), wp if quant else (wp,)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert port.router.kernel_layout(port, quant=quant) is lay   # cached
    port.add(999, embs[0])                        # a mutation rebuilds it
    assert port.router.kernel_layout(port, quant=quant) is not lay


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_tiered_lifecycle_with_clustered_tiers(kind):
    """Analogue of test_clustering.py:169 on the reference and the port's
    kernel backend: the same lookups and inserts through a tiered cache
    with routers on both tiers give the same hits, tier stats and router
    states, and both routers keep their invariants. The tiers are larger
    than the reference test's, so that both routers train."""
    from repro.core.judge import OracleJudge as RefOracleJudge
    from repro.core.tiers import make_tiered_cache as ref_make
    from repro_torch.core.judge import OracleJudge
    from repro_torch.core.tiers import make_tiered_cache
    from repro_torch.data.world import SemanticWorld

    cfg = dict(n_clusters=8, nprobe=None if kind == "fp32" else 3,
               min_train=16, refresh_every=48, seed=11)
    worlds = (RefSemanticWorld(n_intents=120, dim=32, seed=9),
              SemanticWorld(n_intents=120, dim=32, seed=9))
    caches = (
        ref_make(hot_bytes=20000, warm_bytes=20000, dim=32,
                 judge=RefOracleJudge(worlds[0], accuracy=1.0, seed=10),
                 index_capacity=512, cluster=RefClusterConfig(**cfg),
                 tau_sim=0.85),
        make_tiered_cache(hot_bytes=20000, warm_bytes=20000, dim=32,
                          judge=OracleJudge(worlds[1], accuracy=1.0, seed=10),
                          index_capacity=512, cluster=ClusterConfig(**cfg),
                          tau_sim=0.85, backend="kernel", device="cpu"))
    hits = ([], [])
    for cache, world, out in zip(caches, worlds, hits):
        rng = np.random.default_rng(12)
        now = 0.0
        for _ in range(400):
            iid = int(rng.integers(0, 120))
            q = world.query(iid, int(rng.integers(0, 4)))
            emb = world.embed(q)
            res = cache.lookup(q, emb, now)
            out.append((res.hit, res.se.se_id if res.hit else None))
            if not res.hit:
                cache.insert(q, emb, world.answer(q), now=now, cost=0.01,
                             latency=0.2, size=int(world.value_size(q)),
                             staticity=world.staticity(q), intent=iid)
            now += 0.25
    ref, port = caches
    assert hits[1] == hits[0]
    assert dataclasses.asdict(port.tier_stats) == \
        dataclasses.asdict(ref.tier_stats)
    assert port.tier_stats.demotions > 0 and port.tier_stats.promotions > 0
    for pix, rix in ((port.seri.index, ref.seri.index),
                     (port.warm.index, ref.warm.index)):
        assert pix.router.ready
        _router_invariants(pix)
        _assert_same_router(pix.router, rix.router)
    assert port.rows_scanned == ref.rows_scanned > 0


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_nprobe_all_parity_with_duplicate_ties(kind):
    """Analogue of test_clustering.py:313: exact duplicates tying at the
    k boundary, free-list holes in the layout; the lowest rows win."""
    ref_cls, cls = CLASSES[kind]
    rng = np.random.default_rng(13)
    dim, k, cap = 16, 4, 64
    dup = rng.standard_normal(dim).astype(np.float32)
    dup /= np.linalg.norm(dup)
    embs = []
    for i in range(24):
        e = dup if 5 <= i <= 10 else rng.standard_normal(dim).astype(
            np.float32)
        embs.append(e / np.linalg.norm(e))
    cfg = dict(n_clusters=4, nprobe=None, min_train=8, seed=1)
    out = []
    for ix in (ref_cls(cap, dim),
               cls(cap, dim, backend="numpy", device="cpu"),
               cls(cap, dim, backend="numpy", device="cpu",
                   router=ClusterRouter(cap, dim, ClusterConfig(**cfg))),
               cls(cap, dim, backend="kernel", device="cpu",
                   router=ClusterRouter(cap, dim, ClusterConfig(**cfg)))):
        for i, e in enumerate(embs):
            ix.add(i, e)
        ix.remove_rows([2, 12, 20])
        if ix.router is not None:
            ix.router.refresh(ix)
        out.append(ix.search(dup, k, 0.0))
    for ids, sims in out[1:]:
        assert ids == out[0][0]
        np.testing.assert_allclose(sims, out[0][1], atol=ATOL)
    np.testing.assert_array_equal(out[2][1], out[0][1])
    assert out[0][0][:3] == [5, 6, 7]


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_routed_kernel_duplicate_tie_order_matches_numpy(kind):
    """Analogue of test_clustering.py:344: same-cluster duplicates
    inserted out of row order (and a recycled low row) come out in
    ascending row order on the kernel backend, as on numpy."""
    _, cls = CLASSES[kind]
    rng = np.random.default_rng(14)
    dim, k, cap = 16, 4, 96
    dup = rng.standard_normal(dim).astype(np.float32)
    dup /= np.linalg.norm(dup)
    embs = []
    for i in range(40):
        e = dup if i in (7, 21, 33) else rng.standard_normal(dim).astype(
            np.float32)
        embs.append(e / np.linalg.norm(e))
    cfg = dict(n_clusters=4, nprobe=2, min_train=8, seed=2)
    res = []
    for backend in ("numpy", "kernel"):
        ix = cls(cap, dim, backend=backend, device="cpu",
                 router=ClusterRouter(cap, dim, ClusterConfig(**cfg)))
        for i, e in enumerate(embs):
            ix.add(i, e)
        ix.remove_rows([2])
        ix.add(40, dup)
        res.append(ix.search(dup, k, 0.0))
    (ids_n, sims_n), (ids_k, sims_k) = res
    assert ids_n == ids_k and ids_n[:4] == [40, 7, 21, 33]   # 40 in row 2
    np.testing.assert_allclose(sims_n, sims_k, atol=ATOL)

