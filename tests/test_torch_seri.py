"""The port's stage-1 index and SoA store against the JAX package's.

The port's ``VectorIndex`` runs here with ``backend="kernel",
device="cpu"`` (the kernel's plain PyTorch version over a CPU-resident
mirror) and with ``backend="numpy"``; the reference is
``repro.core.seri.VectorIndex`` on its numpy backend. Rows are identical
and sims within 2e-5 (fp32 sums in another order); the numpy backends are
bit-identical.
"""
import numpy as np
import pytest
import torch

from repro.core import seri as ref_seri
from repro.core.se_store import SEStore as RefSEStore
from repro.core.seri import VectorIndex as RefVectorIndex
from repro_torch.convert import vector_index_from_numpy
from repro_torch.core import seri as port_seri
from repro_torch.core.se_store import SEStore
from repro_torch.core.seri import VectorIndex
from repro_torch.kernels.ann_topk import ann_topk

torch.set_num_threads(1)

ATOL = 2e-5


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _filled(n=300, d=32, cap=512, seed=0):
    rng = np.random.default_rng(seed)
    emb = _unit(rng.standard_normal((n, d)))
    ref = RefVectorIndex(cap, d, backend="numpy")
    ports = {be: VectorIndex(cap, d, backend=be, device="cpu")
             for be in ("numpy", "kernel")}
    for i in range(n):
        ref.add(i, emb[i])
        for idx in ports.values():
            idx.add(i, emb[i])
    pick = rng.integers(0, n, 16)
    q = _unit(emb[pick] + 0.05 * rng.standard_normal((16, d)))
    return emb, ref, ports, q


def _assert_same(res_a, res_b, exact: bool):
    for (ids_a, sims_a), (ids_b, sims_b) in zip(res_a, res_b):
        assert ids_a == ids_b
        if exact:
            np.testing.assert_array_equal(sims_a, sims_b)
        else:
            np.testing.assert_allclose(sims_a, sims_b, atol=ATOL)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_stage1_matches_reference_rowwise(backend):
    """Analogue of test_soa_batch's numpy-vs-Pallas row check: the port's
    backends return the reference's rows in the reference's order."""
    _, ref, ports, q = _filled()
    before = ann_topk.plain_calls
    res_ref = ref.search_batch(q, 4, tau_sim=0.5)
    res = ports[backend].search_batch(q, 4, tau_sim=0.5)
    assert any(ids for ids, _ in res_ref)
    _assert_same(res, res_ref, exact=backend == "numpy")
    assert ann_topk.plain_calls == before + (backend == "kernel")
    assert ports[backend].last_scanned == ref.last_scanned


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_scalar_search_is_the_batched_path(backend):
    _, _, ports, q = _filled(seed=1)
    idx = ports[backend]
    batched = idx.search_batch(q, 4, tau_sim=0.5)
    for i in range(len(q)):
        ids, sims = idx.search(q[i], 4, tau_sim=0.5)
        assert ids == batched[i][0]
        np.testing.assert_allclose(sims, batched[i][1], atol=ATOL)


def test_device_mirror_follows_every_write_site():
    """add, add_batch, remove_rows (and the _alloc/_clear_rows under them)
    keep emb_dev/active_dev equal to the host master."""
    rng = np.random.default_rng(2)
    d = 16
    idx = VectorIndex(64, d, backend="kernel", device="cpu")

    def mirrored():
        return (np.array_equal(idx.emb_dev.numpy(), idx.emb)
                and np.array_equal(idx.active_dev.numpy(), idx.active))

    for i in range(10):
        idx.add(i, _unit(rng.standard_normal(d)))
    assert mirrored()
    idx.remove_rows([3, 7, 8])
    assert mirrored() and not idx.active[[3, 7, 8]].any()
    rows = idx.add_batch(np.arange(100, 120), _unit(rng.standard_normal((20, d))))
    assert mirrored() and set(rows.tolist()) >= {3, 7, 8}
    idx.remove_rows(rows[::2])
    assert mirrored()
    assert VectorIndex(8, d, backend="numpy", device="cpu").emb_dev is None


@pytest.mark.parametrize("policy", ["lcfu", "lru", "lfu"])
def test_victim_order_matches_reference(policy):
    """The port's SoA store picks the reference's victims in the same
    order, ties included, for count- and byte-targeted selection."""
    rng = np.random.default_rng(1)
    stores = (RefSEStore(128), SEStore(128))
    now = 1000.0
    for i in range(100):
        kw = dict(
            key=f"k{i}", value=None, staticity=int(rng.integers(1, 11)),
            cost=float(rng.choice([0.0, 0.005, 0.5])),
            latency=float(rng.choice([0.05, 0.4, 2.0])),
            size=int(rng.choice([50, 100, 100, 200])), created_at=0.0,
            expires_at=float(rng.choice([500.0, 2000.0, 3000.0])),
            freq=int(rng.choice([0, 0, 1, 2, 7])),
            last_access=float(rng.integers(0, 5) * 100),
            prefetched=False, intent=None,
        )
        for st in stores:
            st.add(i, i, **kw)
    ref, port = stores
    for n in (1, 5, 33, 100):
        assert list(port.victim_rows(now, policy, n=n)) == \
            list(ref.victim_rows(now, policy, n=n))
    need = int(ref.size[ref.active].sum() * 0.3)
    assert list(port.victim_rows(now, policy, need_bytes=need)) == \
        list(ref.victim_rows(now, policy, need_bytes=need))


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_vector_index_from_numpy_round_trip(backend):
    """The reference's index state (holes in the free-list included) carried
    into the port: the same search results, and the next add lands on the
    row the reference picks."""
    emb, ref, _, q = _filled(n=200, seed=3)
    ref.remove_rows([5, 150, 17, 99])
    port = vector_index_from_numpy(ref.emb, ref.active, ref.row_se,
                                   ref._free, backend=backend, device="cpu")
    _assert_same(port.search_batch(q, 4, tau_sim=0.5),
                 ref.search_batch(q, 4, tau_sim=0.5),
                 exact=backend == "numpy")
    for se_id in (1000, 1001):
        assert port.add(se_id, emb[0]) == ref.add(se_id, emb[0])
    assert len(port) == len(ref)
    if backend == "kernel":
        assert np.array_equal(port.emb_dev.numpy(), port.emb)
        assert np.array_equal(port.active_dev.numpy(), port.active)


@pytest.mark.parametrize("k", [1, 4, 9])
def test_selection_helpers_match_reference(k):
    """topk_desc, topk_desc_stable and sharded_topk_merge on tie-heavy
    scores (few distinct values) give the reference's rows and values."""
    rng = np.random.default_rng(k)
    s = rng.integers(0, 6, (5, 40)).astype(np.float32) / 5.0
    r_ref, v_ref = ref_seri.topk_desc(s.copy(), k)
    r, v = port_seri.topk_desc(s.copy(), k)
    np.testing.assert_array_equal(r, r_ref)
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(port_seri.topk_desc_stable(s[0], k),
                                  ref_seri.topk_desc_stable(s[0], k))
    owners = rng.integers(0, 3, 40)
    for got, want in zip(port_seri.sharded_topk_merge(s, owners, 3, k),
                         ref_seri.sharded_topk_merge(s, owners, 3, k)):
        np.testing.assert_array_equal(got, want)


def test_cluster_router_is_not_ported_yet():
    """The clustered router is ported; its sharded form is not yet on the
    kernel backend (ROADMAP slice "Sharded stage 1")."""
    from repro_torch.core.clustering import ClusterConfig, ClusterRouter

    rng = np.random.default_rng(4)
    cfg = ClusterConfig(n_clusters=4, nprobe=2, min_train=16, n_shards=2)
    idx = VectorIndex(64, 8, backend="kernel", device="cpu",
                      router=ClusterRouter(64, 8, cfg))
    for i in range(32):
        idx.add(i, _unit(rng.standard_normal(8)))
    assert idx.router.ready
    with pytest.raises(NotImplementedError, match="Sharded stage 1"):
        idx.search_batch(_unit(rng.standard_normal((2, 8))), 4, 0.0)


def test_unknown_backend_is_refused():
    with pytest.raises(ValueError):
        VectorIndex(8, 4, backend="pallas", device="cpu")
