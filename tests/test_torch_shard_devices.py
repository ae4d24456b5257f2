"""Stage 1 with one shard's bucket range per device (the reference's
``shard_map`` mode, DESIGN.md §13): ``kernels/ann_topk_sharded``'s
``*_parts`` scans over ``ClusterRouter.kernel_shard_buckets``' per-device
slices, against the one-device path and against the reference's
``shard_map`` path.

The CPU has no second CUDA device, so the per-device code runs here with
the dispatch rule (``clustering.shard_devices``) patched to give S ``cpu``
devices (the plain versions). It must give
stacks, search results and run summaries bitwise equal to the one-device
path's, fp32 and int8, at S in {2, 4, 8}, empty shards and S > C
included. The reference's mesh path runs in a subprocess on 8 forced XLA
host devices (the pattern of tests/test_pipeline.py), at
tests/test_mesh_shard.py:261's config: ids equal, sims within 2e-6 (fp32
sums in another order, the reference's own kernel-vs-numpy bar). There
``jax.shard_map`` is called with ``check_vma=False``, as the reference's
``shard_map_compat`` turns the replication check off on the older API: a
Pallas body's outputs carry no varying-axes annotation.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import clustering
from repro_torch.core.clustering import ClusterConfig, ClusterRouter
from repro_torch.core.seri import VectorIndex
from repro_torch.core.tiers import QuantIndex, quantize_rows
from repro_torch.kernels import ann_topk_sharded as aks
from repro_torch.kernels.ops import _route
from repro_torch.launch import mesh
from repro_torch.launch.serve import run_once

torch.set_num_threads(1)

CPU = torch.device("cpu")
CLASSES = {"fp32": VectorIndex, "int8": QuantIndex}


def _embs(n, dim, seed):
    from repro.data.world import SemanticWorld

    paras = 8
    n_int = max(n // paras, 1)
    world = SemanticWorld(n_intents=n_int, dim=dim, seed=seed)
    return np.stack([world.embed(world.query((i // paras) % n_int, i % paras))
                     for i in range(n)])


def _cpus(n, dev):
    """The dispatch rule on a host with one CPU "device" per shard."""
    return [CPU] * n if n > 1 else None


def _index(kind, n, dim, embs, shards, n_clusters=16):
    cfg = ClusterConfig(n_clusters=n_clusters, nprobe=4, min_train=64,
                        seed=3, n_shards=shards)
    router = ClusterRouter(n + 32, dim, cfg)
    ix = CLASSES[kind](n + 32, dim, backend="kernel", router=router,
                       device="cpu")
    for i in range(n):
        ix.add(i, embs[i])
    return ix


def _queries(embs, b, seed=3):
    rng = np.random.default_rng(seed)
    q = embs[rng.integers(0, len(embs), b)] + 0.03 * rng.standard_normal(
        (b, embs.shape[1])).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _stacks(ix, kind, q, parts):
    """The (S, B, nprobe, k) stacks of one search: over the whole layout,
    or per device over ``parts``."""
    rt = ix.router
    sh = rt.kernel_shard_buckets(ix, quant=kind == "int8")
    lay = sh.layout
    qt = torch.from_numpy(q)
    sel, en = _route(lay.centroids, lay.live, qt, 4)
    if kind == "fp32":
        if parts:
            return aks.ann_topk_ivf_sharded_parts(sel, en, qt, sh.parts,
                                                  sh.bounds_dev, 4)
        return aks.ann_topk_ivf_sharded(sel, en, qt, lay.payload,
                                        lay.bucket_valid, lay.bucket_rows,
                                        sh.bounds_dev, 4)
    qq, qs = (torch.from_numpy(x) for x in quantize_rows(q))
    if parts:
        return aks.ann_topk_ivf_quant_sharded_parts(sel, en, qq, qs,
                                                    sh.parts, sh.bounds_dev,
                                                    16)
    bq, bsc = lay.payload
    return aks.ann_topk_ivf_quant_sharded(sel, en, qq, qs, bq, bsc,
                                          lay.bucket_valid, lay.bucket_rows,
                                          sh.bounds_dev, 16)


@pytest.mark.parametrize("kind", sorted(CLASSES))
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("n_clusters", [16, 4], ids=["c16", "c4"])
def test_per_device_stacks_equal_one_device(monkeypatch, kind, shards,
                                            n_clusters):
    """Kernel 5 once per non-empty shard on its device gives the stacks
    of one call over the whole layout bitwise; the searches' ids, sims
    and scan accounting are the same; each device holds only its slice."""
    n, dim = 400, 32
    embs = _embs(n, dim, seed=6)
    q = _queries(embs, 8)
    one = _index(kind, n, dim, embs, shards, n_clusters)
    want = _stacks(one, kind, q, parts=False)
    one_rows = one.router.kernel_layout(one, quant=kind == "int8").bucket_rows
    one_res = one.search_batch(q, 4, 0.0)
    one_scanned = (one.last_scanned, one.last_scanned_max_shard)
    monkeypatch.setattr(clustering, "shard_devices", _cpus)
    per = _index(kind, n, dim, embs, shards, n_clusters)
    wrapper = aks.ann_topk_ivf_sharded if kind == "fp32" \
        else aks.ann_topk_ivf_quant_sharded
    before = wrapper.plain_calls
    got = _stacks(per, kind, q, parts=True)
    sh = per.router.kernel_shard_buckets(per, quant=kind == "int8")
    live = [p for p in sh.parts if p is not None]
    assert wrapper.plain_calls - before == len(live)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert sh.layout.payload is None
    if shards > n_clusters:
        assert len(live) < shards               # empty shards, S > C
    for si, p in enumerate(sh.parts):
        lo, hi = int(sh.bounds[si]), int(sh.bounds[si + 1])
        assert (p is None) == (hi <= lo)
        if p is not None:
            x = p.payload[0] if kind == "int8" else p.payload
            assert x.shape[0] == hi - lo and p.bucket_rows.shape[0] == hi - lo
            assert torch.equal(p.bucket_rows, one_rows[lo:hi])
    for (i1, s1), (i2, s2) in zip(one_res, per.search_batch(q, 4, 0.0)):
        assert i1 == i2 and np.array_equal(s1, s2)
    assert (per.last_scanned, per.last_scanned_max_shard) == one_scanned


def _part(buckets, valid, rows, lo, hi):
    if hi <= lo:
        return None
    return aks.ShardPart(device=CPU, lo=lo, hi=hi, payload=buckets[lo:hi],
                         bucket_valid=valid[lo:hi], bucket_rows=rows[lo:hi],
                         bounds=torch.tensor([0, hi - lo], dtype=torch.int32))


@pytest.mark.parametrize("kind", sorted(CLASSES))
@pytest.mark.parametrize("b", [1, 3])
def test_packed_probes_round_trip(kind, b):
    """The per-shard byte rows (probes, then the queries, each 16-byte
    aligned) unpack to what the one-device scan reads: stacks bitwise
    equal at B x nprobe odd, with disabled probes and an empty shard."""
    g = torch.Generator().manual_seed(b)
    c, cap, d, nprobe, k = 7, 5, 6, 3, 4
    valid = torch.rand((c, cap), generator=g) < 0.8
    rows = torch.where(valid, torch.arange(c * cap, dtype=torch.int32
                                           ).view(c, cap), -1)
    bounds = torch.tensor([0, 2, 2, 5, 7], dtype=torch.int32)
    cut = bounds.tolist()
    sel = torch.randint(0, c, (b, nprobe), generator=g, dtype=torch.int32)
    en = (torch.rand((b, nprobe), generator=g) < 0.7).to(torch.int32)
    q = torch.randn((b, d), generator=g)
    if kind == "fp32":
        buckets = torch.randn((c, cap, d), generator=g) * valid[..., None]
        parts = [_part(buckets, valid, rows, lo, hi)
                 for lo, hi in zip(cut, cut[1:])]
        got = aks.ann_topk_ivf_sharded_parts(sel, en, q, parts, bounds, k)
        want = aks.ann_topk_ivf_sharded(sel, en, q, buckets, valid, rows,
                                        bounds, k)
    else:
        bq = torch.randint(-127, 128, (c, cap, d), generator=g,
                           dtype=torch.int8) * valid[..., None]
        bsc = torch.rand((c, cap), generator=g) * valid
        qq = torch.randint(-127, 128, (b, d), generator=g, dtype=torch.int8)
        qs = torch.rand((b,), generator=g)
        parts = [None if p is None else aks.ShardPart(
            device=CPU, lo=p.lo, hi=p.hi,
            payload=(bq[p.lo:p.hi], bsc[p.lo:p.hi]),
            bucket_valid=p.bucket_valid, bucket_rows=p.bucket_rows,
            bounds=p.bounds)
            for p in (_part(bq, valid, rows, lo, hi)
                      for lo, hi in zip(cut, cut[1:]))]
        got = aks.ann_topk_ivf_quant_sharded_parts(sel, en, qq, qs, parts,
                                                   bounds, k)
        want = aks.ann_topk_ivf_quant_sharded(sel, en, qq, qs, bq, bsc,
                                              valid, rows, bounds, k)
    assert parts[1] is None
    for a, w in zip(got, want):
        assert a.shape == (4, b, nprobe, k) and torch.equal(a, w)
    assert (got[0][1] < -1e38).all() and (got[1][1] == -1).all()


def test_parts_are_rebuilt_only_with_the_layout(monkeypatch):
    n, dim = 300, 32
    embs = _embs(n, dim, seed=12)
    monkeypatch.setattr(clustering, "shard_devices", _cpus)
    ix = _index("fp32", n, dim, embs, 4)
    sh = ix.router.kernel_shard_buckets(ix)
    assert ix.router.kernel_shard_buckets(ix) is sh
    ix.search_batch(_queries(embs, 4), 4, 0.0)
    assert ix.router.kernel_shard_buckets(ix) is sh       # a search keeps it
    ix.add(n, embs[0])                                    # a mutation does not
    sh2 = ix.router.kernel_shard_buckets(ix)
    assert sh2 is not sh and sh2.layout.payload is None
    assert [p.device for p in sh2.parts] == [CPU] * 4


def test_shard_mesh_and_dispatch_rule_on_a_host_without_cuda():
    """No CUDA device here: the mesh raises as the reference's does, and
    the dispatch rule keeps every shard on the index's device."""
    assert not aks.mesh_available(2) and aks.mesh_available(0)
    with pytest.raises(ValueError, match="mesh needs 2 devices, host has 0"):
        mesh.make_shard_mesh(2)
    assert mesh.make_shard_mesh(0) == []
    assert aks.shard_devices(8, CPU) is None
    assert aks.shard_devices(1, torch.device("cuda")) is None


RUNS = {
    "zipf_s2": dict(workload="zipf", mode="cortex", n_requests=600,
                    n_intents=300, dim=32, concurrency=4, seed=21,
                    cache_ratio=0.9, cluster=True, n_clusters=8, nprobe=4,
                    shards=2),
    # run (c) of PERF.md section 4 at 4 shards: both routers train and
    # rebalance, the fp32 and the int8 scans run
    "tiered_c_s4": dict(workload="longtail", n_intents=3000, n_requests=3000,
                        tail_len=2800, concurrency=16, cache_ratio=0.3,
                        warm_frac=0.5, cluster=True, shards=4),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_once_per_device_equals_one_device(monkeypatch, run):
    """run_once with the dispatch rule giving one (CPU) device per shard:
    the summary equals the one-device run's key for key, and the
    per-device scans ran."""
    kw = dict(RUNS[run], backend="kernel", device="cpu")
    want = run_once(**kw)
    monkeypatch.setattr(clustering, "shard_devices", _cpus)
    wrappers = [aks.ann_topk_ivf_sharded]
    if "warm_frac" in kw:
        wrappers.append(aks.ann_topk_ivf_quant_sharded)
    before = [w.plain_calls for w in wrappers]
    got = run_once(**kw)
    assert all(w.plain_calls > b for w, b in zip(wrappers, before))
    assert got == want
    assert got["rows_scanned_max_shard"] < got["rows_scanned"]


REF_SCRIPT = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import functools
import jax
import numpy as np
# the reference runs its fully-manual Pallas bodies with replication
# checking off (nn/sharding.shard_map_compat, check_rep=False on the old
# API); jax >= 0.7 checks by default, and a Pallas output has no vma
if getattr(jax, "shard_map", None) is not None:
    jax.shard_map = functools.partial(jax.shard_map, check_vma=False)
from repro.core.clustering import ClusterConfig, ClusterRouter
from repro.core.seri import VectorIndex
from repro.data.world import SemanticWorld
from repro.kernels.ann_topk_sharded import mesh_available
assert mesh_available(8)
n, dim, k = 400, 32, 4
world = SemanticWorld(n_intents=n // 8, dim=dim, seed=6)
embs = np.stack([world.embed(world.query((i // 8) % (n // 8), i % 8))
                 for i in range(n)])
cfg = ClusterConfig(n_clusters=16, nprobe=4, min_train=64, seed=3,
                    n_shards=8)
ix = VectorIndex(n + 32, dim, backend="kernel",
                 router=ClusterRouter(n + 32, dim, cfg))
for i in range(n):
    ix.add(i, embs[i])
q = embs[np.random.default_rng(0).integers(0, n, 8)].copy()
q /= np.linalg.norm(q, axis=1, keepdims=True)
res = ix.search_batch(q, k, 0.0)
print("REF_JSON " + json.dumps({
    "q": q.tolist(), "ids": [list(map(int, i)) for i, _ in res],
    "sims": [list(map(float, s)) for _, s in res]}))
"""


def test_per_device_path_matches_reference_shard_map(monkeypatch):
    """The reference's shard_map path on 8 forced XLA host devices
    (tests/test_mesh_shard.py:261's config, which skips in tier-1 for
    want of 8 devices) against the port's per-device path on 8 CPU
    devices, and the port's one-device path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=280)
    line = [x for x in out.stdout.splitlines() if x.startswith("REF_JSON ")]
    assert line, out.stderr[-2000:]
    ref = json.loads(line[0][len("REF_JSON "):])
    n, dim = 400, 32
    embs = _embs(n, dim, seed=6)
    q = np.asarray(ref["q"], np.float32)
    one = _index("fp32", n, dim, embs, 8)
    want = one.search_batch(q, 4, 0.0)
    monkeypatch.setattr(clustering, "shard_devices", _cpus)
    per = _index("fp32", n, dim, embs, 8)
    got = per.search_batch(q, 4, 0.0)
    assert per.router.kernel_shard_buckets(per).parts is not None
    for (ids, sims), (ids1, sims1), r_ids, r_sims in zip(
            got, want, ref["ids"], ref["sims"]):
        assert list(ids) == r_ids
        np.testing.assert_allclose(sims, np.asarray(r_sims, np.float32),
                                   atol=2e-6)
        assert ids == ids1 and np.array_equal(sims, sims1)
