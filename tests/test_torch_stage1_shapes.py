"""Stage 1 at every shape the reference's kernels take: k and nprobe above
64, query blocks of any width, buckets larger than shared memory.

On the CPU the port's wrappers take their plain versions, so these tests
hold what the CPU can show: that no wrapper refuses such a shape and that
the results equal the JAX package's (its Pallas kernels in interpret
mode, and its ``run_once``); which design, query block and chunk each
CUDA call would take, with its shared memory inside the card's; and numpy
rehearsals of the new designs' selection (``select.cuh::merge_pairs``, the
"wide" merge, and ``ann_topk_ivf.cu::scan_chunked``) against the plain
versions' stable sort, ties and NEG rows included. chip_smoke.py's
``stage1_shapes`` holds the CUDA kernels on the card.

The wrappers' inputs are integer-valued, so every fp32 summation order
gives the same sums: values are compared bitwise, and the many exact ties
test the tie rule (value descending, then the lowest row, slot or
cluster).
"""
import contextlib
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro.core.judge import OracleJudge as RefOracleJudge
from repro.core.tiers import make_tiered_cache as ref_make_tiered_cache
from repro.core.tiers import quantize_rows as ref_quantize_rows
from repro.data.world import SemanticWorld as RefSemanticWorld
from repro.kernels import ops as ref_ops
from repro.launch.serve import run_once as ref_run_once
from repro_torch.core.judge import OracleJudge
from repro_torch.core.tiers import make_tiered_cache
from repro_torch.data.world import SemanticWorld
from repro_torch.kernels import ann_topk as k1
from repro_torch.kernels import ann_topk_ivf as ivf
from repro_torch.kernels import ann_topk_quant as k2
from repro_torch.kernels import ann_topk_sharded as sh
from repro_torch.kernels import ops
from repro_torch.launch.serve import run_once as port_run_once

torch.set_num_threads(1)

NEG = k1.NEG
SMS = 132          # H100 SXM
INT_MAX = 2**31 - 1


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(*tensors):
    return [np.asarray(t) for t in tensors]


def _same_real(got, want):
    """Values bitwise; rows (or slots) wherever the value is a real score
    (the reference leaves the rows of NEG entries unspecified)."""
    (gv, gr), (wv, wr) = got, want
    assert gv.shape == wv.shape and gr.shape == wr.shape
    assert gv.dtype == np.float32 and gr.dtype == np.int32
    np.testing.assert_array_equal(gv, wv)
    real = wv > NEG / 2
    np.testing.assert_array_equal(gr[real], wr[real])


# ------------------------------------------------------ the engine runs

ENGINE = dict(cluster=True, n_clusters=128, nprobe=None, n_requests=1500,
              cache_ratio=0.8)


@pytest.mark.parametrize("shards", [None, 4], ids=["one_shard", "shards4"])
def test_every_cluster_probed_matches_the_reference(shards):
    """``nprobe=None`` (every cluster probed, DESIGN.md §12) routes at
    nprobe = 128 through kernel 1 and scans through kernel 3, or kernel 5
    at 4 shards: the port's kernel backend on the CPU gives the
    reference's summary key for key (hit_rate 0.715, 1,528,232 rows at
    seed 0, one shard)."""
    kw = dict(ENGINE, **({} if shards is None else {"shards": shards}))
    want = ref_run_once(**kw)
    before = (k1.ann_topk.plain_calls, ivf.ann_topk_ivf.plain_calls)
    got = port_run_once(**kw, backend="kernel", device="cpu")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert k1.ann_topk.plain_calls > before[0]
    if shards is None:
        assert (got["hit_rate"], got["rows_scanned"]) == (0.715, 1528232)
        assert ivf.ann_topk_ivf.plain_calls > before[1]


def _tiered_pair(top_k):
    rw = RefSemanticWorld(n_intents=120, dim=48, seed=7)
    pw = SemanticWorld(n_intents=120, dim=48, seed=7)
    kw = dict(hot_bytes=5_000, warm_bytes=5_000, index_capacity=256,
              max_ttl=400.0, top_k=top_k)
    ref = ref_make_tiered_cache(dim=rw.dim, judge=RefOracleJudge(
        rw, accuracy=0.98, seed=11), **kw)
    port = make_tiered_cache(dim=pw.dim, judge=OracleJudge(
        pw, accuracy=0.98, seed=11), backend="kernel", device="cpu", **kw)
    return (ref, rw), (port, pw)


def _tiered_run(cache, world):
    """A small hot tier under demote/promote pressure, batched lookups:
    each lookup's outcome, entry and judge score, its stage-1 sims, and
    the stats."""
    rng = np.random.default_rng(11)
    now, hits, sims = 0.0, [], []
    for _ in range(30):
        now += float(rng.random() * 30)
        qs = [world.query(int(rng.integers(0, 120)), int(rng.integers(0, 30)))
              for _ in range(int(rng.integers(1, 9)))]
        embs = np.stack([world.embed(q) for q in qs])
        results = cache.lookup_batch(qs, embs, now)
        hits.extend((r.hit, r.se and r.se.se_id, r.best_score)
                    for r in results)
        sims.extend(np.asarray(r.sims, np.float32) for r in results)
        cache.insert_batch([dict(query=q, q_emb=e, value=world.fetch(q),
                                 cost=0.005, latency=0.4,
                                 size=world.value_size(q))
                            for q, e, r in zip(qs, embs, results)
                            if not r.hit], now=now)
    return (hits, dataclasses.asdict(cache.stats),
            dataclasses.asdict(cache.tier_stats)), sims


def test_tiered_cache_at_top_k_32_matches_the_reference():
    """``top_k`` 32 makes the warm tier ask kernel 2 for 4 × 32 = 128
    coarse candidates (``core/tiers.py``'s ``rescore_mult``): the same
    hits, entries, judge scores and stats as the reference, and the same
    stage-1 sims up to one fp32 rounding (the hot tier's fp32 sums run in
    another order than numpy's, at every top_k)."""
    (ref, rw), (port, pw) = _tiered_pair(32)
    before = k2.ann_topk_quant.plain_calls
    (got, got_sims), (want, want_sims) = (_tiered_run(port, pw),
                                          _tiered_run(ref, rw))
    assert got == want
    for g, w in zip(got_sims, want_sims, strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=2.0**-22)
    assert k2.ann_topk_quant.plain_calls > before
    assert port.tier_stats.demotions > 0


# ------------------------------------------- the wrappers at wide k

def _ints(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("k", [65, 100])
def test_brute_scan_at_k_above_64_is_the_references(k):
    rng = np.random.default_rng(k)
    emb, q = _ints(rng, (700, 32)), _ints(rng, (5, 32))
    act = rng.random(700) > 0.2
    got = _np(*ops.ann_topk_batch(*_t(emb, act), torch.from_numpy(q), k))
    _same_real(got, _np(*ref_ops.ann_topk_jit(emb, act, q, k)))
    _same_real(got, _np(*k1.ann_topk_plain(*_t(emb, act, q), k)))


def test_quant_scan_at_k_100_is_the_references():
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((600, 64)).astype(np.float32)
    q = emb[rng.integers(0, 600, 4)] + 0.01
    act = rng.random(600) > 0.2
    eq, es = ref_quantize_rows(emb)
    qq, qs = ref_quantize_rows(q)
    got = _np(*ops.ann_topk_quant_batch(*_t(eq, es, act), qq, qs, 100))
    _same_real(got, _np(*ref_ops.ann_topk_quant_jit(eq, es, act, qq, qs,
                                                     100)))


def _clustered(c, cap, d, b, seed):
    """Integer centroids with duplicates (cluster ties), integer buckets,
    a valid mask, distinct ascending global rows, some dead clusters."""
    rng = np.random.default_rng(seed)
    cent = _ints(rng, (c, d), -1, 2)
    live = rng.random(c) > 0.1
    buckets = _ints(rng, (c, cap, d))
    valid = rng.random((c, cap)) > 0.3
    rows = np.sort(rng.choice(4 * c * cap, (c, cap), replace=False), axis=1)
    rows = np.where(valid, rows, -1).astype(np.int32)
    q = _ints(rng, (b, d))
    return cent, live, buckets, rows, valid, q


@pytest.mark.parametrize("nprobe,k", [(65, 4), (128, 4), (32, 100)])
def test_routed_scan_at_nprobe_or_k_above_64_is_the_references(nprobe, k):
    cent, live, buckets, rows, valid, q = _clustered(128, 16, 16, 3, nprobe)
    got = _np(*ops.ann_topk_ivf_batch(*_t(cent, live, buckets, rows, valid),
                                      q, nprobe, k))
    want = _np(*ref_ops.ann_topk_ivf_jit(cent, live, buckets, rows,
                                         valid.astype(np.int32), q, nprobe,
                                         k))
    for g, w in zip(got[2:], want[2:]):          # sel, enabled
        np.testing.assert_array_equal(g, w)
    _same_real(got[:2], want[:2])
    bq, bs = ref_quantize_rows(buckets.reshape(-1, 16))
    bq, bs = bq.reshape(buckets.shape), bs.reshape(valid.shape)
    qq, qs = ref_quantize_rows(q)
    got = _np(*ops.ann_topk_ivf_quant_batch(
        *_t(cent, live, bq, bs, rows, valid), q, qq, qs, nprobe, k))
    want = _np(*ref_ops.ann_topk_ivf_quant_jit(
        cent, live, bq, bs, rows, valid.astype(np.int32), q, qq, qs, nprobe,
        k))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sharded_scan_at_nprobe_128_and_k_100_is_the_references():
    """Kernel 5 at 4 shards against the reference's per-shard loop over
    its padded shard stacks, at nprobe 128 and k 100."""
    c, cap, d = 128, 16, 16
    cent, live, buckets, rows, valid, q = _clustered(c, cap, d, 2, 5)
    bounds = np.array([0, 30, 64, 64, 128], dtype=np.int32)
    s = len(bounds) - 1
    cmax = int(np.diff(bounds).max())
    stack = np.zeros((s, cmax, cap, d), np.float32)
    vstack = np.zeros((s, cmax, cap), np.int32)
    rstack = np.full((s, cmax, cap), -1, np.int32)
    for i in range(s):
        lo, hi = bounds[i], bounds[i + 1]
        stack[i, :hi - lo] = buckets[lo:hi]
        vstack[i, :hi - lo] = valid[lo:hi]
        rstack[i, :hi - lo] = rows[lo:hi]
    got = _np(*ops.ann_topk_ivf_sharded_batch(
        *_t(cent, live, buckets, rows, valid, bounds), q, 128, 100))
    want = _np(*ref_ops.ann_topk_ivf_sharded_jit(
        cent, live, stack, rstack, vstack, bounds, q, 128, 100))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
    _same_real(got[:2], want[:2])


# ---------------------------------------------------- dispatch arithmetic

WIDTHS = (3072, 4096, 16384, 60000)
BATCHES = (1, 5, 16, 64)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("d", WIDTHS)
def test_brute_scans_take_a_block_that_fits(d, b):
    """Kernels 1 and 2 at every design: the block :func:`query_block`
    gives where its shared memory fits, else the largest smaller one that
    does, else a block of the smallest size reading its queries in place;
    the CTA's shared memory inside the card's."""
    n, k = 2**20, 4
    for mod, design in ((k1, "fused"), (k1, "twopass"), (k1, "wide"),
                        (k2, "tc"), (k2, "dp4a"), (k2, "wide")):
        kk = 100 if design == "wide" else k
        cut = mod.plan(design, n, d, b, kk, SMS)
        assert cut["smem"] <= k1.SMEM_MAX, (design, d, b)
        blocks = k2.TC_QUERY_BLOCKS if design == "tc" else k1.QUERY_BLOCKS
        top = next((x for x in blocks if b <= x), blocks[-1])
        fits = [x for x in blocks if x <= top and mod.plan(
            design, n, d, b, kk, SMS, qb=x)["smem"] <= k1.SMEM_MAX
            and not mod.plan(design, n, d, b, kk, SMS, qb=x)["qglobal"]]
        if fits:
            assert (cut["qb"], cut["qglobal"]) == (max(fits), False)
        else:
            assert (cut["qb"], cut["qglobal"]) == (blocks[0], True)
        assert cut["nqb"] * cut["qb"] >= b


@pytest.mark.parametrize("design,d,b,want", [
    # at 2^20 rows (512-row tiles) the main path's width keeps today's
    # block; the embedders' widths (3072, 4096) shrink it; above about
    # 55,000 fp32 values (200,000 int8 for dp4a, 25,000 for tc) the
    # smallest block reads its queries in place
    ("fused", 768, 64, (16, False)), ("fused", 3072, 5, (4, False)),
    ("fused", 3072, 16, (4, False)), ("fused", 4096, 64, (4, False)),
    ("fused", 16384, 16, (1, False)), ("fused", 60000, 1, (1, True)),
    ("twopass", 4096, 16, (4, False)), ("twopass", 60000, 5, (1, True)),
    ("tc", 4096, 16, (16, False)), ("tc", 16384, 16, (8, False)),
    ("tc", 60000, 16, (8, True)), ("dp4a", 60000, 16, (1, False)),
    ("dp4a", 16384, 16, (4, False)), ("dp4a", 250000, 1, (1, True))])
def test_query_block_at_the_embedders_widths(design, d, b, want):
    mod = k2 if design in ("tc", "dp4a") else k1
    cut = mod.plan(design, 2**20, d, b, 4, SMS)
    assert (cut["qb"], cut["qglobal"]) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 64, 65, 100, 256, 4096])
def test_wide_k_takes_the_wide_design(k, dtype):
    want = "wide" if k > k1.K_MAX else (
        "fused" if dtype == torch.float32 else "twopass")
    assert k1.pick_design(dtype, True, 128, k) == want
    assert k2.pick_design(True, 128, k) == ("wide" if k > k1.K_MAX else "tc")


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("cap", [64, 4096, 32768, 57344, 65536, 2**20])
@pytest.mark.parametrize("d", [768, 4096, 60000])
@pytest.mark.parametrize("k", [4, 100])
def test_routed_scans_take_block_where_it_fits_else_chunks(cap, d, k, quant,
                                                            sharded):
    """Kernels 3 and 4 and kernel 5 (``sharded``) take "grouped" at every
    shape "warp" does not take, whose plan fits shared memory at these
    shapes' B and nprobe. "block" and "chunked" stay launchable as the
    designs "grouped" is held against: "block" where a bucket's scores
    and query fit shared memory, else "chunked", in chunks that fit."""
    design = ivf.pick_design(cap, k, d, quant, sharded)
    fits = ivf.block_smem(cap, d, k, quant, sharded) <= ivf.SMEM_MAX
    if cap <= ivf.WARP_CAP and k <= k1.K_MAX and \
            ivf.warp_smem(d, quant, sharded) <= ivf.SMEM_MAX:
        assert design == "warp"
    else:
        assert design == "grouped"
        for b, nprobe in ((1, 64), (4, 4), (16, 64)):
            plan = ivf.grouped_plan(b, nprobe, 512, cap, d, k, quant)
            assert plan["smem"] <= ivf.GROUPED_SMEM
    chunk = ivf.chunk_slots(cap)
    assert 1 <= chunk <= cap and chunk * 4 + 1024 <= ivf.SMEM_MAX
    assert chunk == cap or chunk % 256 == 0
    if (cap, d) == (65536, 768):     # 2^20 rows over 16 clusters
        assert design == "grouped" and not fits
        assert -(-cap // chunk) == 2


def test_block_shared_memory_is_the_kernels_layout():
    """csrc/ann_topk_ivf.cu::launch: scores on 16 bytes, the query, and
    for the sharded writer the finalists on 16 bytes after it."""
    assert ivf.block_smem(4096, 768, 4, False, False) == 4096 * 4 + 768 * 4
    assert ivf.block_smem(10, 50, 4, True, False) == 48 + 50
    assert ivf.block_smem(10, 50, 100, True, True) == 112 + 800


# -------------------------------------- numpy rehearsals of the designs

def _ranks_before(a, ra, b, rb):
    return a > b or (a == b and ra < rb)


def _merge_pairs(src_v, src_r, cnt, ln, ncnt, nlen, last):
    """select.cuh::merge_pairs for one query, entry by entry."""
    out_v = np.empty(ncnt * nlen, np.float32)
    out_r = np.empty(ncnt * nlen, np.int64)
    for o in range(ncnt):
        a0 = 2 * o * ln
        la, lb = ln, (ln if 2 * o + 1 < cnt else 0)
        av, ar = src_v[a0:a0 + la], src_r[a0:a0 + la]
        bv, br = src_v[a0 + la:a0 + la + lb], src_r[a0 + la:a0 + la + lb]
        for p in range(nlen):
            v, r = -np.inf, INT_MAX
            if p < la + lb:
                lo, hi = max(0, p - lb), min(p, la)
                while lo < hi:
                    mid = (lo + hi) >> 1
                    j = p - mid - 1
                    if _ranks_before(bv[j], br[j], av[mid], ar[mid]):
                        hi = mid
                    else:
                        lo = mid + 1
                j = p - lo
                if lo < la and (j >= lb or not _ranks_before(
                        bv[j], br[j], av[lo], ar[lo])):
                    v, r = av[lo], ar[lo]
                else:
                    v, r = bv[j], br[j]
            if last and v == -np.inf:
                v, r = NEG, p
            out_v[o * nlen + p], out_r[o * nlen + p] = v, r
    return out_v, out_r


def _wide(scores, k, tile=512):
    """The "wide" design for one query: each tile's min(k, tile) best by
    argmax passes (rows past N score NEG at their own index), then the
    levels of merge_levels, each into the other buffer."""
    n = len(scores)
    ntiles = -(-n // tile)
    padded = np.full(ntiles * tile, np.float32(NEG))
    padded[:n] = scores
    kt = min(k, tile)
    lv, lr = [], []
    for t in range(ntiles):
        s = padded[t * tile:(t + 1) * tile].copy()
        for _ in range(kt):                         # warp_topk
            i = int(np.argmax(s))                   # first of equal maxima
            lv.append(s[i])
            lr.append(t * tile + i)
            s[i] = -np.inf
    src_v, src_r = np.array(lv, np.float32), np.array(lr, np.int64)
    levels = k1.merge_levels(ntiles, kt, k)
    size = k1.wide_scratch(1, ntiles, kt, k)
    for (cnt, ln), (ncnt, nlen) in zip(levels, levels[1:]):
        last = (ncnt, nlen) == levels[-1]
        assert last or ncnt * nlen <= size
        src_v, src_r = _merge_pairs(src_v, src_r, cnt, ln, ncnt, nlen, last)
    return src_v, src_r


@pytest.mark.parametrize("n,k,p_live", [
    (100, 65, 0.5), (1000, 100, 0.9), (3000, 256, 0.7), (1500, 700, 0.5),
    (700, 1100, 0.6), (5000, 65, 0.05), (2600, 600, 1.0)])
def test_wide_merge_is_the_stable_sort_rows_and_all(n, k, p_live):
    """Tiles' lists merged two by two by merge path give the plain
    version's output exactly: the real scores in (value desc, row asc)
    order, then NEG at the inactive rows in order and at rows n, n + 1,
    ... past them, as ``ann_topk_plain``'s stable sort of the NEG-padded
    scores gives them. Integer scores tie often."""
    rng = np.random.default_rng(n + k)
    s = rng.integers(-20, 20, n).astype(np.float32)
    s[rng.random(n) >= p_live] = NEG
    got_v, got_r = _wide(s, k)
    want_v, want_r = k1.ann_topk_plain(torch.from_numpy(s[:, None].copy()),
                                       torch.ones(n, dtype=torch.bool),
                                       torch.ones(1, 1), k)
    np.testing.assert_array_equal(got_v, want_v[0].numpy())
    np.testing.assert_array_equal(got_r, want_r[0].numpy())


@pytest.mark.parametrize("ntiles,kt,k", [(1, 100, 100), (2, 512, 700),
                                         (3, 512, 2000), (2048, 100, 100),
                                         (5, 256, 256), (7, 512, 5000)])
def test_merge_levels_end_in_one_list_of_k(ntiles, kt, k):
    levels = k1.merge_levels(ntiles, kt, k)
    assert levels[0] == (ntiles, kt) and levels[-1] == (1, k)
    assert len(levels) == 1 + max(1, (ntiles - 1).bit_length())
    for (c, ln), (nc, nl) in zip(levels, levels[1:]):
        assert nc == -(-c // 2) and nl in (k, min(k, 2 * ln))
    size = k1.wide_scratch(3, ntiles, kt, k)
    assert size == 3 * max(c * ln for c, ln in levels[:-1])


def _chunked(scores, k, chunk):
    """ann_topk_ivf.cu::scan_chunked for one probe: chunk after chunk, k
    passes that take the running list's next entry or the chunk's best
    (argmax, first of equal maxima), the list winning ties; past the cap
    the last chunk writes NEG at slot p."""
    cap = len(scores)
    nch = -(-cap // chunk)
    lv, lr = [], []
    for t in range(nch):
        c0 = t * chunk
        sc = scores[c0:c0 + chunk].astype(np.float32).copy()
        length = min(k, len(lv) + len(sc))
        fill = k if t == nch - 1 else length
        nv, nr, head = [], [], 0
        for p in range(fill):
            if p >= length:
                nv.append(np.float32(NEG))
                nr.append(p)
                continue
            i = int(np.argmax(sc)) if np.isfinite(sc.max()) else None
            if head < len(lv) and (i is None or _ranks_before(
                    lv[head], lr[head], sc[i], c0 + i)):
                nv.append(lv[head])
                nr.append(lr[head])
                head += 1
            else:
                nv.append(sc[i])
                nr.append(c0 + i)
                sc[i] = -np.inf
        lv, lr = nv, nr
    return np.array(lv, np.float32), np.array(lr, np.int64)


@pytest.mark.parametrize("cap,k,chunk,p_valid", [
    (1000, 4, 256, 0.7), (1000, 100, 256, 0.7), (600, 700, 256, 0.5),
    (4096, 65, 1024, 0.02), (700, 16, 700, 0.9), (513, 512, 256, 0.3)])
def test_chunked_scan_is_the_one_chunk_result(cap, k, chunk, p_valid):
    """Chunks merged into a running list give the one-chunk argmax passes'
    output (``ann_topk_ivf_plain``'s stable sort), the slots of NEG entries
    included: invalid slots in order, then cap, cap + 1, ..."""
    rng = np.random.default_rng(cap + k)
    s = rng.integers(-9, 9, cap).astype(np.float32)
    s[rng.random(cap) >= p_valid] = NEG
    got_v, got_r = _chunked(s, k, chunk)
    want_v, want_r = ivf._stable_topk(torch.from_numpy(s)[None], k)
    np.testing.assert_array_equal(got_v, want_v[0].numpy())
    np.testing.assert_array_equal(got_r, want_r[0].numpy())


# ---------------------------------------- launch arguments, no card

class _Entry:
    def __init__(self):
        self.calls, self.argtypes, self.restype = [], None, None

    def __call__(self, *args):
        self.calls.append(args)
        return 0


ENTRIES = {k1: ("ann_topk_launch", "ann_topk_fused_launch",
                 "ann_topk_wide_launch", "ann_topk_error_string"),
           ivf: ("ann_topk_ivf_launch", "ann_topk_ivf_quant_launch",
                 "ann_topk_ivf_sharded_launch",
                 "ann_topk_ivf_quant_sharded_launch",
                 "ann_topk_ivf_chunked_launch", "ann_topk_ivf_grouped_launch",
                 "ann_topk_ivf_error_string")}


def _fake(monkeypatch, module):
    lib = types.SimpleNamespace(**{n: _Entry() for n in ENTRIES[module]})
    monkeypatch.setattr(module.build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(k1, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(k2, "sm_count", lambda dev: SMS)
    return lib


def test_wide_launch_passes_its_scratch_and_counts(monkeypatch):
    lib = _fake(monkeypatch, k1)
    for name in ("launches", "launches_wide"):
        monkeypatch.setattr(k1.ann_topk, name, 0)
    emb, act, q = torch.zeros(1300, 64), torch.ones(1300, dtype=torch.bool), \
        torch.zeros(5, 64)
    vals, rows = k1._launch("wide", emb, act, q, 100)
    (call,) = lib.ann_topk_wide_launch.calls
    assert call[:2] == (0, 16) and call[5] == 0         # fp32, qb 16, no qf
    assert call[6:10] == (1300, 64, 5, 100)
    assert call[-3:] == (vals.data_ptr(), rows.data_ptr(), 7)
    assert (k1.ann_topk.launches, k1.ann_topk.launches_wide) == (1, 1)
    assert vals.shape == rows.shape == (5, 100)
    with pytest.raises(ValueError, match="takes k up to 64"):
        k1._launch("fused", emb, act, q, 65)


def test_wide_d_reads_the_queries_in_place(monkeypatch):
    """Above the widths a block of one holds, "fused" passes its queries
    as they lie (on a 16-byte boundary) and sets qglobal."""
    lib = _fake(monkeypatch, k1)
    d = 60000
    emb, act = torch.zeros(64, d), torch.ones(64, dtype=torch.bool)
    q = torch.zeros(2 * d + 1)[1:].view(2, d)           # off 16 bytes
    k1._launch("fused", emb, act, q, 4)
    (call,) = lib.ann_topk_fused_launch.calls
    assert (call[0], call[2]) == (1, 1)                 # qb 1, qglobal
    assert call[5] % 16 == 0 and call[5] != q.data_ptr()


def test_chunked_launch_passes_its_chunk_and_scratch(monkeypatch):
    lib = _fake(monkeypatch, ivf)
    monkeypatch.setattr(sh.ann_topk_ivf_sharded, "launches_chunked", 0)
    c, cap, d, b, nprobe = 4, 300, 16, 2, 3
    sel = torch.zeros((b, nprobe), dtype=torch.int32)
    en = torch.ones((b, nprobe), dtype=torch.int32)
    q, buckets = torch.zeros(b, d), torch.zeros(c, cap, d)
    valid = torch.ones(c, cap, dtype=torch.bool)
    rows = torch.zeros(c, cap, dtype=torch.int32)
    bounds = torch.tensor([0, 2, 4], dtype=torch.int32)
    vals, idx = ivf._launch("chunked", sh.ann_topk_ivf_sharded, sel, en, q,
                            buckets, valid, rows, bounds, k=100, chunk=256)
    (call,) = lib.ann_topk_ivf_chunked_launch.calls
    assert call[0] == 0 and call[4] == 0 and call[6] == 0  # fp32: no scales
    assert call[8:10] == (rows.data_ptr(), bounds.data_ptr())
    assert call[10:18] == (2, b, nprobe, c, cap, d, 100, 256)
    assert call[-3:] == (vals.data_ptr(), idx.data_ptr(), 7)
    assert vals.shape == (2, b, nprobe, 100)
    assert sh.ann_topk_ivf_sharded.launches_chunked == 1
