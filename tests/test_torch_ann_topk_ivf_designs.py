"""The designs of kernel 5, the shard-owned routed scans
(``ann_topk_ivf_sharded`` / ``ann_topk_ivf_quant_sharded``): which inputs
take one warp per probe ("warp") and which the CTA per probe ("block"),
the counts by design, and a CPU rehearsal of the warp design's selection
(``csrc/ann_topk_ivf.cu::ivf_warp_sharded``).

The CUDA kernels run only on the card, where chip_smoke.py holds both
designs to the plain versions. The rehearsal repeats the warp kernel's
steps in numpy: the owner found by one ballot over the cut points, two
scores a lane (slots lane and lane + 32), NEG for invalid slots and for
the stable sort's pads past cap, a bitonic network in ``ranks_before``
order over the first max(valid prefix, k) entries (8, 16 or 32 lanes, or
all 64 entries), the first k lanes' finalists mapped to global rows and
written at the owner. It must give the plain version's stacks exactly,
ties included. Scores come from integer-valued rows, so every summation
order gives the same fp32 sums, and the int8 rescale repeats the
reference's two rounded multiplies.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ann_topk_sharded as sh
from repro_torch.kernels.ann_topk import K_MAX, NEG

torch.set_num_threads(1)

INT_MAX = 2**31 - 1


# ------------------------------------------------------------ dispatch

@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("k", [1, 4, 16, 32, 64])
@pytest.mark.parametrize("cap", [8, 16, 32, 64, 128, 4096])
def test_design_by_bucket_size(cap, k, quant):
    """Buckets of at most 64 slots take "warp" at every k, whatever the
    payload type (the engine's caps, powers of two from 8); larger ones,
    the real-size router's, keep "block"."""
    want = "warp" if cap <= 64 else "block"
    assert sh.pick_design(cap, k, 128, quant) == want


@pytest.mark.parametrize("quant", [False, True])
def test_design_falls_back_where_the_queries_overflow_shared_memory(quant):
    """"warp" keeps each of its warps' queries in shared memory: a width
    that overflows it takes "block" (whose launch then raises with the
    shape, as it always did)."""
    item = 1 if quant else 4
    d_max = (sh.SMEM_MAX // sh.WARP_PROBES - K_MAX * 8 - sh.WARP_CAP * 4) \
        // item // 16 * 16
    assert sh.warp_smem(d_max, quant) <= sh.SMEM_MAX
    assert sh.pick_design(16, 4, d_max, quant) == "warp"
    assert sh.pick_design(16, 4, d_max + 16, quant) == "block"


def test_designs_are_named_by_the_counts():
    """Each design has its count on both wrappers, starting at 0 in a fresh
    process and never touched by the CPU path; ``_launch`` refuses a
    design it does not know before it touches the card."""
    assert sh.DESIGNS == ("warp", "block")
    for w in (sh.ann_topk_ivf_sharded, sh.ann_topk_ivf_quant_sharded):
        for d in sh.DESIGNS:
            assert isinstance(getattr(w, f"launches_{d}"), int)
        assert isinstance(w.launches, int)
    with pytest.raises(ValueError, match="design"):
        sh._launch("tile", sh.ann_topk_ivf_sharded, k=4)


def test_cpu_calls_leave_the_design_counts_alone():
    sel, en, q, buckets, valid, rows, bounds = _inputs(16, 8, 2, 3, 8,
                                                       0.5, [0, 3, 8],
                                                       seed=0)
    w = sh.ann_topk_ivf_sharded
    before = (w.launches, w.launches_warp, w.launches_block, w.plain_calls)
    w(*(torch.from_numpy(x) for x in (sel, en, q, buckets, valid, rows,
                                      bounds)), 4)
    assert (w.launches, w.launches_warp, w.launches_block) == before[:3]
    assert w.plain_calls == before[3] + 1


# ---------------------------------------- the warp design's selection

def _ranks_before(a, ra, b, rb):
    return a > b or (a == b and ra < rb)


def _network(v, r, e, n):
    """select.cuh::warp_sort_regs<E, N>, lane by lane: entry lane + 32 j in
    v[lane][j]; only the first log2(n) merges run. Returns the entries in
    index order."""
    v = [row[:] for row in v]
    r = [row[:] for row in r]
    size = 2
    while size <= n:
        stride = size >> 1
        while stride > 0:
            if stride == 32:
                for lane in range(32):
                    if _ranks_before(v[lane][1], r[lane][1], v[lane][0],
                                     r[lane][0]):
                        v[lane].reverse()
                        r[lane].reverse()
            else:
                nv = [row[:] for row in v]
                nr = [row[:] for row in r]
                for lane in range(32):
                    for j in range(e):
                        el = lane + 32 * j
                        ov, orow = v[lane ^ stride][j], r[lane ^ stride][j]
                        first = ((el & stride) == 0) == ((el & size) == 0)
                        if first == _ranks_before(ov, orow, v[lane][j],
                                                  r[lane][j]):
                            nv[lane][j], nr[lane][j] = ov, orow
                v, r = nv, nr
            stride >>= 1
        size <<= 1
    return ([v[i % 32][i // 32] for i in range(32 * e)],
            [r[i % 32][i // 32] for i in range(32 * e)])


def _best_of_few(score, m, k):
    """select.cuh::warp_best_of_few(m, k, ..., tight=true): entry i is
    (score[i], i) for i < m, (-inf, INT_MAX) past it; a network over 8 or
    16 lanes for m <= 8 / 16, all 32 for m <= 32, both halves above."""
    e = 1 if m <= 32 else 2
    n = 32 * e if m > 16 else (8 if m <= 8 else 16)
    v = [[score[lane + 32 * j] if lane + 32 * j < m else -np.inf
          for j in range(e)] for lane in range(32)]
    r = [[lane + 32 * j if lane + 32 * j < m else INT_MAX
          for j in range(e)] for lane in range(32)]
    vals, slots = _network(v, r, e, n)
    return vals[:k], slots[:k]


def _warp_kernel(sel, en, scores, valid, rows, bounds, k):
    """ivf_warp_sharded on host arrays: ``scores`` (B, nprobe, cap) the
    probes' raw scores (what score_groups and Scorer::finish give).
    Returns the (S, B, nprobe, k) stacks."""
    b, nprobe = sel.shape
    c_count, cap = valid.shape
    s_count = len(bounds) - 1
    vals = np.full((s_count, b, nprobe, k), np.float32(NEG), np.float32)
    out_rows = np.full((s_count, b, nprobe, k), -1, np.int32)
    for bi in range(b):
        for j in range(nprobe):
            c = int(sel[bi, j])
            if en[bi, j] == 0 or not 0 <= c < c_count:
                continue
            own = [s for s in range(s_count)
                   if bounds[s] <= c < bounds[s + 1]]
            if not own:
                continue
            ok = valid[c].astype(bool)
            hi = int(np.nonzero(ok)[0].max()) + 1 if ok.any() else 0
            # two slots a lane: entry i is slot i, NEG where invalid and
            # past cap (the stable sort's pads up to k)
            score = [float(scores[bi, j, i]) if i < cap and ok[i]
                     else float(np.float32(NEG)) for i in range(64)]
            fv, fs = _best_of_few(score, max(hi, k), k)
            for p in range(k):
                vals[own[0], bi, j, p] = fv[p]
                if fv[p] > NEG / 2:
                    out_rows[own[0], bi, j, p] = rows[c, fs[p]]
    return vals, out_rows


def _inputs(cap, d, b, nprobe, c, p_valid, bounds, seed):
    """Integer-valued buckets (exact fp32 sums in any order) with duplicate
    rows inside buckets (exact ties), a random valid mask at share
    p_valid, distinct global rows ascending within a bucket, queries and
    probes (a share of them disabled, one out of range)."""
    rng = np.random.default_rng(seed)
    buckets = rng.integers(-3, 4, (c, cap, d)).astype(np.float32)
    for ci in range(c):
        src = rng.integers(0, cap)
        buckets[ci, rng.integers(0, cap, 3)] = buckets[ci, src]
    valid = (rng.random((c, cap)) < p_valid).astype(np.uint8)
    rows = np.sort(rng.choice(4 * c * cap, (c, cap), replace=False), axis=1)
    rows = np.where(valid > 0, rows, -1).astype(np.int32)
    q = rng.integers(-3, 4, (b, d)).astype(np.float32)
    sel = np.stack([rng.choice(c, nprobe, replace=False)
                    for _ in range(b)]).astype(np.int32)
    en = (rng.random((b, nprobe)) >= 0.2).astype(np.int32)
    sel[0, 0] = c          # out of range: scores as a disabled probe
    return (sel, en, q, buckets, valid, rows,
            np.asarray(bounds, np.int32))


def _quantize(x):
    amax = np.abs(x).max(axis=-1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    xq = np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8)
    return xq, scale


# bounds over C = 8 clusters: one shard; three with an empty one; eight,
# two of them empty
BOUNDS = {1: [0, 8], 3: [0, 3, 3, 8], 8: [0, 1, 1, 2, 4, 5, 5, 7, 8]}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("p_valid", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("cap", [8, 16, 32, 64])
def test_warp_selection_is_the_plain_stable_top_k(cap, k, p_valid, s, quant):
    """The rehearsal gives the plain version's stacks exactly: values,
    global rows, NEG / -1 at every masked entry, exact ties in slot
    order, k above cap."""
    c, d, b, nprobe = 8, 16, 2, 4
    sel, en, q, buckets, valid, rows, bounds = _inputs(
        cap, d, b, nprobe, c, p_valid, BOUNDS[s], seed=cap * 100 + k)
    t = torch.from_numpy
    sel_c = np.clip(sel, 0, c - 1)
    if quant:
        bq, bs = _quantize(buckets.reshape(c * cap, d))
        bq, bs = bq.reshape(c, cap, d), bs.reshape(c, cap)
        qq, qs = _quantize(q)
        dots = np.einsum("bjsd,bd->bjs", bq[sel_c].astype(np.int32),
                         qq.astype(np.int32))
        # float(i32) * slot scale, then * query scale, each rounded
        scores = (dots.astype(np.float32) * bs[sel_c]).astype(np.float32) \
            * qs[:, None, None]
        want = sh.ann_topk_ivf_quant_sharded_plain(
            t(sel), t(en), t(qq), t(qs), t(bq), t(bs), t(valid), t(rows),
            t(bounds), k)
    else:
        scores = np.einsum("bjsd,bd->bjs", buckets[sel_c], q)
        want = sh.ann_topk_ivf_sharded_plain(
            t(sel), t(en), t(q), t(buckets), t(valid), t(rows), t(bounds),
            k)
    got = _warp_kernel(sel, en, scores.astype(np.float32), valid, rows,
                       bounds, k)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("m,k", [(1, 1), (5, 4), (8, 8), (9, 4), (16, 16),
                                 (17, 16), (32, 4), (33, 16), (64, 16),
                                 (64, 64)])
def test_tight_network_sorts_its_first_lanes(m, k):
    """The network cut to the next 8, 16 or 32 lanes (or both halves of
    64 entries) puts the first k of m entries in ranks_before order, exact
    value ties in index order, as the full 32-lane network does."""
    rng = np.random.default_rng(m * 7 + k)
    score = rng.integers(-3, 4, 64).astype(np.float32).tolist()
    vals, slots = _best_of_few(score, m, k)
    want = sorted(range(m), key=lambda i: (-score[i], i))[:k]
    assert slots == want
    assert vals == [score[i] for i in want]
