"""The designs of kernels 1 and 2 (``ann_topk``, ``ann_topk_quant``):
which inputs take the one-launch kernels, how the rows are cut into CTA
tiles, the scratch and tickets a call allocates, and CPU rehearsals of the
pieces of the new kernels that decide their results: the xor tree
scattered over the lanes (``dot.cuh::warp_dot_scatter``), the byte layout
of the int8 tensor-core fragments (``ann_topk_quant.cu::annq_tc``), the
sorting network and the threshold pass that pick a tile's finalists
(``select.cuh::warp_sort_regs``, ``warp_tile_topk``) and the merge of the
tiles' finalist lists in the last CTA (``select.cuh::warp_merge``).

The CUDA kernels run only on the card, where chip_smoke.py holds both
designs of each kernel to the plain versions. The rehearsals repeat the
kernels' index arithmetic in numpy, so a wrong lane mapping or permutation
shows here before any card time: the scattered tree must give the
butterfly's sums bitwise, the fragments must give exact int32 dot
products, and the merge must give the reference's (value desc, row asc)
top k, ties included.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ann_topk as k1
from repro_torch.kernels import ann_topk_quant as k2

SMS = 132          # H100 SXM
NS = (1, 63, 64, 512, 513, 8192, 2**20)


# ------------------------------------------------------------ dispatch

@pytest.mark.parametrize("dtype,aligned,d,want", [
    (torch.float32, True, 128, "fused"), (torch.float32, True, 768, "fused"),
    (torch.float32, True, 100, "fused"), (torch.float32, True, 50, "twopass"),
    (torch.float32, False, 128, "twopass"),
    (torch.bfloat16, True, 128, "twopass"),
    (torch.bfloat16, False, 64, "twopass")])
def test_ann_topk_design_by_dtype_alignment_and_width(dtype, aligned, d, want):
    assert k1.pick_design(dtype, aligned, d) == want


@pytest.mark.parametrize("aligned,d,want", [
    (True, 32, "tc"), (True, 128, "tc"), (True, 768, "tc"), (True, 96, "tc"),
    (True, 48, "dp4a"), (True, 100, "dp4a"), (True, 16, "dp4a"),
    (False, 128, "dp4a")])
def test_ann_topk_quant_design_by_alignment_and_width(aligned, d, want):
    assert k2.pick_design(aligned, d) == want


@pytest.mark.parametrize("qb,rows", [(1, 8), (4, 8), (16, 4)])
def test_fused_rows_per_warp(qb, rows):
    assert k1.fused_rows(qb) == rows


@pytest.mark.parametrize("b,qb", [(1, 8), (8, 8), (9, 16), (16, 16),
                                  (64, 16)])
def test_tc_query_block(b, qb):
    assert k2.tc_query_block(b) == qb


def test_designs_are_named_by_the_counts():
    """Each design a wrapper can launch has its count, starting at 0 in a
    fresh process and never touched by the CPU path."""
    for w, designs in ((k1.ann_topk, k1.DESIGNS),
                       (k2.ann_topk_quant, k2.DESIGNS)):
        for d in designs:
            assert isinstance(getattr(w, f"launches_{d}"), int)


# ----------------------------------------------------------- tile plan

@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("b", [1, 16, 64])
@pytest.mark.parametrize("kernel", ["fused", "tc"])
@pytest.mark.parametrize("k", [4, 16, 64])
def test_tile_plan_covers_every_row_once_and_fills_the_card(n, b, kernel, k):
    if kernel == "fused":
        step, qb = k1.fused_rows(k1.query_block(b)), k1.query_block(b)
    else:
        step, qb = k2.TC_ROWS, k2.tc_query_block(b)
    tile_n, ntiles, nqb = k1.tile_plan(n, b, k, qb, SMS, step)
    lo = -(-k // step) * step
    assert tile_n % step == 0 and lo <= tile_n <= k1.TILE_N
    assert nqb == -(-b // qb) and nqb * qb >= b
    # every row in exactly one tile: tiles [i * tile_n, (i + 1) * tile_n)
    starts = np.arange(ntiles) * tile_n
    ends = np.minimum(starts + tile_n, n)
    assert starts[0] == 0 and ends[-1] == n
    assert (ends > starts).all() and (starts[1:] == ends[:-1]).all()
    # two CTAs per SM wherever N allows (tiles of at least k rows), with
    # the largest tile that does
    target = k1.CTAS_PER_SM * SMS
    if -(-n // lo) * nqb >= target:
        assert ntiles * nqb >= target
    if tile_n > lo and tile_n + step <= k1.TILE_N:
        assert -(-n // (tile_n + step)) * nqb < target


def test_tile_plan_at_the_engine_shapes():
    """8192 x 128 at B = 1 gives 342 CTAs of 24 rows (kernel 1) and 512 of
    16 rows (kernel 2, k = 16); routing over 64 centroids is 8 tiles of 8,
    over 512 with nprobe 64 tiles of 64; 2**20 rows take 512-row tiles."""
    assert k1.tile_plan(8192, 1, 4, 1, SMS, 8) == (24, 342, 1)
    assert k1.tile_plan(8192, 1, 16, 8, SMS, k2.TC_ROWS) == (16, 512, 1)
    assert k1.tile_plan(64, 1, 8, 1, SMS, 8) == (8, 8, 1)
    assert k1.tile_plan(512, 16, 64, 16, SMS, 8) == (64, 8, 1)
    assert k1.tile_plan(2**20, 64, 4, 16, SMS, 8) == (512, 2048, 4)


# ---------------------------------------------------- scratch, tickets

@pytest.mark.parametrize("b,ntiles,k", [(3, 7, 5), (1, 342, 4),
                                         (16, 2048, 16)])
def test_scratch_shapes(b, ntiles, k):
    shapes = k1.scratch_shapes(b, ntiles, k)
    assert shapes == {"fv": ((b, ntiles, k), torch.float32),
                      "fr": ((b, ntiles, k), torch.int32)}
    bufs = k1.scratch(b, ntiles, k, torch.device("cpu"))
    assert {n: (tuple(t.shape), t.dtype) for n, t in bufs.items()} == shapes


def test_tickets_are_zero_shared_and_grow():
    dev = torch.device("cpu")
    k1._tickets.pop(dev, None)
    t = k1.tickets(dev, 3)
    assert t.dtype == torch.int32 and t.numel() >= 64 and not t.any()
    assert k1.tickets(dev, 10) is t            # large enough: the same one
    big = k1.tickets(dev, t.numel() + 1)
    assert big.numel() >= 2 * t.numel() and not big.any()
    assert k1.tickets(dev, 1) is big
    k1._tickets.pop(dev, None)


def test_quant_launch_refuses_a_block_of_the_other_design():
    rng = np.random.default_rng(0)
    eq = torch.from_numpy(rng.integers(-127, 128, (40, 64), dtype=np.int8))
    es = torch.ones(40)
    act = torch.ones(40, dtype=torch.bool)
    qq = eq[:2].clone()
    qs = torch.ones(2)
    with pytest.raises(ValueError):
        k2._launch("tc", eq, es, act, qq, qs, 4, qb=4)
    with pytest.raises(ValueError):
        k2._launch("dp4a", eq, es, act, qq, qs, 4, qb=8)
    with pytest.raises(ValueError):
        k2.ann_topk_quant(eq, es, act, qq, qs, 4, qb=2)
    # on the CPU the wrapper takes the plain version whatever the block
    got = k2.ann_topk_quant(eq, es, act, qq, qs, 4, qb=8)
    want = k2.ann_topk_quant_plain(eq, es, act, qq, qs, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -------------------------------------------- the scattered xor tree

def _butterfly(p):
    """dot::warp_dot's tree: (32, M) lane partials -> (M,) sums."""
    s = p.copy()
    for off in (16, 8, 4, 2, 1):
        s = (s + s[np.arange(32) ^ off]).astype(np.float32)
    assert (s == s[0]).all()
    return s[0]


def _scatter(p):
    """dot::warp_dot_scatter's tree, lane by lane: returns each lane's
    values (32, E)."""
    m = p.shape[1]
    v = [list(p[lane]) for lane in range(32)]
    for off in (16, 8, 4, 2, 1):
        new = []
        for lane in range(32):
            part = v[lane ^ off]
            if m > 1:
                h = m // 2
                upper = lane & off
                mine = v[lane][h:m] if upper else v[lane][:h]
                send = part[:h] if (lane ^ off) & off else part[h:m]
                new.append([np.float32(a + b) for a, b in zip(mine, send)]
                           + v[lane][h:])
            else:
                new.append([np.float32(v[lane][0] + part[0])] + v[lane][1:])
        v = new
        m = max(m // 2, 1)
    e = max(p.shape[1] // 32, 1)
    return np.array([row[:e] for row in v], dtype=np.float32)


@pytest.mark.parametrize("rows,qb", [(8, 1), (8, 4), (8, 16), (4, 16),
                                     (4, 1)])
def test_scattered_tree_is_the_butterfly_bitwise(rows, qb):
    m = rows * qb
    rng = np.random.default_rng(m)
    # partials of mixed magnitudes, so a different tree would round
    # differently
    p = (rng.standard_normal((32, m)) * 10.0 ** rng.integers(-4, 4, (32, m))
         ).astype(np.float32)
    want = _butterfly(p)
    got = _scatter(p)
    e = max(m // 32, 1)
    share = 1 if m >= 32 else 32 // m
    for lane in range(32):
        first = lane // share * e          # dot::Scatter::first
        np.testing.assert_array_equal(got[lane], want[first:first + e])
    # every sum is held by some lane
    held = {lane // share * e + i for lane in range(32) for i in range(e)}
    assert held == set(range(m))
    # and the tree is not order-free on these inputs: a sequential sum
    # differs somewhere, so the check above has teeth
    assert not np.array_equal(p.sum(axis=0, dtype=np.float32), want)


# ------------------------------------------- int8 tensor-core fragments

def _words(b: np.ndarray) -> list:
    """Bytes (multiple of 4) as the 4-byte words a register holds."""
    return [b[i:i + 4] for i in range(0, len(b), 4)]


def _mma(c, afr, bfr):
    """mma.sync m16n8k32 s8: afr[lane] = 4 words, bfr[lane] = 2 words, by
    the PTX fragment layout; c (16, 8) int64 accumulates A @ B."""
    a = np.zeros((16, 32), np.int64)
    b = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        w = afr[lane]
        a[g, 4 * t:4 * t + 4] = w[0]
        a[g + 8, 4 * t:4 * t + 4] = w[1]
        a[g, 16 + 4 * t:16 + 4 * t + 4] = w[2]
        a[g + 8, 16 + 4 * t:16 + 4 * t + 4] = w[3]
        u = bfr[lane]
        b[4 * t:4 * t + 4, g] = u[0]
        b[16 + 4 * t:16 + 4 * t + 4, g] = u[1]
    return c + a @ b


@pytest.mark.parametrize("d", [32, 64, 96, 128, 768])
def test_int8_fragments_give_exact_dots(d):
    """annq_tc's loads: lane (g, t) takes 16 bytes at 64c + 16t of rows g
    and g + 8 and of query g, feeding two k-steps (words x, y then z, w);
    a 32-byte tail takes 8 bytes at 8t. The accumulator, read back as the
    kernel's epilogue reads it (c[e]: row g + 8 (e >> 1), query
    2t + (e & 1)), must be the exact int32 dot of every (row, query)."""
    rng = np.random.default_rng(d)
    rows = rng.integers(-127, 128, (16, d)).astype(np.int64)
    qs = rng.integers(-127, 128, (8, d)).astype(np.int64)
    c = np.zeros((16, 8), np.int64)
    for ch in range(d // 64):
        afr1, afr2, bfr1, bfr2 = [], [], [], []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            sl = slice(64 * ch + 16 * t, 64 * ch + 16 * t + 16)
            a, a8, u = _words(rows[g, sl]), _words(rows[g + 8, sl]), \
                _words(qs[g, sl])
            afr1.append([a[0], a8[0], a[1], a8[1]])
            afr2.append([a[2], a8[2], a[3], a8[3]])
            bfr1.append([u[0], u[1]])
            bfr2.append([u[2], u[3]])
        c = _mma(_mma(c, afr1, bfr1), afr2, bfr2)
    if d & 32:
        base = 64 * (d // 64)
        afr, bfr = [], []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            sl = slice(base + 8 * t, base + 8 * t + 8)
            a, a8, u = _words(rows[g, sl]), _words(rows[g + 8, sl]), \
                _words(qs[g, sl])
            afr.append([a[0], a8[0], a[1], a8[1]])
            bfr.append([u[0], u[1]])
        c = _mma(c, afr, bfr)
    want = rows @ qs.T
    np.testing.assert_array_equal(c, want)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for e in range(4):
            r, j = g + (e >> 1) * 8, 2 * t + (e & 1)
            assert c[r, j] == want[r, j]


def test_tc_query_rows_read_without_bank_conflicts():
    """A quarter warp (8 lanes: rows g, g + 1, words t = 0..3) reads eight
    distinct 16-byte bank groups of the padded query block, at every D of
    the tc design up to 1024."""
    for d in range(32, 1025, 32):
        stride = d + 16 * ((4 - d // 16) & 7)    # ann_topk_quant.cu
        assert stride >= d and stride % 16 == 0
        for g0 in range(0, 8, 2):
            groups = {((g0 + dg) * stride // 16 + t) % 8
                      for dg in (0, 1) for t in range(4)}
            assert len(groups) == 8, d


# ----------------------------------------------- the sorting networks

def _ranks_before(a, ra, b, rb):
    return a > b or (a == b and ra < rb)


def _sort_regs(vals, rows, e):
    """select.cuh::warp_sort_regs, lane by lane: entry lane + 32 j in
    v[lane][j]; returns the entries in index order."""
    v = [[vals[lane + 32 * j] for j in range(e)] for lane in range(32)]
    r = [[rows[lane + 32 * j] for j in range(e)] for lane in range(32)]
    size = 2
    while size <= 32 * e:
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


@pytest.mark.parametrize("m", [1, 5, 16, 24, 32, 33, 50, 64])
def test_register_sort_orders_by_value_then_row(m):
    """warp_best_of_few's network on m <= 64 pairs, padded with
    (-inf, INT_MAX), with exact ties in value: the (value desc, row asc)
    order, as the argmax passes give it."""
    rng = np.random.default_rng(m)
    vals = rng.integers(-3, 4, m).astype(np.float32).tolist()
    rows = rng.permutation(1000)[:m].tolist()
    e = 1 if m <= 32 else 2
    pad = 32 * e - m
    got_v, got_r = _sort_regs(vals + [-np.inf] * pad,
                              rows + [2**31 - 1] * pad, e)
    want = sorted(zip(vals, rows), key=lambda p: (-p[0], p[1]))
    assert list(zip(got_v[:m], got_r[:m])) == want


def _tile_topk(s, k, cap=64):
    """select.cuh::warp_tile_topk: the k-th largest lane maximum bounds
    the k-th best; entries >= it are sorted, past ``cap`` argmax passes
    run over the whole tile. Returns (values, positions)."""
    m = len(s)
    maxima = sorted((max(s[lane::32]) for lane in range(32)), reverse=True)
    keep = [i for i in range(m) if s[i] >= maxima[k - 1]]
    pool = keep if len(keep) <= cap else list(range(m))
    best = sorted(pool, key=lambda i: (-s[i], i))[:k]
    return [s[i] for i in best], best


@pytest.mark.parametrize("m,k,p_live", [(512, 4, 0.8), (512, 16, 0.8),
                                        (512, 32, 0.8), (65, 16, 0.5),
                                        (512, 4, 0.05), (200, 16, 0.02)])
def test_tile_threshold_pass_is_the_stable_top_k(m, k, p_live):
    rng = np.random.default_rng(m + k)
    s = rng.integers(-20, 20, m).astype(np.float32)    # exact ties
    s[rng.random(m) >= p_live] = np.float32(k1.NEG)
    vals, pos = _tile_topk(s.tolist(), k)
    order = np.lexsort((np.arange(m), -s))[:k]
    np.testing.assert_array_equal(np.array(vals, np.float32), s[order])
    assert pos == order.tolist()


# --------------------------------------------- the merge in the last CTA

def _tile_lists(s, tile_n, k, n):
    """Per tile, warp_topk's k finalists: (value desc, position asc),
    rows past n scoring NEG; s is (B, N) with NEG for inactive rows."""
    b = s.shape[0]
    ntiles = -(-n // tile_n)
    pad = np.full((b, ntiles * tile_n), np.float32(k1.NEG), np.float32)
    pad[:, :n] = s
    lists = []
    for t in range(ntiles):
        sc = pad[:, t * tile_n:(t + 1) * tile_n]
        order = np.lexsort((np.arange(tile_n)[None].repeat(b, 0), -sc),
                           axis=1)[:, :k]
        lists.append((np.take_along_axis(sc, order, 1), order + t * tile_n))
    return lists


def _argmax_passes(v, r, k):
    """k passes, each taking the best (value desc, row asc) entry."""
    v = list(v)
    out_v, out_r = [], []
    for _ in range(k):
        i = min(range(len(v)), key=lambda j: (-v[j], r[j]))
        out_v.append(v[i])
        out_r.append(r[i])
        v[i] = -np.inf
    return out_v, out_r


def _merge(lists, k, cap):
    """warp_merge: candidates are the entries >= L, the larger of the
    best tile's k-th value and (k <= 16) the k-th largest of the lanes'
    two best list heads (the real scores where L is NEG, then the first
    NEG entries in list order); past ``cap`` candidates, argmax passes over
    all lists."""
    b = lists[0][0].shape[0]
    neg = np.float32(k1.NEG)
    vals = np.empty((b, k), np.float32)
    rows = np.empty((b, k), np.int64)
    for q in range(b):
        fv = np.concatenate([lv[q] for lv, _ in lists])
        fr = np.concatenate([lr[q] for _, lr in lists])
        lo = max(lv[q, k - 1] for lv, _ in lists)
        if k <= 16:
            # the k-th largest of each lane's two best list heads
            heads = [sorted((lv[q, 0] for lv, _ in lists[lane::32]),
                            reverse=True)[:2] for lane in range(32)]
            flat = sorted((h for hs in heads for h in hs), reverse=True)
            if len(flat) >= k:
                lo = max(lo, flat[k - 1])
        keep = fv > neg if lo <= neg else fv >= lo
        if keep.sum() > cap:
            got = _argmax_passes(fv, fr, k)
        else:
            got = _argmax_passes(fv[keep], fr[keep], min(int(keep.sum()), k))
            fill = np.flatnonzero(fv <= neg)[:k - len(got[0])]
            got = (got[0] + [neg] * len(fill), got[1] + list(fr[fill]))
        vals[q], rows[q] = got
    return vals, rows


@pytest.mark.parametrize("n,tile_n,k,p_live,cap", [
    (1000, 32, 4, 0.7, 1024), (513, 64, 64, 0.7, 1024), (64, 8, 8, 0.7, 1024),
    (5, 8, 4, 0.7, 1024), (300, 16, 16, 0.7, 1024),
    (2000, 24, 4, 0.03, 1024),      # L is NEG: real scores, then NEG rows
    (2000, 24, 16, 0.5, 8),         # candidates overflow: passes over all
    (8192, 16, 16, 0.8, 512)])      # tiles of k rows: the heads bound
def test_merge_of_tile_lists_is_the_stable_top_k(n, tile_n, k, p_live, cap):
    rng = np.random.default_rng(n + k)
    b, d = 3, 16
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb[n // 2:n // 2 + min(4, n // 2)] = emb[:min(4, n // 2)]  # exact ties
    act = rng.random(n) < p_live
    q = np.concatenate([emb[:1], rng.standard_normal((b - 1, d))]).astype(
        np.float32)
    want_v, want_r = k1.ann_topk_plain(torch.from_numpy(emb),
                                       torch.from_numpy(act),
                                       torch.from_numpy(q), k)
    # the same scores the plain version ranks, NEG where inactive
    s = (torch.from_numpy(q) @ torch.from_numpy(emb).T).numpy()
    s = np.where(act[None], s, np.float32(k1.NEG)).astype(np.float32)
    vals, rows = _merge(_tile_lists(s, tile_n, k, n), k, cap)
    np.testing.assert_array_equal(vals, want_v.numpy())
    real = vals > k1.NEG / 2
    np.testing.assert_array_equal(rows[real], want_r.numpy()[real])
