"""The "grouped" design of the routed scans above 64 slots, unsharded
(kernels 3 and 4, ``ann_topk_ivf`` / ``ann_topk_ivf_quant``) and
shard-owned (kernel 5, ``ann_topk_ivf_sharded`` /
``ann_topk_ivf_quant_sharded``): its plan (``ann_topk_ivf.grouped_plan``:
the tile, the probes a group, the shared memory, the scratch), the C
entry point's arguments, and a numpy rehearsal of its three steps and of
the sharded writer against the plain versions.

The CUDA kernels run only on the card, where chip_smoke.py holds them
bitwise against "block", "chunked" and the plain versions. The rehearsal
repeats ``csrc/ann_topk_ivf.cu``'s steps in numpy:

1. ``ivf_grouped_probes``: the enabled, in-range probes grouped by bucket
   with a counting sort (counts, their exclusive scan, at most qb probes a
   group); the order within a bucket comes from atomics on the card, so
   the rehearsal shuffles it;
2. ``ivf_grouped``: per (group, tile of T slots), each probe's best
   min(k, T) of the tile's T entries, an invalid slot and a slot past cap
   NEG at its own slot, in ranks_before order (value descending, then
   slot ascending); straight into the probe's row where the bucket is one
   tile (NEG and slot p past T), else a tile list of min(k, T);
3. in the group's last CTA, where the lists hold k each and their network
   fits shared memory (``shared_merge``), ``merge_lists``: Lv, the largest
   k-th entry of the lists (k entries are at or above it); the entries
   above it, at most k - 1 a list, sorted by one network
   (``block_sort``), the first k of them finalists; where fewer than k are
   above Lv, the rest are entries equal to Lv in list order. Else
   ``merge_levels``: the lists merged two by two (``merge_path``), each
   cut to k, level after level in device memory, a pad on the last level
   NEG at its own position.

The sharded writer (kernel 5) groups only the probes whose bucket a
shard owns (the last shard whose first cut point is at or below it, if
the bucket lies below its next cut point) and writes every other probe's
(S, k) column NEG / -1 in step 1; step 2 writes a probe's finalists in
its owner's row (from the tile, or from the last CTA's merge), that CTA
then maps their slots to global rows (-1 where the value is NEG), and the
tile-0 CTA of each group writes its probes' other S - 1 rows NEG / -1.

Each must give its plain version's output bitwise, the slots of NEG
entries and pads included, and the sharded writer every entry of the
stacks exactly once. The inputs are integer-valued (the int8 rows with
their scales), so every summation order gives the same fp32 sums.
"""
import contextlib
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ann_topk_ivf as ivf
from repro_torch.kernels import ann_topk_sharded as sh
from repro_torch.kernels.ann_topk import NEG

torch.set_num_threads(1)

NEG32 = np.float32(NEG)


# ------------------------------------------------ the numpy rehearsal

def _owner(bounds, c):
    """csrc/ann_topk_ivf.cu::owner_of for the cluster ids ``c``: the last
    shard whose first cut point is at or below it, if it lies below that
    shard's next one; else -1."""
    bounds = np.asarray(bounds)
    s = np.searchsorted(bounds[:-1], c, side="right") - 1
    at = np.clip(s, 0, len(bounds) - 2)
    return np.where((s >= 0) & (c < bounds[at + 1]), at, -1)


def _group(sel, en, c, qb, rng, bounds=None):
    """Step 1: (order, groups), groups as (bucket, first, count) in bucket
    order; the probes of a bucket in a shuffled order. With ``bounds``
    (the sharded writer) only the probes whose bucket a shard owns."""
    flat_sel, flat_en = sel.reshape(-1), en.reshape(-1)
    ok = (flat_en != 0) & (flat_sel >= 0) & (flat_sel < c)
    if bounds is not None:
        ok &= _owner(bounds, flat_sel) >= 0
    cnt = np.bincount(flat_sel[ok], minlength=c)
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    order = np.empty(int(ok.sum()), np.int64)
    for b in range(c):
        mine = np.flatnonzero(ok & (flat_sel == b))
        order[start[b]:start[b] + len(mine)] = rng.permutation(mine)
    groups = [(b, start[b] + i, min(qb, cnt[b] - i))
              for b in range(c) for i in range(0, cnt[b], qb)]
    return order, groups


def _best(v, r, n):
    """The n best (value, slot) pairs in ranks_before order."""
    o = np.lexsort((r, -v.astype(np.float64)))[:n]
    return v[o], r[o]


def _tile_best(scores, valid, s0, tile, cap, kt):
    """Step 2 for one (probe, tile): its tile entries, invalid slots and
    slots past cap NEG at their own slot, and their kt best."""
    v = np.full(tile, NEG32, np.float32)
    m = min(tile, cap - s0)
    live = valid[s0:s0 + m]
    v[:m][live] = scores[s0:s0 + m][live]
    return _best(v, np.arange(s0, s0 + tile), kt)


def _last_at_most(a, x):
    return int(np.searchsorted(a, x, side="right")) - 1


def _merge(lv_, lr_, k):
    """Step 3: the probe's k best of its (ntiles, k) lists."""
    lv = lv_[:, k - 1].max()
    above = (lv_ > lv).sum(1)
    at_lv = (lv_ == lv).sum(1)
    assert (above <= k - 1).all()
    off_at = np.concatenate([[0], np.cumsum(at_lv)[:-1]])
    na = int(above.sum())
    # the entries above Lv, a prefix of each list, in one sorted network
    cand_v = np.concatenate([lv_[t, :above[t]] for t in range(len(lv_))])
    cand_r = np.concatenate([lr_[t, :above[t]] for t in range(len(lv_))])
    ov, oi = np.empty(k, np.float32), np.empty(k, np.int64)
    n = min(k, na)
    ov[:n], oi[:n] = _best(cand_v, cand_r, n)
    for j in range(k - na):
        t = _last_at_most(off_at, j)
        ov[na + j] = lv_[t, above[t] + j - off_at[t]]
        oi[na + j] = lr_[t, above[t] + j - off_at[t]]
    return ov, oi


def _merge_levels(lv_, lr_, k):
    """Step 3 in device memory: the (ntiles, kt) lists merged two by two,
    each merge cut to k, a last list without a partner merged with
    nothing; every level but the last within one half of the probe's
    scratch (``level_entries``); pads (-inf, INT_MAX) on the last level
    NEG at their own position."""
    ntiles, kt = lv_.shape
    half = ivf.level_entries(ntiles, kt, k)
    lists = list(zip(lv_, lr_))
    while True:
        last = len(lists) <= 2
        nlen = k if last else min(2 * len(lists[0][0]), k)
        nxt = []
        for o in range(0, len(lists), 2):
            pair = lists[o:o + 2]
            v = np.concatenate([x[0] for x in pair])
            r = np.concatenate([x[1] for x in pair])
            pad = nlen - len(v)
            if pad > 0:
                v = np.concatenate([v, np.full(pad, -np.inf, np.float32)])
                r = np.concatenate([r, np.full(pad, 2**31 - 1)])
            nxt.append(_best(v, r, nlen))
        if last:
            v, r = nxt[0]
            pads = v == -np.inf
            return (np.where(pads, NEG32, v).astype(np.float32),
                    np.where(pads, np.arange(k), r))
        assert len(nxt) * nlen <= half
        lists = nxt


def _grouped(sel, en, scores, valid, k, tile, qb, rng, bounds=None,
             rows=None):
    """The whole design: scores (B, C, cap) the fp32 score of every slot
    of every bucket against every query. Unsharded: (B, nprobe, k) vals
    and slots. With ``bounds`` and ``rows`` (bucket_rows, (C, cap)) the
    sharded writer: (S, B, nprobe, k) vals and global rows, each entry
    written once (an entry left unwritten would stay NaN / -7)."""
    b, nprobe = sel.shape
    c, cap = valid.shape
    p = b * nprobe
    ntiles = -(-cap // tile)
    kt = min(k, tile)
    n_s = 1 if bounds is None else len(bounds) - 1
    vals = np.full((n_s, p, k), np.nan, np.float32)
    slots = np.full((n_s, p, k), -7, np.int64)
    written = np.zeros((n_s, p, k), np.int64)

    def write(s, bj, v, r, at=slice(None)):
        vals[s, bj, at], slots[s, bj, at] = v, r
        written[s, bj, at] += 1

    order, groups = _group(sel, en, c, qb, rng, bounds)
    assert len(groups) <= ivf.grouped_groups(p, c, qb)
    # step 1: every probe no group takes, its whole column
    for bj in sorted(set(range(p)) - set(order.tolist())):
        for s in range(n_s):
            write(s, bj, NEG32, np.arange(k) if bounds is None else -1)
    owner = [0 if bounds is None else int(_owner(bounds, bucket))
             for bucket, _, _ in groups]
    lists_v = np.zeros((p, ntiles, kt), np.float32)
    lists_r = np.zeros((p, ntiles, kt), np.int64)

    def to_rows(g, bj):
        """The sharded writer's slot -> global row map of a final row."""
        if bounds is not None:
            s, bucket = owner[g], groups[g][0]
            live = vals[s, bj] > NEG / 2
            slots[s, bj] = np.where(
                live, rows[bucket][np.where(live, slots[s, bj], 0)], -1)

    # step 2: the grid's CTAs in any order: each writes only its own
    # lists, or its own probes' rows
    for g, t in rng.permutation([(g, t) for g in range(len(groups))
                                 for t in range(ntiles)]):
        bucket, first, count = groups[g]
        for bj in order[first:first + count]:
            if bounds is not None and t == 0:
                for s in set(range(n_s)) - {owner[g]}:
                    write(s, bj, NEG32, -1)
            v, r = _tile_best(scores[bj // nprobe, bucket], valid[bucket],
                              t * tile, tile, cap, kt)
            if ntiles == 1:
                pad = np.arange(kt, k)                # NEG and slot p
                write(owner[g], bj, np.concatenate(
                    [v, np.full(k - kt, NEG32, np.float32)]),
                    np.concatenate([r, pad]))
                to_rows(g, bj)
            else:
                lists_v[bj, t], lists_r[bj, t] = v, r
    # step 3: the group's last CTA
    merge = _merge if ivf.shared_merge(ntiles, tile, k) else _merge_levels
    if ntiles > 1:
        for g, (bucket, first, count) in enumerate(groups):
            for bj in order[first:first + count]:
                write(owner[g], bj, *merge(lists_v[bj], lists_r[bj], k))
                to_rows(g, bj)
    assert (written == 1).all()
    shape = (b, nprobe, k) if bounds is None else (n_s, b, nprobe, k)
    return vals.reshape(shape), slots.reshape(shape).astype(np.int32)


# --------------------------------------------------------- the inputs

def _scores(args, quant):
    """The score of every slot of every bucket against every query,
    (B, C, cap), as the plain version computes it."""
    if quant:
        bq, bs, qq, qs = args
        dots = np.einsum("cnd,bd->bcn", bq.astype(np.int64),
                         qq.astype(np.int64)).astype(np.float32)
        return (dots * bs[None] * qs[:, None, None]).astype(np.float32)
    buckets, q = args
    return np.einsum("cnd,bd->bcn", buckets, q).astype(np.float32)


def _case(c, cap, d, b, nprobe, p_valid, seed, quant):
    """Integer-valued inputs (int8 rows and queries with scales of a few
    bits), their scores, and the rng."""
    rng = np.random.default_rng(seed)
    valid = rng.random((c, cap)) < p_valid
    sel = rng.integers(0, c, (b, nprobe)).astype(np.int32)
    en = (rng.random((b, nprobe)) > 0.15).astype(np.int32)
    if quant:
        args = (rng.integers(-127, 128, (c, cap, d)).astype(np.int8),
                (rng.integers(1, 64, (c, cap)) / 64).astype(np.float32),
                rng.integers(-127, 128, (b, d)).astype(np.int8),
                (rng.integers(1, 64, b) / 32).astype(np.float32))
    else:
        args = (rng.integers(-3, 4, (c, cap, d)).astype(np.float32),
                rng.integers(-3, 4, (b, d)).astype(np.float32))
    return rng, sel, en, valid, _scores(args, quant), args


def _plain(sel, en, valid, args, k, quant):
    """The plain version, a sel outside [0, C) as a disabled probe."""
    c = valid.shape[0]
    inside = (sel >= 0) & (sel < c)
    t = torch.from_numpy
    sel_t = t(np.where(inside, sel, 0).astype(np.int32))
    en_t = t((en * inside).astype(np.int32))
    if quant:
        bq, bs, qq, qs = args
        out = ivf.ann_topk_ivf_quant_plain(sel_t, en_t, t(qq), t(qs), t(bq),
                                           t(bs), t(valid), k)
    else:
        buckets, q = args
        out = ivf.ann_topk_ivf_plain(sel_t, en_t, t(q), t(buckets),
                                     t(valid), k)
    return [x.numpy() for x in out]


def _same(got, want):
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])


# (c, cap, d, b, nprobe, p_valid): small tiles and several of them
SHAPES = [(6, 200, 16, 3, 4, 0.6), (4, 96, 8, 5, 3, 0.3),
          (5, 130, 12, 2, 5, 0.9)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("qb", ivf.GROUPED_QBS)
@pytest.mark.parametrize("k,tile", [(1, 32), (4, 32), (16, 64), (32, 32),
                                    (7, 96), (5, 256)])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_grouped_is_the_plain_version(shape, k, tile, qb, quant):
    """Every tile and group size gives the plain version bitwise, NEG
    slots and pads included; a bucket of one tile (T >= cap) writes its
    probes' rows straight, with k above cap padded."""
    c, cap, d, b, nprobe, p_valid = shape
    rng, sel, en, valid, scores, args = _case(c, cap, d, b, nprobe,
                                              p_valid, k + tile + qb, quant)
    _same(_grouped(sel, en, scores, valid, k, tile, qb, rng),
          _plain(sel, en, valid, args, k, quant))


@pytest.mark.parametrize("k", [3, 130, 257])
@pytest.mark.parametrize("tile", [32, 64, 160, 224, 256])
def test_k_above_the_tile_and_the_cap(k, tile):
    """k above the tile: lists of the tile's entries, merged by levels in
    device memory (the plan takes it, with the levels' scratch); k above
    cap: the slots past cap are pads cap, cap + 1, ... after the invalid
    slots ascending."""
    c, cap = 3, 150
    rng, sel, en, valid, scores, args = _case(c, cap, 8, 2, 3, 0.4, k,
                                              False)
    plan = ivf.grouped_plan(2, 3, c, cap, 8, k, False, tile=tile)
    assert plan["merge"] == ("none" if tile >= cap else "levels"
                             if k > tile else "shared")
    assert plan["lists"] == (0 if tile >= cap else
                             6 * plan["ntiles"] * min(k, tile))
    got = _grouped(sel, en, scores, valid, k, tile, 4, rng)
    want = _plain(sel, en, valid, args, k, False)
    _same(got, want)
    if k > cap:
        real = want[0] > NEG / 2
        assert (want[1][~real] >= 0).all() and not real[..., cap:].any()


def test_all_invalid_and_unprobed_buckets():
    """A bucket with no valid slot gives NEG at slots 0 .. k - 1 (its
    invalid slots ascending) across its tiles; buckets nobody probes make
    no group."""
    c, cap, k = 8, 300, 6
    rng, sel, en, valid, scores, args = _case(c, cap, 8, 4, 3, 0.5, 1,
                                              False)
    valid[2] = False
    sel[:, 0] = 2
    sel[:, 1:] = np.clip(sel[:, 1:], 3, c - 1)    # 0 and 1 never probed
    en[:] = 1
    got = _grouped(sel, en, scores, valid, k, 64, 4, rng)
    _same(got, _plain(sel, en, valid, args, k, False))
    assert (got[0][:, 0] == NEG32).all()
    assert (got[1][:, 0] == np.arange(k)).all()
    _, groups = _group(sel, en, c, 4, rng)
    assert {g[0] for g in groups} <= set(range(2, c))


@pytest.mark.parametrize("quant", [False, True])
def test_disabled_and_out_of_range_probes(quant):
    """A disabled probe, and a sel of -1 or C, write NEG and slot p and
    join no group."""
    c, cap, k = 5, 200, 5
    rng, sel, en, valid, scores, args = _case(c, cap, 16, 3, 4, 0.7, 2,
                                              quant)
    sel[0, 1], sel[1, 2], en[2, 0] = -1, c, 0
    order, _ = _group(sel, en, c, 4, rng)
    assert not {1, 6, 8} & set(order.tolist())
    got = _grouped(sel, en, scores, valid, k, 64, 4, rng)
    _same(got, _plain(sel, en, valid, args, k, quant))
    for bq, j in ((0, 1), (1, 2), (2, 0)):
        assert (got[0][bq, j] == NEG32).all()
        assert (got[1][bq, j] == np.arange(k)).all()


@pytest.mark.parametrize("qb", ivf.GROUPED_QBS)
def test_one_query_probing_one_bucket_several_times(qb):
    """The probes of one query on one bucket share a group where qb
    allows and each gets the same row; the order within a group does not
    matter (the rehearsal shuffles it)."""
    c, cap, k = 4, 256, 8
    rng, sel, en, valid, scores, args = _case(c, cap, 8, 3, 6, 0.5, 3,
                                              False)
    sel[sel == 1] = 2
    sel[0] = 1
    sel[1, :4] = 1
    en[:] = 1
    want = _plain(sel, en, valid, args, k, False)
    for seed in range(3):
        got = _grouped(sel, en, scores, valid, k, 64, qb,
                       np.random.default_rng(seed))
        _same(got, want)
        assert all((got[0][0, j] == got[0][0, 0]).all() for j in range(6))
    _, groups = _group(sel, en, c, qb, rng)
    assert sum(cnt for b, _, cnt in groups if b == 1) == 10
    assert sum(1 for b, _, _ in groups if b == 1) == -(-10 // qb)


@pytest.mark.parametrize("quant", [False, True])
def test_duplicate_rows_in_two_tiles_tie_to_the_lower_slot(quant):
    """A row copied into slots of other tiles scores bitwise the same, and
    above every other row of its bucket: the lower slot ranks first across
    the tiles' lists."""
    c, cap, d, k = 3, 256, 8, 5
    rng, sel, en, valid, _, args = _case(c, cap, d, 2, 3, 1.0, 4, quant)
    dups = [200, 10, 70, 140]                    # tiles 3, 0, 1, 2 of 64
    top = 127 if quant else 3
    args[0][:, dups] = top                       # the largest dot product
    if quant:
        args[1][:, dups] = 1.0                   # above every other scale
    args[2 if quant else 1][:] = top
    en[:] = 1
    scores = _scores(args, quant)
    want = _plain(sel, en, valid, args, k, quant)
    got = _grouped(sel, en, scores, valid, k, 64, 4, rng)
    _same(got, want)
    assert (got[1][..., :4] == sorted(dups)).all()
    assert (got[0][..., :4] == got[0][..., :1]).all()


@pytest.mark.parametrize("merge", [_merge, _merge_levels])
def test_merge_takes_ties_at_the_threshold_in_slot_order(merge):
    """Lists whose k-th entries tie (int8-like scores, many equal values
    across tiles, NEG tails): either merge equals the stable sort."""
    rng = np.random.default_rng(5)
    for _ in range(50):
        ntiles, tile, k = rng.integers(2, 9), 32, int(rng.integers(1, 33))
        s = rng.integers(-2, 3, ntiles * tile).astype(np.float32)
        s[rng.random(s.size) < 0.4] = NEG32
        r = np.arange(s.size)
        lists = [_best(s[t * tile:(t + 1) * tile],
                       r[t * tile:(t + 1) * tile], k) for t in range(ntiles)]
        got = merge(np.stack([x[0] for x in lists]),
                    np.stack([x[1] for x in lists]), k)
        want = _best(s, r, k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# ------------------------------------------- kernel 5's sharded writer

# cut points over C = 6 clusters: one shard; three, one of them empty;
# eight, three empty; C + 3 = 9, four empty; and two shards that leave
# clusters 0 and 5 unowned
CUTS = {"s1": [0, 6], "s3": [0, 2, 2, 6], "s8": [0, 0, 1, 1, 3, 4, 6, 6, 6],
        "s9": [0, 0, 0, 1, 2, 3, 3, 4, 5, 6], "unowned": [1, 3, 5]}


def _rows(rng, valid):
    """bucket_rows: distinct global rows, ascending within a bucket (so
    the lower slot is the lower row), -1 at the invalid slots."""
    c, cap = valid.shape
    rows = np.sort(rng.choice(4 * c * cap, (c, cap), replace=False), axis=1)
    return np.where(valid, rows, -1).astype(np.int32)


def _plain_sharded(sel, en, valid, rows, bounds, args, k, quant):
    t = torch.from_numpy
    tail = (t(valid), t(rows), t(np.asarray(bounds, np.int32)))
    if quant:
        bq, bs, qq, qs = args
        out = sh.ann_topk_ivf_quant_sharded_plain(
            t(sel), t(en), t(qq), t(qs), t(bq), t(bs), *tail, k)
    else:
        buckets, q = args
        out = sh.ann_topk_ivf_sharded_plain(t(sel), t(en), t(q), t(buckets),
                                            *tail, k)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("qb", ivf.GROUPED_QBS)
@pytest.mark.parametrize("k,tile", [(4, 64), (16, 256), (100, 64),
                                    (70, 256), (257, 96)])
@pytest.mark.parametrize("cuts", sorted(CUTS))
def test_sharded_grouped_is_the_plain_version(cuts, k, tile, qb, quant):
    """The sharded writer's stacks are the plain version's bitwise: global
    rows, NEG / -1 at every other shard and for the disabled, out-of-range
    and unowned probes; one tile (T >= cap) and several, k above the tile
    (merged by levels), above K_MAX and above cap; empty shards."""
    c, cap, d, b, nprobe = 6, 200, 16, 3, 4
    rng, sel, en, valid, scores, args = _case(c, cap, d, b, nprobe, 0.6,
                                              k + tile + qb, quant)
    sel[0, 1], sel[2, 3] = -1, c
    rows = _rows(rng, valid)
    want = _plain_sharded(sel, en, valid, rows, CUTS[cuts], args, k, quant)
    got = _grouped(sel, en, scores, valid, k, tile, qb, rng, CUTS[cuts],
                   rows)
    _same(got, want)
    assert (got[1][..., 0, 1, :] == -1).all()
    assert (got[1][got[0] <= NEG / 2] == -1).all()


@pytest.mark.parametrize("qb", ivf.GROUPED_QBS)
def test_sharded_one_query_probing_one_bucket_several_times(qb):
    """Every probe of one query on one bucket gets the same column, at
    the bucket's owner, whatever the group size and the order within a
    group."""
    c, cap, k, cuts = 6, 256, 8, CUTS["s3"]
    rng, sel, en, valid, scores, args = _case(c, cap, 8, 3, 6, 0.5, 3,
                                              False)
    sel[0] = 3
    sel[1, :4] = 3
    en[:] = 1
    rows = _rows(rng, valid)
    want = _plain_sharded(sel, en, valid, rows, cuts, args, k, False)
    for seed in range(3):
        got = _grouped(sel, en, scores, valid, k, 64, qb,
                       np.random.default_rng(seed), cuts, rows)
        _same(got, want)
        assert all((got[1][:, 0, j] == got[1][:, 0, 0]).all()
                   for j in range(6))
        assert (got[1][2, 0] >= 0).any() and (got[1][:2, 0] == -1).all()


@pytest.mark.parametrize("quant", [False, True])
def test_sharded_duplicate_rows_in_two_tiles_tie_to_the_lower_slot(quant):
    """A row copied into slots of other tiles ties bitwise across the
    tiles' lists; the lower slot, and so the lower global row, ranks
    first at the owner."""
    c, cap, d, k, cuts = 3, 256, 8, 5, [0, 1, 1, 3]
    rng, sel, en, valid, _, args = _case(c, cap, d, 2, 3, 1.0, 4, quant)
    dups = [200, 10, 70, 140]                    # tiles 3, 0, 1, 2 of 64
    top = 127 if quant else 3
    args[0][:, dups] = top
    if quant:
        args[1][:, dups] = 1.0
    args[2 if quant else 1][:] = top
    en[:] = 1
    rows = _rows(rng, valid)
    scores = _scores(args, quant)
    want = _plain_sharded(sel, en, valid, rows, cuts, args, k, quant)
    got = _grouped(sel, en, scores, valid, k, 64, 4, rng, cuts, rows)
    _same(got, want)
    owner = _owner(cuts, sel)
    for bi in range(2):
        for j in range(3):
            r = got[1][owner[bi, j], bi, j, :4]
            assert (r == rows[sel[bi, j], sorted(dups)]).all()


def test_sharded_at_one_shard_is_the_unsharded_rows():
    """At S = 1 the stacks are the unsharded "grouped" output with each
    real finalist's slot mapped to its global row, -1 elsewhere."""
    c, cap, k = 6, 300, 12
    rng, sel, en, valid, scores, args = _case(c, cap, 16, 4, 3, 0.4, 7,
                                              False)
    rows = _rows(rng, valid)
    one = _grouped(sel, en, scores, valid, k, 64, 4, rng, [0, c], rows)
    vals, slots = _grouped(sel, en, scores, valid, k, 64, 4, rng)
    inside = np.clip(sel, 0, c - 1)[..., None]
    real = vals > NEG / 2
    _same((one[0][0], one[1][0]),
          (vals, np.where(real, rows[inside, np.where(real, slots, 0)], -1)))


# ------------------------------------------------------------ the plan

def test_grouped_takes_every_unsharded_scan_above_64_slots():
    """Kernels 3 and 4 above 64 slots, and kernel 5 (``sharded``) at the
    same shapes, where it took "block" or "chunked" before."""
    for cap in (65, 128, 4096, 65536, 2**20):
        for k in (1, 4, 16, 64, 100):
            for quant in (False, True):
                assert ivf.pick_design(cap, k, 768, quant, False) == \
                    "grouped"
                assert ivf.pick_design(cap, k, 768, quant, True) == \
                    "grouped"
    assert ivf.pick_design(64, 100, 128, False, False) == "grouped"
    assert ivf.pick_design(64, 64, 128, False, False) == "warp"


@pytest.mark.parametrize("b,nprobe,c,cap,k", [
    (1, 64, 512, 4096, 4), (16, 64, 512, 4096, 16), (4, 4, 16, 65536, 4),
    (4, 4, 16, 65536, 100), (1, 8, 64, 100, 4), (4, 128, 256, 64, 100),
    (2, 3, 5, 2**20, 1), (1, 1, 1, 33, 1000), (4, 4, 16, 65536, 6000),
    (4, 4, 2, 2**20, 500), (1, 4, 8, 100000, 60000)])
def test_tile_pick(b, nprobe, c, cap, k):
    """A multiple of the row step, at most GROUPED_TILE_LARGEST; at least k
    and few enough tiles for the shared-memory merge where that tile's
    scan fits, else the largest tile (lists merged in device memory); a
    pure function of the shape; at one query's 64 probes over the
    real-size router's buckets the grid fills the card (GROUPED_FILL
    CTAs, about 16 on each of 132 SMs)."""
    tile = ivf.grouped_tile(b, nprobe, c, cap, 768, k, False)
    assert tile == ivf.grouped_tile(b, nprobe, c, cap, 768, k, False)
    assert tile % ivf.GROUP_ROWS == 0 and tile >= ivf.GROUP_ROWS
    assert tile <= ivf.GROUPED_TILE_LARGEST
    ntiles = -(-cap // tile)
    if tile < ivf.GROUPED_TILE_LARGEST:
        assert ntiles == 1 or tile >= k
        assert ntiles <= ivf.grouped_lists(k)
        assert tile <= max(ivf.GROUPED_TILE_MAX, k + 31,
                           -(-cap // ivf.grouped_lists(k)) + 31) \
            or ntiles == 1
    else:
        assert ntiles == 1 or tile < k or ntiles > ivf.grouped_lists(k) \
            or ivf.GROUPED_TILE_LARGEST - 32 < -(-cap // ivf.grouped_lists(k))
    assert tile >= 128 or ntiles == 1      # 384 KiB of fp32 rows at D 768
    assert ivf.grouped_tile(b, nprobe, c, cap, 768, k, True) >= \
        min(512, -(-cap // 32) * 32)        # the same of int8 rows
    if (b, nprobe, cap) == (1, 64, 4096):
        assert min(b * nprobe, c) * ntiles >= ivf.GROUPED_FILL
    plan = ivf.grouped_plan(b, nprobe, c, cap, 768, k, False)
    assert plan["smem"] <= ivf.GROUPED_SMEM and plan["tile"] == tile


def test_group_size_pick():
    """qb: the smaller of 1 and 4 at or above twice the mean probes a
    bucket, else 4."""
    assert ivf.grouped_qb(1, 64, 512) == 1
    assert ivf.grouped_qb(4, 64, 512) == 1
    assert ivf.grouped_qb(16, 64, 512) == 4
    assert ivf.grouped_qb(4, 4, 16) == 4
    assert ivf.grouped_qb(64, 512, 16) == 4


@pytest.mark.parametrize("seed", range(5))
def test_group_count_bounds_the_grid(seed):
    """grouped_groups bounds the groups of any sel: repeated buckets,
    disabled probes, all probes on one bucket."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        b, nprobe, c = (int(x) for x in rng.integers(1, 9, 3))
        sel = rng.integers(0, c, (b, nprobe))
        if rng.random() < 0.3:
            sel[:] = 0
        en = (rng.random((b, nprobe)) < 0.8).astype(np.int32)
        for qb in ivf.GROUPED_QBS:
            _, groups = _group(sel, en, c, qb, rng)
            assert len(groups) <= ivf.grouped_groups(b * nprobe, c, qb)


def test_shared_memory_and_scratch_are_the_kernels_layout():
    """csrc/ann_topk_ivf.cu::grouped_scan_bytes and merge_bytes: scores,
    slots, the warps' buffers and queries on 16 bytes each; the merge's
    counts, scans, ranks and scan scratch; GroupScratch::ints."""
    assert ivf.grouped_smem(4, 1024, 768, 4096, 4, False) == \
        4 * 1024 * 4 + 1024 * 4 + 4096 + 4 * 768 * 4
    assert ivf.grouped_smem(1, 96, 50, 96, 4, True) == \
        384 + 384 + 4096 + 64
    assert ivf.merge_bytes(32768, 4) == \
        524336 + 131072 * 8               # (4 * 32768 + 9) * 4 on 16
    assert ivf.grouped_smem(1, 32, 8, 2**20, 4, False, True) == \
        32 * 4 + 32 * 4 + 4096            # its lists merge by levels
    assert ivf.grouped_smem(1, 64, 8, 2**14, 4, False, True) == \
        ivf.merge_bytes(256, 4) == 4144 + 1024 * 8
    assert ivf.grouped_smem(1, 64, 8, 640, 1, False) == \
        64 * 4 + 64 * 4 + 4096 + 32
    plan = ivf.grouped_plan(16, 64, 512, 4096, 768, 16, True)
    assert plan["scratch"] == 3 * 512 + 1024 + 4 * plan["groups"] + 1
    assert plan["lists"] == 1024 * plan["ntiles"] * 16
    text = (Path(ivf.__file__).parent / "csrc" / "ann_topk_ivf.cu").read_text()
    assert "scratch: 3 c + P + 4 groups + 1 int32" in text
    assert "return tile >= k && merge_bytes(ntiles, k) <= GROUPED_SMEM;" in text
    assert "constexpr size_t GROUPED_SMEM = SMEM_MAX - 1024;" in text
    assert ivf.GROUPED_SMEM == ivf.SMEM_MAX - 1024
    assert ivf.grouped_smem(1, ivf.GROUPED_TILE_LARGEST, 8, 2**20, 4, False,
                            True) <= ivf.GROUPED_SMEM < ivf.grouped_smem(
        1, ivf.GROUPED_TILE_LARGEST + 32, 8, 2**20, 4, False, True)
    assert "cnt = (cnt + 1) / 2;\n    len = 2 * len < k ? 2 * len : k;" \
        in text
    assert ("align16((4 * static_cast<size_t>(ntiles) + WARPS + 1) * "
            "sizeof(int))") in text


def test_wide_queries_shrink_the_group_then_read_in_place():
    """qb comes down until the queries fit; past one query's worth of
    shared memory the query is read in place (qb 1)."""
    assert ivf.grouped_plan(16, 64, 512, 4096, 4096, 4, False)["qb"] == 4
    wide = ivf.grouped_plan(16, 64, 512, 4096, 16384, 4, False)
    assert (wide["qb"], wide["qglobal"]) == (1, False)
    huge = ivf.grouped_plan(16, 64, 512, 4096, 60000, 4, False)
    assert (huge["qb"], huge["qglobal"]) == (1, True)
    assert huge["smem"] <= ivf.GROUPED_SMEM


def test_plan_refuses_what_the_kernel_cannot_take():
    """Only a tile or group size given by the caller can be refused; the
    picked plan takes any shape (below)."""
    with pytest.raises(ValueError, match="multiple of 32"):
        ivf.grouped_plan(1, 4, 8, 1000, 16, 4, False, tile=48)
    with pytest.raises(ValueError, match="qb 2"):
        ivf.grouped_plan(1, 4, 8, 1000, 16, 4, False, qb=2)
    with pytest.raises(ValueError, match="cap=100000 .*design=grouped"):
        ivf.grouped_plan(1, 4, 8, 100000, 16, 60000, False,
                         tile=ivf.GROUPED_TILE_LARGEST + 32)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b,nprobe,c,cap,d,k", [
    (4, 4, 16, 65536, 768, 6000), (4, 4, 2, 2**20, 64, 500),
    (4, 4, 2, 2**20, 768, 500), (1, 4, 8, 100000, 16, 60000),
    (16, 64, 512, 4096, 768, 5000), (2, 3, 5, 2**24, 768, 1),
    (1, 1, 1, 2**20, 4096, 40000), (8, 8, 4, 200000, 30000, 64)])
def test_plan_takes_any_k_at_any_cap(b, nprobe, c, cap, d, k, quant):
    """Large k at large caps (which a network in shared memory cannot
    merge): the plan fits shared memory and merges by levels, with the
    scratch for them."""
    plan = ivf.grouped_plan(b, nprobe, c, cap, d, k, quant)
    assert plan["smem"] <= ivf.GROUPED_SMEM
    assert plan["tile"] <= ivf.GROUPED_TILE_LARGEST
    p, kt = b * nprobe, min(k, plan["tile"])
    if plan["ntiles"] > 1:
        assert plan["lists"] == p * plan["ntiles"] * kt
    assert plan["merge"] == ("none" if plan["ntiles"] == 1 else "shared"
                             if ivf.shared_merge(plan["ntiles"],
                                                 plan["tile"], k)
                             else "levels")
    assert plan["levels"] == (2 * p * ivf.level_entries(plan["ntiles"], kt, k)
                              if plan["merge"] == "levels" else 0)
    if (cap, k) in ((65536, 6000), (2**20, 500), (100000, 60000)):
        assert plan["merge"] == "levels"


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("cap,k,b,nprobe", [(65536, 6000, 1, 2),
                                            (2**20, 500, 1, 2)])
def test_large_k_at_a_large_cap_is_the_plain_version(cap, k, b, nprobe,
                                                     quant):
    """cap 65,536 at k 6000 and cap 2^20 at k 500 on the tile the plan
    picks (the largest, its lists past the network): the merge by levels
    gives the plain version bitwise, NEG slots included; one bucket all
    invalid past its first tile."""
    c, d = 2, 2
    rng, sel, en, valid, scores, args = _case(c, cap, d, b, nprobe, 0.5,
                                              cap + k, quant)
    sel[0] = [0, 1]
    en[:] = 1
    valid[1, 40000:] = False
    scores = _scores(args, quant)
    plan = ivf.grouped_plan(b, nprobe, c, cap, d, k, quant)
    assert plan["merge"] == "levels" and plan["ntiles"] > 2
    _same(_grouped(sel, en, scores, valid, k, plan["tile"], plan["qb"], rng),
          _plain(sel, en, valid, args, k, quant))


def test_level_scratch_holds_every_level():
    """level_entries bounds every level but the last, odd tile counts
    (a list without a partner) and lists cut to k included."""
    for ntiles in range(2, 70):
        for kt, k in ((1, 1), (3, 100), (10, 100), (32, 33), (500, 500),
                      (7, 1000)):
            most, cnt, length = 0, ntiles, kt
            sizes = []
            while cnt > 1:
                cnt = (cnt + 1) // 2
                length = k if cnt == 1 else min(2 * length, k)
                sizes.append(cnt * length)
            assert ivf.level_entries(ntiles, kt, k) == max(sizes[:-1],
                                                           default=0)


# ---------------------------------------- launch arguments, no card

def _fake(monkeypatch, err=0):
    calls = []

    def entry(*args):
        calls.append(args)
        return err
    lib = types.SimpleNamespace(ann_topk_ivf_grouped_launch=entry,
                                ann_topk_ivf_error_string=lambda e:
                                b"invalid argument")
    monkeypatch.setattr(ivf, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=9))
    for w in (ivf.ann_topk_ivf, ivf.ann_topk_ivf_quant,
              sh.ann_topk_ivf_sharded, sh.ann_topk_ivf_quant_sharded):
        for name in ("launches", "launches_grouped", "launches_block",
                     "launches_chunked"):
            monkeypatch.setattr(w, name, 0)
    return calls


def _small(quant, c=4, cap=300, d=16, b=2, nprobe=3):
    sel = torch.zeros((b, nprobe), dtype=torch.int32)
    en = torch.ones((b, nprobe), dtype=torch.int32)
    valid = torch.ones((c, cap), dtype=torch.bool)
    if quant:
        return (sel, en, torch.zeros((b, d), dtype=torch.int8),
                torch.ones(b), torch.zeros((c, cap, d), dtype=torch.int8),
                torch.ones((c, cap)), valid)
    return sel, en, torch.zeros(b, d), torch.zeros(c, cap, d), valid


@pytest.mark.parametrize("quant", [False, True])
def test_launch_passes_the_plan_and_the_scratch(monkeypatch, quant):
    calls = _fake(monkeypatch)
    w = ivf.ann_topk_ivf_quant if quant else ivf.ann_topk_ivf
    args = _small(quant)
    vals, idx = ivf._launch("grouped", w, *args, k=7, tile=64, qb=4)
    (call,) = calls
    plan = ivf.grouped_plan(2, 3, 4, 300, 16, 7, quant, tile=64, qb=4)
    assert call[0] == int(quant)
    ptrs = (args[0], args[1], args[2], args[3] if quant else None,
            args[4] if quant else args[3], args[5] if quant else None)
    assert call[1:7] == tuple(0 if t is None else t.data_ptr() for t in ptrs)
    assert call[8:11] == (0, 0, 1)                 # unsharded: no shards
    assert call[11:21] == (2, 3, 4, 300, 16, 7, 4, 64, plan["groups"], 0)
    assert plan["ntiles"] == 5 and plan["lists"] == 2 * 3 * 5 * 7
    assert plan["merge"] == "shared" and plan["levels"] == 0
    assert all(x != 0 for x in call[21:24])        # scratch and the lists
    assert call[24:26] == (0, 0)                   # no levels' scratch
    assert call[26:] == (vals.data_ptr(), idx.data_ptr(), 9)
    assert vals.shape == idx.shape == (2, 3, 7)
    assert (w.launches, w.launches_grouped, w.launches_block) == (1, 1, 0)


def test_one_tile_passes_no_lists(monkeypatch):
    calls = _fake(monkeypatch)
    ivf._launch("grouped", ivf.ann_topk_ivf, *_small(False, cap=100), k=4)
    (call,) = calls
    assert call[18] == 128 and call[22:26] == (0, 0, 0, 0)


@pytest.mark.parametrize("quant", [False, True])
def test_k_above_the_tile_passes_the_levels_scratch(monkeypatch, quant):
    calls = _fake(monkeypatch)
    w = ivf.ann_topk_ivf_quant if quant else ivf.ann_topk_ivf
    ivf._launch("grouped", w, *_small(quant), k=100, tile=64)
    (call,) = calls
    plan = ivf.grouped_plan(2, 3, 4, 300, 16, 100, quant, tile=64)
    assert plan["merge"] == "levels" and plan["ntiles"] == 5
    assert plan["lists"] == 6 * 5 * 64
    assert plan["levels"] == 2 * 6 * ivf.level_entries(5, 64, 100) > 0
    assert all(x != 0 for x in call[21:26])
    assert w.launches_grouped == 1


def test_query_read_in_place_is_on_16_bytes(monkeypatch):
    calls = _fake(monkeypatch)
    d = 60000
    sel = torch.zeros((2, 3), dtype=torch.int32)
    q = torch.zeros(2 * d + 1)[1:].view(2, d)           # off 16 bytes
    ivf._launch("grouped", ivf.ann_topk_ivf, sel, torch.ones_like(sel), q,
                torch.zeros(1, 100, d), torch.ones((1, 100), dtype=torch.bool),
                k=4)
    (call,) = calls
    assert call[20] == 1 and call[17] == 1               # qglobal, qb 1
    assert call[3] % 16 == 0 and call[3] != q.data_ptr()


def _small_sharded(quant, c=4, cap=300, cuts=(0, 2, 2, 4)):
    return (*_small(quant, c=c, cap=cap),
            torch.zeros((c, cap), dtype=torch.int32),
            torch.tensor(cuts, dtype=torch.int32))


@pytest.mark.parametrize("quant", [False, True])
def test_kernel_5s_grouped_launch_passes_the_shards(monkeypatch, quant):
    """Kernel 5 on "grouped": the same plan and scratch as kernel 3 or 4
    at the shape (none grows with S), bucket_rows, bounds and S passed
    to the C entry point, (S, B, nprobe, k) stacks, counted as its
    "grouped" launch."""
    calls = _fake(monkeypatch)
    w = sh.ann_topk_ivf_quant_sharded if quant else sh.ann_topk_ivf_sharded
    args = _small_sharded(quant)
    vals, idx = ivf._launch("grouped", w, *args, k=7, tile=64, qb=4)
    (call,) = calls
    plan = ivf.grouped_plan(2, 3, 4, 300, 16, 7, quant, tile=64, qb=4)
    assert call[0] == int(quant)
    assert call[7:11] == (args[-3].data_ptr(), args[-2].data_ptr(),
                          args[-1].data_ptr(), 3)  # valid, rows, bounds, S
    assert call[11:21] == (2, 3, 4, 300, 16, 7, 4, 64, plan["groups"], 0)
    assert all(x != 0 for x in call[21:24])
    assert call[26:] == (vals.data_ptr(), idx.data_ptr(), 9)
    assert vals.shape == idx.shape == (3, 2, 3, 7)
    assert (w.launches, w.launches_grouped, w.launches_block,
            w.launches_chunked) == (1, 1, 0, 0)


def test_failed_sharded_launch_names_s_the_shape_and_the_design(
        monkeypatch):
    _fake(monkeypatch, err=1)
    w = sh.ann_topk_ivf_sharded
    with pytest.raises(RuntimeError, match=r"ann_topk_ivf_sharded launch "
                                           r"failed .*s=3 b=2 nprobe=3 c=4 "
                                           r"cap=300 d=16 k=4 "
                                           r"design=grouped"):
        ivf._launch("grouped", w, *_small_sharded(False), k=4)
    assert w.launches == w.launches_grouped == 0


def test_failed_launch_names_the_shape_and_the_design(monkeypatch):
    _fake(monkeypatch, err=1)
    with pytest.raises(RuntimeError, match=r"ann_topk_ivf launch failed .*"
                                           r"cap=300 d=16 k=4 design=grouped"):
        ivf._launch("grouped", ivf.ann_topk_ivf, *_small(False), k=4)
    assert ivf.ann_topk_ivf.launches == 0
