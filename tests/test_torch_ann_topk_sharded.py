"""The port's shard-owned routed scans ``ann_topk_ivf_sharded`` /
``ann_topk_ivf_quant_sharded`` and their adapters against the JAX
package's ``repro.kernels.ann_topk_sharded`` (its per-shard loop over the
Pallas kernels in interpret mode, as tests/test_mesh_shard.py runs it on a
one-device host) and ``repro.kernels.ops``.

The reference takes padded (S, Cmax, cap, D) shard stacks; the port takes
the unsharded (C, cap, D) layout and the cut points, so each test builds
the stacks from the layout as ``ClusterRouter.kernel_shard_buckets``
does. On the CPU the port's wrappers take their plain PyTorch versions;
the CUDA kernel is held to them on the card by chip_smoke.py. Tolerances
are tests/test_torch_ann_topk_ivf.py's: fp32 values within 2e-5 (another
summation order), int8 values bitwise (atol 0); rows exactly, -1 at every
masked entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiers import quantize_rows
from repro.kernels import ann_topk_sharded as ref_sharded
from repro.kernels import ops as ref_ops
from repro_torch.kernels.ann_topk import NEG
from repro_torch.kernels.ann_topk_sharded import (
    ann_topk_ivf_quant_sharded, ann_topk_ivf_quant_sharded_plain,
    ann_topk_ivf_sharded, ann_topk_ivf_sharded_plain)
from repro_torch.kernels.ops import (_merge_shards, ann_topk_ivf_batch,
                                     ann_topk_ivf_quant_sharded_batch,
                                     ann_topk_ivf_sharded_batch)

torch.set_num_threads(1)

ATOL = 2e-5
# (C, cap, D, B, nprobe, k, cut points): one shard; two; S > C with
# repeated cut points (empty shards) and k above the bucket size; an
# empty shard in the middle; buckets above 64 slots (the "grouped" design
# on the card) with an empty shard
CASES = {
    "s1": (8, 16, 32, 4, 3, 2, [0, 8]),
    "s2": (8, 16, 32, 4, 3, 4, [0, 5, 8]),
    "s8_over_c": (4, 8, 16, 2, 3, 12, [0, 0, 1, 1, 2, 3, 3, 4, 4]),
    "s3_empty": (8, 32, 48, 3, 4, 6, [0, 3, 3, 8]),
    "s3_cap96": (8, 96, 16, 3, 4, 6, [0, 3, 3, 8]),
}


def _inputs(c, cap, d, b, nprobe, seed, p_off=0.2):
    """Buckets, a valid mask, the global row of each valid slot (distinct,
    ascending within a bucket, -1 elsewhere), queries and probes, a share
    p_off of them disabled."""
    rng = np.random.default_rng(seed)
    buckets = rng.standard_normal((c, cap, d)).astype(np.float32)
    valid = rng.random((c, cap)) > 0.3
    rows = np.sort(rng.choice(4 * c * cap, (c, cap), replace=False), axis=1)
    rows = np.where(valid, rows, -1).astype(np.int32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    sel = np.stack([rng.choice(c, nprobe, replace=False)
                    for _ in range(b)]).astype(np.int32)
    en = (rng.random((b, nprobe)) >= p_off).astype(np.int32)
    return sel, en, q, buckets, valid, rows


def _stacks(bounds, *per_cluster):
    """The reference's padded shard stacks of (C, cap, ...) arrays: shard
    s's owned range zero-padded (rows -1) to the widest span."""
    s = len(bounds) - 1
    cmax = int(max(1, np.diff(bounds).max()))
    out = []
    for a in per_cluster:
        fill = -1 if a.dtype == np.int32 else 0
        st = np.full((s, cmax, *a.shape[1:]), fill, a.dtype)
        for si in range(s):
            lo, hi = bounds[si], bounds[si + 1]
            st[si, :hi - lo] = a[lo:hi]
        out.append(st)
    return out


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _quant(buckets, q):
    c, cap, d = buckets.shape
    bq, bs = quantize_rows(buckets.reshape(-1, d))
    qq, qs = quantize_rows(q)
    return bq.reshape(c, cap, d), bs.reshape(c, cap), qq, qs


def _check_stacks(got, want, *, exact: bool):
    (v, r), (wv, wr) = [t.numpy() for t in got], [np.asarray(t) for t in want]
    assert v.shape == wv.shape and r.dtype == np.int32
    live = wv > NEG / 2
    np.testing.assert_array_equal(v > NEG / 2, live)
    if exact:
        np.testing.assert_array_equal(v, wv)
    else:
        np.testing.assert_allclose(v[live], wv[live], atol=ATOL)
    np.testing.assert_array_equal(r, wr)
    assert (r[~live] == -1).all()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fn", [ann_topk_ivf_sharded,
                                ann_topk_ivf_sharded_plain],
                         ids=["wrapper", "plain"])
def test_sharded_matches_reference(fn, case):
    c, cap, d, b, nprobe, k, bounds = CASES[case]
    sel, en, q, buckets, valid, rows = _inputs(c, cap, d, b, nprobe, seed=k)
    b32 = np.asarray(bounds, np.int32)
    got = fn(*_t(sel, en, q, buckets, valid, rows, b32), k)
    sb, sv, sr = _stacks(bounds, buckets, valid.astype(np.int32), rows)
    want = ref_sharded.ann_topk_ivf_sharded(
        jnp.asarray(sel), jnp.asarray(en), jnp.asarray(q), sb, sv, sr,
        np.asarray(bounds), k)
    assert got[0].shape == (len(bounds) - 1, b, nprobe, k)
    _check_stacks(got, want, exact=False)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fn", [ann_topk_ivf_quant_sharded,
                                ann_topk_ivf_quant_sharded_plain],
                         ids=["wrapper", "plain"])
def test_sharded_quant_matches_reference(fn, case):
    c, cap, d, b, nprobe, k, bounds = CASES[case]
    sel, en, q, buckets, valid, rows = _inputs(c, cap, d, b, nprobe,
                                               seed=10 + k)
    bq, bs, qq, qs = _quant(buckets, q)
    b32 = np.asarray(bounds, np.int32)
    got = fn(*_t(sel, en, qq, qs, bq, bs, valid, rows, b32), k)
    sbq, sbs, sv, sr = _stacks(bounds, bq, bs, valid.astype(np.int32), rows)
    want = ref_sharded.ann_topk_ivf_quant_sharded(
        jnp.asarray(sel), jnp.asarray(en), jnp.asarray(qq), jnp.asarray(qs),
        sbq, sbs, sv, sr, np.asarray(bounds), k)
    _check_stacks(got, want, exact=True)


def _clustered(c, cap, d, b, seed):
    """A router-like layout: centroids, some dead clusters, bucket_rows
    ascending within a bucket (-1 past the members), queries near rows."""
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((c, d)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    live = (rng.random(c) > 0.25).astype(np.int32)
    counts = np.where(live > 0, rng.integers(1, cap + 1, c), 0)
    rows = np.full((c, cap), -1, np.int32)
    nxt = 0
    for ci in range(c):
        rows[ci, :counts[ci]] = np.arange(nxt, nxt + counts[ci])
        nxt += counts[ci]
    valid = rows >= 0
    buckets = (cent[:, None, :] + 0.3 * rng.standard_normal(
        (c, cap, d))).astype(np.float32)
    buckets /= np.linalg.norm(buckets, axis=2, keepdims=True)
    buckets[~valid] = 0.0
    pick = rng.choice(np.flatnonzero(live), b)
    q = buckets[pick, 0] + 0.1 * rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return cent, live, buckets, rows, valid, q.astype(np.float32)


@pytest.mark.parametrize("bounds", [[0, 10], [0, 4, 4, 7, 10],
                                    [0, 1, 2, 3, 5, 6, 8, 9, 9, 10, 10, 10]],
                         ids=["s1", "s4", "s11"])
def test_sharded_adapters_match_reference_adapters(bounds):
    """ann_topk_ivf_sharded_batch / ann_topk_ivf_quant_sharded_batch
    against ops.ann_topk_ivf_sharded_jit / _quant_sharded_jit: vals, rows,
    sel and enabled (rows and sel exactly; fp32 vals within 2e-5, int8
    bitwise)."""
    cent, live, buckets, rows, valid, q = _clustered(10, 16, 48, 5, seed=6)
    lt = torch.from_numpy(live.astype(bool))
    b32 = torch.tensor(bounds, dtype=torch.int32)
    sv = _stacks(bounds, valid.astype(np.int32), rows)
    got = ann_topk_ivf_sharded_batch(torch.from_numpy(cent), lt,
                                     *_t(buckets, rows, valid), b32, q, 4, 4)
    want = ref_ops.ann_topk_ivf_sharded_jit(
        cent, live, _stacks(bounds, buckets)[0], sv[1], sv[0],
        np.asarray(bounds), q, 4, 4)
    (gv, gr, gs, ge), (wv, wr, ws, we) = ([t.numpy() for t in got],
                                          [np.asarray(t) for t in want])
    np.testing.assert_allclose(gv, wv, atol=ATOL)
    for a, b in ((gr, wr), (gs, ws), (ge, we)):
        np.testing.assert_array_equal(a, b)

    bq, bs, qq, qs = _quant(buckets, q)
    got = ann_topk_ivf_quant_sharded_batch(
        torch.from_numpy(cent), lt, *_t(bq, bs, rows, valid), b32, q, qq,
        qs, 4, 16)
    sbq, sbs = _stacks(bounds, bq, bs)
    want = ref_ops.ann_topk_ivf_quant_sharded_jit(
        cent, live, sbq, sbs, sv[1], sv[0], np.asarray(bounds), q, qq, qs,
        4, 16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_merge_shards_matches_reference_and_breaks_ties_shard_major():
    """ops._merge_shards against the reference's on random stacks, and on
    exact ties across shards: shard-major flat order, as lax.top_k."""
    rng = np.random.default_rng(3)
    vals = rng.choice(np.float32([0.25, 0.5, 0.9, NEG]), (3, 2, 4, 3))
    rows = rng.integers(0, 50, vals.shape).astype(np.int32)
    rows[vals <= NEG / 2] = -1
    for k in (1, 5, 40):
        got = _merge_shards(*_t(vals, rows), k)
        want = ref_ops._merge_shards(vals, rows, k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    v = torch.tensor([[[[0.5, NEG]]], [[[0.9, 0.5]]]])
    r = torch.tensor([[[[7, -1]]], [[[3, 1]]]], dtype=torch.int32)
    tv, tr = _merge_shards(v, r, 3)
    np.testing.assert_array_equal(tv.numpy()[0], np.float32([0.9, 0.5, 0.5]))
    np.testing.assert_array_equal(tr.numpy()[0], [3, 7, 1])


def test_one_shard_merges_as_the_unsharded_scan():
    """At S=1 the merged sharded scan is bitwise the unsharded adapter's;
    at 8 shards the merged vals are bitwise S=1's and the rows too (no
    exact ties in these scores)."""
    cent, live, buckets, rows, valid, q = _clustered(12, 16, 32, 6, seed=5)
    args = (torch.from_numpy(cent), torch.from_numpy(live.astype(bool)),
            *_t(buckets, rows, valid))
    want = ann_topk_ivf_batch(*args, q, 5, 4)
    one = ann_topk_ivf_sharded_batch(*args, torch.tensor([0, 12],
                                                         dtype=torch.int32),
                                     q, 5, 4)
    eight = ann_topk_ivf_sharded_batch(
        *args, torch.tensor([0, 1, 3, 3, 5, 8, 9, 11, 12], dtype=torch.int32),
        q, 5, 4)
    for a, b, c in zip(one, want, eight):
        assert torch.equal(a, b) and torch.equal(c, b)


def test_wrappers_count_plain_calls_on_the_cpu():
    c, cap, d, b, nprobe, k, bounds = CASES["s2"]
    sel, en, q, buckets, valid, rows = _inputs(c, cap, d, b, nprobe, seed=1)
    b32 = np.asarray(bounds, np.int32)
    before = (ann_topk_ivf_sharded.plain_calls,
              ann_topk_ivf_quant_sharded.plain_calls,
              ann_topk_ivf_sharded.launches)
    ann_topk_ivf_sharded(*_t(sel, en, q, buckets, valid, rows, b32), k)
    bq, bs, qq, qs = _quant(buckets, q)
    ann_topk_ivf_quant_sharded(*_t(sel, en, qq, qs, bq, bs, valid, rows, b32),
                               k)
    assert (ann_topk_ivf_sharded.plain_calls,
            ann_topk_ivf_quant_sharded.plain_calls,
            ann_topk_ivf_sharded.launches) == (before[0] + 1, before[1] + 1,
                                               before[2])


@pytest.mark.parametrize("bad", ["bounds_dtype", "bounds_short",
                                 "bounds_descend", "rows_shape", "k"])
def test_wrappers_refuse_bad_inputs(bad):
    """Malformed cut points (descending ones too: the CUDA designs look a
    bucket's owner up by binary search) and rows are refused. k 65, above the "warp"
    design's 64, is taken (the "grouped" design on the card): the stacks
    equal the plain version's and the reference's."""
    arrays = _inputs(4, 8, 16, 2, 2, seed=8)
    sel, en, q, buckets, valid, rows = _t(*arrays)
    bounds = torch.tensor([0, 2, 4], dtype=torch.int32)
    k = 4
    if bad == "bounds_dtype":
        bounds = bounds.long()
    elif bad == "bounds_short":
        bounds = bounds[:1]
    elif bad == "bounds_descend":
        bounds = torch.tensor([0, 3, 1, 4], dtype=torch.int32)
        bq, bs, qq, qs = _quant(arrays[3], arrays[2])
        with pytest.raises(ValueError, match="ascending"):
            ann_topk_ivf_quant_sharded(*_t(arrays[0], arrays[1], qq, qs, bq,
                                           bs), valid, rows, bounds, k)
    elif bad == "rows_shape":
        rows = rows[:, :4]
    else:
        k = 65
        got = ann_topk_ivf_sharded(sel, en, q, buckets, valid, rows, bounds,
                                   k)
        plain = ann_topk_ivf_sharded_plain(sel, en, q, buckets, valid, rows,
                                           bounds, k)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
        sb, sv, sr = _stacks([0, 2, 4], arrays[3],
                             arrays[4].astype(np.int32), arrays[5])
        want = ref_sharded.ann_topk_ivf_sharded(
            jnp.asarray(arrays[0]), jnp.asarray(arrays[1]),
            jnp.asarray(arrays[2]), sb, sv, sr, np.array([0, 2, 4]), k)
        _check_stacks(got, want, exact=False)
        return
    with pytest.raises(ValueError):
        ann_topk_ivf_sharded(sel, en, q, buckets, valid, rows, bounds, k)
