"""The port's routed-scan kernels ``ann_topk_ivf`` / ``ann_topk_ivf_quant``
and their adapters against the JAX package's Pallas kernels (interpret
mode, as tests/test_kernels.py runs them) and ``repro.kernels.ops``.

On the CPU the port's wrappers take their plain PyTorch versions; the CUDA
kernels are held to the plain versions on the card by chip_smoke.py.
Tolerances are tests/test_kernels.py's: fp32 values within 2e-5 (another
summation order) with the chosen slots scoring the same, int8 values
bitwise (atol 0) with the same slots. Entries of fully masked probes
(NEG) carry unspecified slots and are not compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiers import quantize_rows
from repro.kernels.ann_topk_ivf import ann_topk_ivf as jax_ivf
from repro.kernels.ann_topk_ivf import ann_topk_ivf_quant as jax_ivf_quant
from repro.kernels.ops import ann_topk_ivf_jit, ann_topk_ivf_quant_jit
from repro_torch.kernels.ann_topk import NEG
from repro_torch.kernels.ann_topk_ivf import (ann_topk_ivf,
                                              ann_topk_ivf_plain,
                                              ann_topk_ivf_quant,
                                              ann_topk_ivf_quant_plain)
from repro_torch.kernels.ops import (_merge_probes, _route,
                                     ann_topk_ivf_batch,
                                     ann_topk_ivf_quant_batch)

torch.set_num_threads(1)

ATOL = 2e-5
# tests/test_kernels.py:90-92, then :130's shape, then k above the bucket
SHAPES = [(8, 16, 32, 4, 3, 2), (16, 64, 64, 8, 5, 4), (4, 8, 16, 1, 4, 3),
          (8, 32, 48, 4, 4, 6), (4, 8, 32, 2, 3, 12)]


def _inputs(c, cap, d, b, nprobe, seed, p_off=0.2):
    rng = np.random.default_rng(seed)
    buckets = rng.standard_normal((c, cap, d)).astype(np.float32)
    valid = rng.random((c, cap)) > 0.3
    q = rng.standard_normal((b, d)).astype(np.float32)
    sel = np.stack([rng.choice(c, nprobe, replace=False)
                    for _ in range(b)]).astype(np.int32)
    en = (rng.random((b, nprobe)) >= p_off).astype(np.int32)
    return sel, en, q, buckets, valid


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _live_slots_score_the_same(scores, slots_a, slots_b, live):
    """Where two slot lists differ, the slots must score the same within
    ATOL (ties to fp ulp, the test_kernels idiom)."""
    for s, a, b, m in zip(scores, slots_a, slots_b, live):
        np.testing.assert_allclose(s[a[m]], s[b[m]], atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
@pytest.mark.parametrize("fn", [ann_topk_ivf, ann_topk_ivf_plain],
                         ids=["wrapper", "plain"])
def test_ivf_matches_reference(fn, shape):
    c, cap, d, b, nprobe, k = shape
    sel, en, q, buckets, valid = _inputs(c, cap, d, b, nprobe, seed=k)
    v, s = fn(*_t(sel, en, q, buckets, valid), k)
    v, s = v.numpy(), s.numpy()
    wv, ws = jax_ivf(jnp.asarray(sel), jnp.asarray(en), jnp.asarray(q),
                     jnp.asarray(buckets), jnp.asarray(valid, np.int32), k)
    wv, ws = np.asarray(wv), np.asarray(ws)
    assert v.shape == wv.shape == (b, nprobe, k) and s.dtype == np.int32
    live = wv > NEG / 2
    np.testing.assert_array_equal(v > NEG / 2, live)
    np.testing.assert_allclose(v[live], wv[live], atol=ATOL)
    for bi in range(b):
        scores = buckets[sel[bi]] @ q[bi]                  # (nprobe, cap)
        _live_slots_score_the_same(scores, s[bi], ws[bi], live[bi])


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
@pytest.mark.parametrize("fn", [ann_topk_ivf_quant, ann_topk_ivf_quant_plain],
                         ids=["wrapper", "plain"])
def test_ivf_quant_matches_reference(fn, shape):
    c, cap, d, b, nprobe, k = shape
    sel, en, q, buckets, valid = _inputs(c, cap, d, b, nprobe, seed=10 + k)
    bq, bs = quantize_rows(buckets.reshape(-1, d))
    bq, bs = bq.reshape(c, cap, d), bs.reshape(c, cap)
    qq, qs = quantize_rows(q)
    v, s = fn(*_t(sel, en, qq, qs, bq, bs, valid), k)
    v, s = v.numpy(), s.numpy()
    wv, ws = jax_ivf_quant(jnp.asarray(sel), jnp.asarray(en),
                           jnp.asarray(qq), jnp.asarray(qs), jnp.asarray(bq),
                           jnp.asarray(bs), jnp.asarray(valid, np.int32), k)
    wv, ws = np.asarray(wv), np.asarray(ws)
    np.testing.assert_array_equal(v, wv)                   # atol 0
    live = wv > NEG / 2
    np.testing.assert_array_equal(s[live], ws[live])


def test_masked_finalists_are_neg_at_stable_sort_slots():
    """Disabled probes and probes with fewer valid slots than k give NEG
    at slots 0, 1, ... (after the valid ones), as a stable sort of the
    NEG-padded scores would; the CUDA kernel writes the same."""
    c, cap, d, b, nprobe, k = 4, 8, 16, 3, 4, 12
    sel, en, q, buckets, valid = _inputs(c, cap, d, b, nprobe, seed=3)
    en[0, 1] = 0
    v, s = (t.numpy() for t in
            ann_topk_ivf_plain(*_t(sel, en, q, buckets, valid), k))
    np.testing.assert_array_equal(v[0, 1], np.full(k, np.float32(NEG)))
    np.testing.assert_array_equal(s[0, 1], np.arange(k))
    for bi in range(b):
        for j in range(nprobe):
            m = int(valid[sel[bi, j]].sum()) if en[bi, j] else 0
            assert (v[bi, j, :m] > NEG / 2).all()
            assert (v[bi, j, m:] == np.float32(NEG)).all()
            rest = [x for x in range(cap) if x not in set(s[bi, j, :m])]
            np.testing.assert_array_equal(
                s[bi, j, m:], (rest + list(range(cap, k + cap)))[:k - m])


def test_ivf_ties_in_one_bucket_break_to_the_lowest_slot():
    c, cap, d, b, nprobe, k = 4, 32, 16, 2, 2, 4
    sel, en, q, buckets, valid = _inputs(c, cap, d, b, nprobe, seed=4,
                                         p_off=0.0)
    valid[:] = True
    for bi in range(b):
        buckets[sel[bi, 0], [3, 20, 27]] = buckets[sel[bi, 0], 11]
        q[bi] = buckets[sel[bi, 0], 11]
    v, s = (t.numpy() for t in ann_topk_ivf(*_t(sel, en, q, buckets, valid),
                                           k))
    assert (v[:, 0, 0] == v[:, 0, 3]).all()
    np.testing.assert_array_equal(s[:, 0], np.tile([3, 11, 20, 27], (b, 1)))


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


@pytest.mark.parametrize("nprobe", [3, 12])
def test_route_and_merge_match_reference(nprobe):
    """ops._route (through ann_topk) and ops._merge_probes against the
    reference's jnp versions: the same selected clusters, enabled flags
    and merged (vals, rows)."""
    from repro.kernels import ops as ref_ops

    cent, live, buckets, rows, valid, q = _clustered(12, 16, 32, 6, seed=5)
    sel, en = _route(*_t(cent, live.astype(bool), q), nprobe)
    wsel, wen = ref_ops._route(cent, live, q, nprobe)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(wsel))
    np.testing.assert_array_equal(en.numpy(), np.asarray(wen))
    vals, slots = ann_topk_ivf(sel, en, *_t(q, buckets, valid), 4)
    tv, tr = _merge_probes(vals, slots, sel, torch.from_numpy(rows), 4)
    wv, wr = ref_ops._merge_probes(jnp.asarray(vals.numpy()),
                                   jnp.asarray(slots.numpy()),
                                   jnp.asarray(sel.numpy()), rows, 4)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(wr))


def test_merge_breaks_exact_ties_in_probe_order():
    """Equal values across probes merge in flat probe-major order, as
    lax.top_k does (the reference's documented between-bucket caveat)."""
    vals = torch.tensor([[[0.5, 0.1], [0.9, 0.5], [0.5, NEG]]])
    slots = torch.tensor([[[0, 1], [0, 1], [1, 0]]], dtype=torch.int32)
    sel = torch.tensor([[2, 0, 1]], dtype=torch.int32)
    rows = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    v, r = _merge_probes(vals, slots, sel, rows, 5)
    np.testing.assert_array_equal(v.numpy()[0], np.float32(
        [0.9, 0.5, 0.5, 0.5, 0.1]))
    np.testing.assert_array_equal(r.numpy()[0], [0, 8, 1, 5, 9])


@pytest.mark.parametrize("nprobe", [2, 5])
def test_adapters_match_reference_adapters(nprobe):
    """ann_topk_ivf_batch / ann_topk_ivf_quant_batch against
    ops.ann_topk_ivf_jit / ann_topk_ivf_quant_jit: vals, rows, sel and
    enabled (rows and sel exactly; fp32 vals within 2e-5, int8 bitwise)."""
    cent, live, buckets, rows, valid, q = _clustered(10, 16, 48, 5, seed=6)
    lt, vt = torch.from_numpy(live.astype(bool)), torch.from_numpy(valid)
    got = ann_topk_ivf_batch(torch.from_numpy(cent), lt,
                             torch.from_numpy(buckets),
                             torch.from_numpy(rows), vt, q, nprobe, 4)
    want = ann_topk_ivf_jit(cent, live, buckets, rows,
                            valid.astype(np.int32), q, nprobe, 4)
    (gv, gr, gs, ge), (wv, wr, ws, we) = ([t.numpy() for t in got],
                                          [np.asarray(t) for t in want])
    np.testing.assert_allclose(gv, wv, atol=ATOL)
    for a, b in ((gr, wr), (gs, ws), (ge, we)):
        np.testing.assert_array_equal(a, b)

    d = buckets.shape[2]
    bq, bs = quantize_rows(buckets.reshape(-1, d))
    bq, bs = bq.reshape(buckets.shape), bs.reshape(valid.shape)
    qq, qs = quantize_rows(q)
    got = ann_topk_ivf_quant_batch(torch.from_numpy(cent), lt,
                                   *_t(bq, bs, rows), vt, q, qq, qs,
                                   nprobe, 16)
    want = ann_topk_ivf_quant_jit(cent, live, bq, bs, rows,
                                  valid.astype(np.int32), q, qq, qs,
                                  nprobe, 16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_nprobe_above_the_kernel_limit_is_refused():
    cent, live, _, _, _, q = _clustered(80, 8, 16, 2, seed=7)
    with pytest.raises(ValueError, match="K_MAX=64"):
        _route(*_t(cent, live.astype(bool), q), 65)


@pytest.mark.parametrize("bad", ["sel_dtype", "shape", "k"])
def test_wrappers_refuse_bad_inputs(bad):
    sel, en, q, buckets, valid = _t(*_inputs(4, 8, 16, 2, 2, seed=8))
    if bad == "sel_dtype":
        with pytest.raises(TypeError):
            ann_topk_ivf(sel.long(), en, q, buckets, valid)
    elif bad == "shape":
        with pytest.raises(ValueError):
            ann_topk_ivf(sel, en, q[:, :8], buckets, valid)
    else:
        with pytest.raises(ValueError):
            ann_topk_ivf(sel, en, q, buckets, valid, k=65)
