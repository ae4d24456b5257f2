"""The port's ``ann_topk`` against the JAX package's Pallas kernel (run in
interpret mode, as tests/test_kernels.py runs it).

On the CPU the port's wrapper takes its plain PyTorch version, so these
tests hold the plain version's arithmetic, tie rule and NEG handling to
the reference; the CUDA kernel is held to the plain version on the card
by chip_smoke.py. Values agree within 2e-5 (fp32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ann_topk import ann_topk as jax_ann_topk
from repro_torch.kernels.ann_topk import (NEG, ann_topk, ann_topk_plain,
                                         query_block)
from repro_torch.kernels.ops import ann_topk_batch

torch.set_num_threads(1)

ATOL = 2e-5
# the reference's kernel-test shapes, then a width 16-byte loads do not
# divide and the largest k over a partial second block of 16 queries
SHAPES = [(1000, 128, 4, 4), (513, 64, 1, 8), (2048, 256, 16, 4),
          (64, 32, 2, 4), (700, 100, 3, 5), (3000, 64, 20, 64)]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _data(n, d, b, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    act = rng.random(n) > 0.2
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return emb, act, q


def _reference(emb, act, q, k, jdt=np.float32):
    v, r = jax_ann_topk(jnp.asarray(emb).astype(jdt), jnp.asarray(act),
                        jnp.asarray(q).astype(jdt), k)
    return np.asarray(v), np.asarray(r)


def _assert_agrees(vals, rows, ref_v, ref_r):
    """Values within ATOL; rows equal wherever the reference's value is a
    real score separated from its ranking neighbours by more than ATOL."""
    vals, rows = np.asarray(vals), np.asarray(rows)
    assert vals.shape == ref_v.shape and rows.shape == ref_r.shape
    assert rows.dtype == np.int32 and vals.dtype == np.float32
    real = ref_v > NEG / 2
    np.testing.assert_array_equal(vals > NEG / 2, real)
    np.testing.assert_allclose(vals[real], ref_v[real], atol=ATOL)
    gap = np.full(ref_v.shape, np.inf)
    step = np.abs(np.diff(ref_v, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    sure = real & (gap > ATOL)
    np.testing.assert_array_equal(rows[sure], ref_r[sure])


@pytest.mark.parametrize("n,d,b,k", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_kernel(n, d, b, k, dtype):
    jdt, tdt = DTYPES[dtype]
    emb, act, q = _data(n, d, b)
    ref_v, ref_r = _reference(emb, act, q, k, jdt)
    vals, rows = ann_topk_plain(torch.from_numpy(emb).to(tdt),
                                torch.from_numpy(act),
                                torch.from_numpy(q).to(tdt), k)
    _assert_agrees(vals, rows, ref_v, ref_r)
    # score parity, as the reference's own kernel test checks it
    s = emb.astype(np.float32) @ q.T if dtype == "float32" else None
    if s is not None:
        for bi in range(b):
            np.testing.assert_allclose(s[np.asarray(rows)[bi], bi],
                                       s[ref_r[bi], bi], atol=ATOL)


@pytest.mark.parametrize("n,d,b,k", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ops_adapter_matches_pallas_kernel(n, d, b, k, dtype):
    """``ann_topk_batch`` (the VectorIndex adapter) on device="cpu": numpy
    queries move to the mirror's device and type; (D,) queries give (k,)
    results."""
    jdt, tdt = DTYPES[dtype]
    emb, act, q = _data(n, d, b, seed=1)
    ref_v, ref_r = _reference(emb, act, q, k, jdt)
    emb_t = torch.from_numpy(emb).to(tdt)
    act_t = torch.from_numpy(act)
    vals, rows = ann_topk_batch(emb_t, act_t, q, k)
    _assert_agrees(vals, rows, ref_v, ref_r)
    v0, r0 = ann_topk_batch(emb_t, act_t, q[0], k)
    assert v0.shape == (k,) and r0.shape == (k,)
    _assert_agrees(v0[None], r0[None], ref_v[:1], ref_r[:1])


@pytest.mark.parametrize("where", ["same_tile", "across_tiles"])
def test_duplicate_rows_tie_to_lowest_row(where):
    """Exact-duplicate embeddings (judge false-negative re-inserts) tie
    bitwise; the lower row wins, within a 512-row tile and across tiles."""
    n, d, k = 1300, 64, 4
    emb, _, _ = _data(n, d, 1, seed=2)
    rng = np.random.default_rng(3)
    src = 2 * rng.choice(200, 5, replace=False)
    dst = src + 1 if where == "same_tile" else src + 900
    emb[dst] = emb[src]
    act = np.ones(n, bool)
    q = emb[src].copy()
    ref_v, ref_r = _reference(emb, act, q, k)
    vals, rows = ann_topk_plain(torch.from_numpy(emb), torch.from_numpy(act),
                                torch.from_numpy(q), k)
    np.testing.assert_array_equal(np.asarray(rows), ref_r)
    np.testing.assert_allclose(np.asarray(vals), ref_v, atol=ATOL)
    np.testing.assert_array_equal(np.asarray(rows)[:, :2],
                                  np.stack([src, dst], axis=1))


@pytest.mark.parametrize("n_active", [0, 1, 3])
def test_fewer_active_rows_than_k(n_active):
    n, d, b, k = 700, 32, 3, 8
    emb, _, q = _data(n, d, b, seed=4)
    act = np.zeros(n, bool)
    act[[5, 600, 699][:n_active]] = True
    ref_v, ref_r = _reference(emb, act, q, k)
    vals, rows = ann_topk_plain(torch.from_numpy(emb), torch.from_numpy(act),
                                torch.from_numpy(q), k)
    vals = np.asarray(vals)
    assert (vals > NEG / 2).sum(axis=1).tolist() == [n_active] * b
    _assert_agrees(vals, rows, ref_v, ref_r)


def test_fewer_rows_than_k_pads_with_neg():
    emb, act, q = _data(3, 16, 2, seed=5)
    act[:] = True
    vals, rows = ann_topk_plain(torch.from_numpy(emb), torch.from_numpy(act),
                                torch.from_numpy(q), 5)
    assert vals.shape == (2, 5) and rows.shape == (2, 5)
    assert bool((vals[:, 3:] == NEG).all())
    assert sorted(rows[0, :3].tolist()) == [0, 1, 2]


def test_cpu_tensors_take_the_plain_version_and_count_it():
    emb, act, q = _data(100, 16, 2, seed=6)
    before = (ann_topk.launches, ann_topk.plain_calls)
    got = ann_topk(torch.from_numpy(emb), torch.from_numpy(act),
                   torch.from_numpy(q), 4)
    want = ann_topk_plain(torch.from_numpy(emb), torch.from_numpy(act),
                          torch.from_numpy(q), 4)
    assert (ann_topk.launches, ann_topk.plain_calls) == \
        (before[0], before[1] + 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", ["dtype", "qdtype", "active", "k0", "k65",
                                  "shape", "qb"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    emb = torch.zeros(10, 8)
    act = torch.ones(10, dtype=torch.bool)
    q = torch.zeros(2, 8)
    k = 4
    if case == "dtype":
        emb = emb.double()
    elif case == "qdtype":
        q = q.to(torch.bfloat16)
    elif case == "active":
        act = act.float()
    elif case == "k0":
        k = 0
    elif case == "k65":
        k = 65
    elif case == "shape":
        q = torch.zeros(2, 7)
    with pytest.raises((TypeError, ValueError)):
        ann_topk(emb, act, q, k, qb=8 if case == "qb" else None)


@pytest.mark.parametrize("b,qb", [(1, 1), (2, 4), (4, 4), (5, 16), (16, 16),
                                  (64, 16)])
def test_query_block_is_the_smallest_that_holds_the_batch(b, qb):
    assert query_block(b) == qb
