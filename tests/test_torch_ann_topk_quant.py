"""The port's ``ann_topk_quant`` against the JAX package's Pallas kernel
(run in interpret mode, as tests/test_kernels.py runs it).

On the CPU the port's wrapper takes its plain PyTorch version, so these
tests hold the plain version's int8 arithmetic, rescale order, tie rule
and NEG handling to the reference; the CUDA kernel is held to the plain
version on the card by chip_smoke.py. The scores are exact int32 dots and
two rounded multiplies on both sides, so values agree bitwise (atol 0) and
rows agree wherever the value is a real score, ties included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiers import quantize_rows as ref_quantize_rows
from repro.kernels.ann_topk_quant import ann_topk_quant as jax_ann_topk_quant
from repro.kernels.ops import ann_topk_quant_jit
from repro_torch.core.tiers import quantize_rows
from repro_torch.kernels.ann_topk import NEG
from repro_torch.kernels.ann_topk_quant import (ann_topk_quant,
                                                ann_topk_quant_plain)
from repro_torch.kernels.ops import ann_topk_quant_batch

torch.set_num_threads(1)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _data(n, d, b, seed=0, p_active=0.8):
    rng = np.random.default_rng(seed)
    emb = _unit(rng.standard_normal((n, d)))
    act = rng.random(n) < p_active
    pick = rng.integers(0, n, b)
    q = _unit(emb[pick] + 0.05 * rng.standard_normal((b, d)))
    return emb, act, q


def _quantized(emb, act, q):
    eq, es = quantize_rows(emb)
    qq, qs = quantize_rows(q)
    return eq, es, act, qq, qs


def _reference(eq, es, act, qq, qs, k):
    v, r = jax_ann_topk_quant(jnp.asarray(eq), jnp.asarray(es),
                              jnp.asarray(act), jnp.asarray(qq),
                              jnp.asarray(qs), k)
    return np.asarray(v), np.asarray(r)


def _port(fn, eq, es, act, qq, qs, k):
    v, r = fn(torch.from_numpy(eq), torch.from_numpy(es),
              torch.from_numpy(act), torch.from_numpy(qq),
              torch.from_numpy(qs), k)
    return v.numpy(), r.numpy()


def _assert_exact(got, want):
    (gv, gr), (wv, wr) = got, want
    assert gv.dtype == np.float32 and gr.dtype == np.int32
    assert gv.shape == wv.shape and gr.shape == wr.shape
    np.testing.assert_array_equal(gv, wv)            # atol 0
    real = wv > NEG / 2
    np.testing.assert_array_equal(gr[real], wr[real])


def test_quantize_rows_is_the_reference():
    emb, _, _ = _data(64, 48, 1)
    emb[3] = 0.0                                     # an all-zero row
    for got, want in zip(quantize_rows(emb), ref_quantize_rows(emb)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [32, 48, 64])
@pytest.mark.parametrize("fn", [ann_topk_quant, ann_topk_quant_plain],
                         ids=["wrapper", "plain"])
def test_matches_reference(fn, d):
    """The tier test's shape (tests/test_tiers.py:94: 300 rows, B = 16,
    k = 16 coarse candidates) at D = 32, 48 and 64."""
    args = _quantized(*_data(300, d, 16, seed=d))
    before = ann_topk_quant.plain_calls
    got = _port(fn, *args, 16)
    _assert_exact(got, _reference(*args, 16))
    assert ann_topk_quant.plain_calls == before + (fn is ann_topk_quant)


def test_ties_break_to_the_lowest_row():
    """Exact-duplicate rows in different tiles tie bitwise; the lowest row
    comes first on both sides, and every duplicate is listed."""
    rng = np.random.default_rng(4)
    n, d, b = 1200, 64, 6
    emb = _unit(rng.standard_normal((n, d)))
    src = rng.choice(300, b, replace=False)
    for off in (400, 800):
        emb[src + off] = emb[src]
    args = _quantized(emb, np.ones(n, bool), emb[src].copy())
    got = _port(ann_topk_quant, *args, 8)
    want = _reference(*args, 8)
    _assert_exact(got, want)
    assert (got[0][:, 0] == got[0][:, 1]).all()      # the tie is real
    assert (np.diff(got[1][:, :3], axis=1) > 0).all()


def test_fewer_active_rows_than_k():
    emb, _, q = _data(700, 32, 3, seed=5)
    act = np.zeros(700, bool)
    act[[5, 600, 699]] = True
    args = _quantized(emb, act, q)
    got = _port(ann_topk_quant, *args, 16)
    _assert_exact(got, _reference(*args, 16))
    assert ((got[0] > NEG / 2).sum(axis=1) == 3).all()
    assert set(got[1][:, :3].ravel()) <= {5, 600, 699}


def test_plain_pads_fewer_rows_than_k():
    args = _quantized(*_data(8, 32, 2, seed=6, p_active=1.0))
    vals, rows = _port(ann_topk_quant, *args, 16)
    assert vals.shape == (2, 16)
    assert (vals[:, :8] > NEG / 2).all() and (vals[:, 8:] == np.float32(NEG)).all()
    np.testing.assert_array_equal(np.sort(rows[:, :8], axis=1),
                                  np.tile(np.arange(8), (2, 1)))


def test_adapter_matches_reference_adapter():
    """ops.ann_topk_quant_batch (numpy queries in, tensors out) against
    repro.kernels.ops.ann_topk_quant_jit on the same inputs."""
    eq, es, act, qq, qs = _quantized(*_data(300, 48, 5, seed=7))
    v, r = ann_topk_quant_batch(torch.from_numpy(eq), torch.from_numpy(es),
                                torch.from_numpy(act), qq, qs, 16)
    wv, wr = ann_topk_quant_jit(eq, es, act, qq, qs, 16)
    _assert_exact((v.numpy(), r.numpy()), (np.asarray(wv), np.asarray(wr)))


@pytest.mark.parametrize("bad", ["dtype", "shape", "k"])
def test_wrapper_refuses_bad_inputs(bad):
    eq, es, act, qq, qs = (torch.from_numpy(a) for a in
                           _quantized(*_data(64, 32, 2, seed=8)))
    if bad == "dtype":
        with pytest.raises(TypeError):
            ann_topk_quant(eq.float(), es, act, qq, qs)
    elif bad == "shape":
        with pytest.raises(ValueError):
            ann_topk_quant(eq, es[:10], act, qq, qs)
    else:
        with pytest.raises(ValueError):
            ann_topk_quant(eq, es, act, qq, qs, k=65)
