"""The port's chunked-vocab cross-entropy (``nn/xent.chunked_xent``)
against the JAX package's ``nn/xent.chunked_xent``: loss and both
gradients at tests/test_opt_features.py:27-29's four (vocab, chunk,
softcap) cases, on the same seeded inputs, and against a dense
cross-entropy in torch.

Tolerances are that test's: the loss within 1e-5, gradients within 3e-5
(fp32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.xent import chunked_xent as ref_xent
from repro_torch.nn.xent import _nchunks, chunked_xent

torch.set_num_threads(1)
CASES = [(1000, 96, 0.0), (1000, 96, 30.0), (512, 512, 0.0), (769, 100, 0.0)]


def _inputs(v, seed=0, t=48, d=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, d)).astype(np.float32),
            (rng.standard_normal((v, d)) * 0.1).astype(np.float32),
            rng.integers(0, v, t).astype(np.int32))


@pytest.mark.parametrize("v,chunk,cap", CASES)
def test_chunked_xent_matches_reference(v, chunk, cap):
    x, w, lab = _inputs(v)
    want, want_g = jax.value_and_grad(
        lambda a, b: ref_xent(a, b, jnp.asarray(lab), chunk, cap), (0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = chunked_xent(xt, wt, torch.from_numpy(lab), chunk, cap)
    got_g = torch.autograd.grad(got, (xt, wt))
    assert abs(float(got.detach()) - float(want)) < 1e-5
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5)


@pytest.mark.parametrize("v,chunk,cap", CASES)
def test_chunked_xent_matches_dense_torch(v, chunk, cap):
    x, w, lab = _inputs(v, seed=1)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    lg = xt @ wt.T
    if cap:
        lg = torch.tanh(lg / cap) * cap
    dense = torch.nn.functional.cross_entropy(lg, torch.from_numpy(lab).long())
    want = torch.autograd.grad(dense, (xt, wt))
    got = chunked_xent(xt, wt, torch.from_numpy(lab), chunk, cap)
    assert abs(float(got.detach()) - float(dense.detach())) < 1e-5
    for a, b in zip(torch.autograd.grad(got, (xt, wt)), want):
        torch.testing.assert_close(a, b, rtol=0, atol=3e-5)


def test_chunks_tile_the_vocab_exactly():
    for v, req in ((1000, 96), (769, 100), (49280, 16384), (262144, 16384)):
        k = _nchunks(v, req)
        assert v % k == 0 and v // k <= max(req, v // k)
        assert k >= -(-v // req)
    assert _nchunks(49280, 16384) == 4   # granite's padded vocab
