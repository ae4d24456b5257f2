"""The port's attention for training (``nn/flash``: kernel 6's forward with
its log-sum-exp, the backward ported from the reference's ``_flash_bwd``)
against the JAX package's ``nn/flash.py``: out and lse against its
``_flash_fwd``, (dq, dk, dv) against ``jax.vjp`` of its
``flash_attention``; and the repair that keeps training off the kernels'
non-differentiable outputs.

On the CPU kernel 6's wrapper takes its plain version, so these hold the
plain version's lse and the torch backward; chip_smoke.py holds the CUDA
kernel's lse and the backward on the card. Tolerance: 3e-5 (fp32 sums in
another order, tests/test_kernels.py's); chunks of 8 rows, so that the
backward runs several chunks and skips wholly masked pairs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.flash import _flash_fwd as ref_flash_fwd
from repro.nn.flash import flash_attention as ref_flash
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.nn import flash as flash_mod
from repro_torch.nn.flash import flash_attention, flash_chunk, sdpa_flash

torch.set_num_threads(1)
TOL = 3e-5
CHUNK = 8
# (B, Sq, Sk, KV, G, Dh, causal, window): causal, a window, non-causal
# Sq != Sk both ways, G > 1, MLA's Dh 192
CASES = [(2, 32, 32, 2, 3, 16, True, None),
         (1, 32, 32, 2, 2, 16, True, 5),
         (1, 16, 32, 1, 4, 32, False, None),
         (2, 32, 16, 2, 2, 16, False, None),
         (1, 24, 24, 1, 2, 192, True, None),
         (1, 32, 32, 2, 1, 64, False, 9)]


def _inputs(b, sq, sk, kvh, g, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, kvh, g, dh)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, dh)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, dh)).astype(np.float32),
            rng.standard_normal((b, sq, kvh, g, dh)).astype(np.float32))


@pytest.mark.parametrize("b,sq,sk,kvh,g,dh,causal,win", CASES)
def test_out_and_lse_match_reference_flash_fwd(b, sq, sk, kvh, g, dh,
                                               causal, win):
    q, k, v, _ = _inputs(b, sq, sk, kvh, g, dh)
    scale = 1 / np.sqrt(dh)
    want_o, (_, _, _, _, want_lse) = ref_flash_fwd(
        *map(jnp.asarray, (q, k, v)), scale, causal, win, 0, CHUNK)
    got_o, got_lse = flash_attention_fwd(
        *map(torch.from_numpy, (q, k, v)), scale=scale, causal=causal,
        window=win, return_lse=True)
    assert got_lse.shape == (b, kvh, g, sq) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=TOL)
    # without return_lse the call returns the same output alone
    alone = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                scale=scale, causal=causal, window=win)
    assert torch.equal(alone, got_o)


@pytest.mark.parametrize("b,sq,sk,kvh,g,dh,causal,win", CASES)
def test_gradients_match_reference_vjp(b, sq, sk, kvh, g, dh, causal, win):
    q, k, v, do = _inputs(b, sq, sk, kvh, g, dh, seed=1)
    scale = 1 / np.sqrt(dh)
    want_o, vjp = jax.vjp(
        lambda a, b_, c: ref_flash(a, b_, c, scale, causal, win, 0, CHUNK),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*xs, scale, causal, win, chunk=CHUNK)
    got = torch.autograd.grad(out, xs, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               atol=TOL)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=TOL)


def test_backward_skips_only_wholly_masked_pairs():
    """Causal at 4 chunks a side: the 6 pairs above the diagonal are
    skipped, the result is the unchunked backward's."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 32, 32, 1, 2, 16))
    o, lse = flash_attention_fwd(q, k, v, scale=0.25, return_lse=True)
    seen = []
    real = flash_mod._masked

    def spy(*args):
        seen.append(real(*args))
        return seen[-1]

    flash_mod._masked = spy
    try:
        got = flash_mod.flash_bwd(q, k, v, o, lse, do, 0.25, True, None,
                                  chunk=CHUNK)
    finally:
        flash_mod._masked = real
    assert len(seen) == 16 and sum(seen) == 6
    want = flash_mod.flash_bwd(q, k, v, o, lse, do, 0.25, True, None,
                               chunk=32)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-6)


def test_sdpa_flash_is_the_head_major_wrapper():
    q, k, v, _ = _inputs(2, 16, 16, 2, 3, 16)
    qh = torch.from_numpy(q).reshape(2, 16, 6, 16)
    out = sdpa_flash(qh, torch.from_numpy(k), torch.from_numpy(v), 0.25)
    want = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), scale=0.25)
    assert torch.equal(out, want.reshape(2, 16, 6, 16))
    assert flash_chunk(4096) == 1024 and flash_chunk(8192) == 1024 and \
        flash_chunk(8193) == 2048


def test_training_step_reaches_attention_through_the_ported_backward(
        monkeypatch):
    """A CPU training step of a shrunk granite: every layer's attention
    gradient comes from ``nn/flash``'s backward, once per layer. With that
    backward returning zeros, the gradients of wq, wk and wv are exactly
    zero: none flows through autograd over the plain einsums."""
    import dataclasses

    from repro_torch.configs import get_config, shrink
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.lm import LM
    from repro_torch.nn.param import init_params

    cfg = dataclasses.replace(
        shrink(get_config("granite-3-8b"), d_model=64, vocab=128,
               n_repeat=2), param_dtype="float32", compute_dtype="float32")
    lm = LM(cfg)
    params = init_params(lm.param_specs(), torch.Generator().manual_seed(0),
                         "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 128, (2, 16)))
             for k in ("tokens", "labels")}
    real, calls = flash_mod.flash_bwd, []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(flash_mod, "flash_bwd", counted)
    _, grads = value_and_grad(lm, params, batch)
    assert len(calls) == cfg.n_layers == 2
    assert all(float(grads["layers"][i]["mixer"][w].abs().max()) > 0
               for i in range(2) for w in ("wq", "wk", "wv"))

    def zeros(q, k, v, *rest, **kw):
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    monkeypatch.setattr(flash_mod, "flash_bwd", zeros)
    _, grads = value_and_grad(lm, params, batch)
    for i in range(2):
        for w in ("wq", "wk", "wv"):
            assert float(grads["layers"][i]["mixer"][w].abs().max()) == 0.0
        assert float(grads["layers"][i]["mixer"]["wo"].abs().max()) > 0
