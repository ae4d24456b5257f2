"""The port's ``flash_attention_fwd`` against the JAX package's Pallas
kernel (run in interpret mode, as tests/test_kernels.py runs it) and its
pure-jnp oracle.

On the CPU the port's wrapper takes its plain PyTorch version, so these
tests hold the plain version's masking and softmax to the reference; the
CUDA kernel is held to the plain version on the card by chip_smoke.py.
Tolerances are tests/test_kernels.py's: atol 3e-5 in fp32 (sums in
another order), 3e-2 in bf16 (the Pallas kernel rounds p to bf16 before
P.V; the plain version keeps it in fp32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jax_flash
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import build, flash_attention as fa_mod
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_plain)
from repro_torch.kernels.ops import flash_attention_fwd as ops_flash

torch.set_num_threads(1)

# tests/test_kernels.py:39-46, then a masked window that is not a multiple
# of the blocks, a non-causal window, and a ragged Sq > Sk (rows with no
# valid key average every V, as the reference does)
SHAPES = [
    (2, 256, 256, 2, 2, 32, True, None, 64, 64),
    (1, 128, 128, 4, 1, 64, True, 48, 64, 32),
    (2, 128, 256, 2, 4, 16, False, None, 128, 128),
    (1, 512, 512, 1, 8, 128, True, None, 256, 128),
    (1, 96, 96, 2, 2, 16, True, 5, 32, 32),
    (2, 64, 64, 1, 2, 32, False, 9, 32, 32),
    (1, 64, 32, 1, 1, 16, True, 4, 32, 32),
]


def _inputs(b, sq, sk, kv, g, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, kv, g, dh)).astype(np.float32),
            rng.standard_normal((b, sk, kv, dh)).astype(np.float32),
            rng.standard_normal((b, sk, kv, dh)).astype(np.float32))


@pytest.mark.parametrize("b,sq,sk,kv,g,dh,causal,win,bq,bk", SHAPES)
def test_flash_attention_matches_reference(b, sq, sk, kv, g, dh, causal, win,
                                           bq, bk):
    q, k, v = _inputs(b, sq, sk, kv, g, dh)
    scale = 1 / np.sqrt(dh)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), scale=scale, causal=causal,
                                window=win, bq=bq, bk=bk))
    oracle = np.asarray(flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
        causal=causal, window=win))
    before = (flash_attention_fwd.launches, flash_attention_fwd.plain_calls)
    got = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=scale,
                              causal=causal, window=win)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert (flash_attention_fwd.launches,
            flash_attention_fwd.plain_calls) == (before[0], before[1] + 1)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    np.testing.assert_allclose(got.numpy(), oracle, atol=3e-5)


def test_flash_attention_bf16_matches_reference():
    """tests/test_kernels.py:57-68's bf16 case."""
    q, k, v = _inputs(1, 128, 128, 2, 2, 32)
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash(qj, kj, vj, scale=0.17, bq=64, bk=64),
                      np.float32)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = flash_attention_fwd(qt, kt, vt, scale=0.17)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_flash_attention_takes_strided_batch_and_sequence():
    """A view with free batch/sequence strides (q sliced from a fused
    projection) gives what its contiguous copy gives."""
    q, k, v = _inputs(2, 40, 40, 2, 2, 16, seed=3)
    big = torch.from_numpy(np.concatenate([q, q], axis=1))[:, ::2]
    assert not big.is_contiguous()
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    got = flash_attention_fwd(big, kt, vt, scale=0.25)
    want = flash_attention_plain(big.contiguous(), kt, vt, 0.25)
    assert torch.equal(got, want)
    assert ops_flash is flash_attention_fwd


@pytest.mark.parametrize("bad", ["rank", "kv", "dtype", "window"])
def test_flash_attention_rejects_bad_inputs(bad):
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 2, 16))
    if bad == "rank":
        q = q[:, :, 0]
    elif bad == "kv":
        k = k[:, :, :1]
    elif bad == "dtype":
        k = k.double()
    with pytest.raises((ValueError, TypeError)):
        flash_attention_fwd(q, k, v, scale=0.25,
                            window=0 if bad == "window" else None)


def test_flash_attention_cuda_request_without_library_raises(monkeypatch,
                                                             tmp_path):
    """A tensor on neither CPU nor CUDA is refused, not sent to the plain
    version; the CUDA path needs its library, and without a toolkit its
    build raises (there is no fall back)."""
    q, k, v = (torch.from_numpy(x).to("meta")
               for x in _inputs(1, 8, 8, 1, 1, 16))
    plain = flash_attention_fwd.plain_calls
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_fwd(q, k, v, scale=0.25)
    assert flash_attention_fwd.plain_calls == plain
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        fa_mod._lib()
