"""The port's ``decode_attention`` against the JAX package's Pallas kernel
(run in interpret mode, as tests/test_kernels.py runs it) and its pure-jnp
oracle.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel (split-S, two passes) is held to the plain version on the card by
chip_smoke.py. Tolerances are tests/test_kernels.py's: atol 3e-5 in fp32,
3e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.ref import decode_attention_ref
from repro_torch.kernels import build, decode_attention as da_mod
from repro_torch.kernels.decode_attention import (MIN_CHUNK, TILE,
                                                  decode_attention,
                                                  split_rows)
from repro_torch.kernels.ops import decode_attention as ops_decode

torch.set_num_threads(1)
CTAS_AT_DH_128 = 2

# tests/test_kernels.py:71-78, then pos = S-1 and pos past the cache
SHAPES = [
    (2, 2, 4, 32, 256, 100, 64),
    (1, 4, 1, 64, 512, 511, 128),
    (4, 1, 8, 16, 128, 0, 128),
    (1, 8, 16, 128, 1024, 700, 256),
    (2, 2, 2, 16, 64, 63, 64),
    (1, 1, 2, 32, 64, 90, 64),
]


def _inputs(b, kv, g, dh, s, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, kv, g, dh)).astype(np.float32),
            rng.standard_normal((b, s, kv, dh)).astype(np.float32),
            rng.standard_normal((b, s, kv, dh)).astype(np.float32))


@pytest.mark.parametrize("b,kv,g,dh,s,pos,bs", SHAPES)
def test_decode_attention_matches_reference(b, kv, g, dh, s, pos, bs):
    q, kc, vc = _inputs(b, kv, g, dh, s)
    scale = 1 / np.sqrt(dh)
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), pos, scale=scale, bs=bs))
    oracle = np.asarray(decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), pos, scale))
    before = (decode_attention.launches, decode_attention.plain_calls)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), pos, scale=scale)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert (decode_attention.launches, decode_attention.plain_calls) == \
        (before[0], before[1] + 1)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    np.testing.assert_allclose(got.numpy(), oracle, atol=3e-5)


@pytest.mark.parametrize("pos", [0, 37, 127])
def test_decode_attention_bf16_matches_reference(pos):
    q, kc, vc = _inputs(2, 2, 4, 32, 128, seed=1)
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, kc, vc))
    want = np.asarray(jax_decode(qj, kj, vj, pos, scale=0.2, bs=64),
                      np.float32)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in (q, kc, vc))
    got = decode_attention(qt, kt, vt, pos, scale=0.2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_decode_attention_ignores_rows_past_pos():
    """Whatever finite values lie past ``pos`` do not reach the output
    (the plain version, like the reference, multiplies them by p = 0)."""
    q, kc, vc = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 16, 64))
    got = decode_attention(q, kc, vc, 20, scale=0.25)
    kc[:, 21:], vc[:, 21:] = 1e4, -1e4
    assert torch.equal(decode_attention(q, kc, vc, 20, scale=0.25), got)
    assert ops_decode is decode_attention


@pytest.mark.parametrize("rows,heads,sms,chunk", [
    (128, 16, 132, 256),         # the batcher (4 slots x KV 4): one chunk
    (1, 4, 132, 256),            # pos = 0: one chunk
    (32768, 4, 132, 512),        # agent B=1 at 32k: 64 chunks x 4 heads
    (32768, 32, 132, 4096),      # agent B=8 at 32k: 8 chunks x 32
    (100, 1, 132, 256),          # ragged: chunks stay tile multiples
])
def test_split_rows(rows, heads, sms, chunk):
    # Dh 128: two CTAs per SM (the library's decode_attention_ctas_per_sm)
    got = split_rows(rows, heads, sms, CTAS_AT_DH_128)
    assert got == chunk and got % TILE == 0 and got >= MIN_CHUNK
    # one wave: every (b, kv, chunk) CTA resident at once
    assert heads * -(-rows // got) <= CTAS_AT_DH_128 * sms


@pytest.mark.parametrize("bad", ["pos", "numpy_pos", "dtype", "shape"])
def test_decode_attention_rejects_bad_inputs(bad):
    q, kc, vc = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 16, 32))
    pos = {"pos": -1, "numpy_pos": np.int64(3)}.get(bad, 3)
    if bad == "dtype":
        vc = vc.double()
    elif bad == "shape":
        kc = kc[:, :, :1]
    with pytest.raises((ValueError, TypeError)):
        decode_attention(q, kc, vc, pos, scale=0.25)


def test_decode_attention_cuda_request_without_library_raises(monkeypatch,
                                                              tmp_path):
    q, kc, vc = (torch.from_numpy(x).to("meta")
                 for x in _inputs(1, 1, 1, 16, 8))
    plain = (decode_attention.plain_calls, decode_attention.launches)
    out, lse = decode_attention(q, kc, vc, 3, scale=0.25, return_lse=True)
    assert out.device.type == "meta" and out.shape == q.shape
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    assert (decode_attention.plain_calls, decode_attention.launches) == plain
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        da_mod._lib()
