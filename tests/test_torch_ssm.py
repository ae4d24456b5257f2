"""The port's Mamba mixer (``nn/ssm.py``) against the JAX package's on the
same parameters (the reference's ``init_tree``, its constant leaves moved
off their init) and the same seeded numpy inputs, in fp32: prefill over
one chunk, several chunks and a short sequence, a one-token prefill,
decode from zeroed states and from a prefill's, and the cache specs.

Tolerance: 2e-4 (the model tests' fp32 logit tolerance) on outputs and
states of O(1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssm as ref_ssm
from repro.nn.config import MambaConfig as RefMambaConfig
from repro.nn.param import init_tree
from repro.nn.sharding import ShardCtx
from repro_torch.nn import ssm
from repro_torch.nn.config import MambaConfig
from repro_torch.nn.param import init_params

torch.set_num_threads(1)
CTX = ShardCtx(None)
TOL = 2e-4
D = 32


def _cfgs(**kw):
    a = dict(d_state=4, d_conv=4, expand=2, chunk=8, **kw)
    return RefMambaConfig(**a), MambaConfig(**a)


def _params(ref_cfg, seed=0):
    """The reference's parameters, every constant leaf (a_log, b_dt,
    d_skip ones; conv_b zeros) moved off its init, and the port's copy."""
    p = init_tree(jax.random.PRNGKey(seed),
                  ref_ssm.mamba_specs(ref_cfg, D, jnp.float32))
    rng = np.random.default_rng(seed)
    p = {k: (v + jnp.asarray(rng.uniform(-0.3, 0.3, v.shape), v.dtype)
             if np.ptp(np.asarray(v)) == 0 else v) for k, v in p.items()}
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(b, s, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, D)) \
        .astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s", [1, 5, 8, 24])
def test_mamba_prefill_matches_reference(s):
    """One token (the one-step branch), a sequence shorter than the chunk
    (one chunk of 5), exactly one chunk, and three chunks carried."""
    ref_cfg, cfg = _cfgs()
    p, pt = _params(ref_cfg)
    x = _x(2, s)
    want, ref_cache = ref_ssm.mamba_apply(CTX, p, ref_cfg, jnp.asarray(x))
    got, cache = ssm.mamba_apply(pt, cfg, torch.from_numpy(x))
    _close(got, want)
    assert cache["conv"].shape == (2, 3, 2 * D) and \
        cache["ssm"].shape == (2, 2 * D, 4)
    _close(cache["conv"], ref_cache["conv"])
    _close(cache["ssm"], ref_cache["ssm"])


def test_mamba_prefill_rejects_a_ragged_chunking():
    """Longer than the chunk and not a multiple of it: the reference
    asserts, the port raises."""
    ref_cfg, cfg = _cfgs()
    _, pt = _params(ref_cfg)
    with pytest.raises(ValueError, match="divisible by chunk 8"):
        ssm.mamba_apply(pt, cfg, torch.from_numpy(_x(1, 12)))


def test_chunk_scan_equals_the_step_recurrence():
    """The doubling scan inside a chunk against h_t = a_t h_{t-1} + b_t
    stepped one at a time, from a non-zero carry, at a chunk length that
    is not a power of two."""
    rng = np.random.default_rng(3)
    dec = torch.from_numpy(rng.uniform(0.2, 1.0, (2, 13, 3, 4)))
    inp = torch.from_numpy(rng.standard_normal((2, 13, 3, 4)))
    h = torch.from_numpy(rng.standard_normal((2, 3, 4)))
    got = ssm._scan_chunk(h, dec, inp)
    for t in range(13):
        h = dec[:, t] * h + inp[:, t]
        torch.testing.assert_close(got[:, t], h, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("start", ["zeros", "prefill"])
def test_mamba_decode_matches_reference(start):
    """Four decode steps, from zeroed states (``mamba_cache_specs``) or
    from a 16-token prefill's: outputs each step and the states after,
    updated in place in the port's cache."""
    ref_cfg, cfg = _cfgs()
    p, pt = _params(ref_cfg, seed=2)
    x = _x(2, 20, seed=4)
    if start == "zeros":
        cache = init_params(ssm.mamba_cache_specs(cfg, D, 2, torch.float32),
                            None, "cpu")
        ref_cache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
        lo = 0
    else:
        _, cache = ssm.mamba_apply(pt, cfg, torch.from_numpy(x[:, :16]))
        _, ref_cache = ref_ssm.mamba_apply(CTX, p, ref_cfg,
                                           jnp.asarray(x[:, :16]))
        lo = 16
    bufs = dict(cache)
    for t in range(lo, lo + 4):
        want, ref_cache = ref_ssm.mamba_apply(
            CTX, p, ref_cfg, jnp.asarray(x[:, t:t + 1]), cache=ref_cache)
        got, cache = ssm.mamba_apply(pt, cfg, torch.from_numpy(
            x[:, t:t + 1]), cache=cache)
        _close(got, want)
    assert all(cache[k] is bufs[k] for k in bufs)
    _close(cache["conv"], ref_cache["conv"])
    _close(cache["ssm"], ref_cache["ssm"])


def test_mamba_prefill_over_chunks_equals_prefill_then_decode():
    """A 16-token prefill (two chunks) against an 8-token prefill (one)
    and eight decode steps: the same last output and final states."""
    ref_cfg, cfg = _cfgs()
    _, pt = _params(ref_cfg, seed=5)
    x = torch.from_numpy(_x(1, 16, seed=6))
    full, fc = ssm.mamba_apply(pt, cfg, x)
    _, cache = ssm.mamba_apply(pt, cfg, x[:, :8])
    for t in range(8, 16):
        y, cache = ssm.mamba_apply(pt, cfg, x[:, t:t + 1], cache=cache)
    torch.testing.assert_close(y[:, 0], full[:, -1], atol=TOL, rtol=TOL)
    for k in ("conv", "ssm"):
        torch.testing.assert_close(cache[k], fc[k], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_cache_specs(dtype):
    """The reference's shapes; the conv state in the activations' dtype
    (the reference declares bf16, ROADMAP section 3), the SSM state fp32,
    both zeros."""
    ref_cfg, cfg = _cfgs()
    want = ref_ssm.mamba_cache_specs(ref_cfg, D, 3)
    got = ssm.mamba_cache_specs(cfg, D, 3, dtype)
    assert {k: s.shape for k, s in got.items()} == \
        {k: s.shape for k, s in want.items()}
    assert got["conv"].dtype == dtype and got["ssm"].dtype == torch.float32
    assert {s.init for s in got.values()} == {"zeros"}


def test_mamba_specs_match_reference():
    """Every leaf's shape, dtype (fp32 for conv, dt, A and skip) and
    init, with the default dt rank ceil(D / 16) and an explicit one."""
    for kw in ({}, {"dt_rank": 3}):
        ref_cfg, cfg = _cfgs(**kw)
        want = ref_ssm.mamba_specs(ref_cfg, D, jnp.bfloat16)
        got = ssm.mamba_specs(cfg, D, torch.bfloat16)
        assert list(got) == list(want)
        for k, s in got.items():
            assert (s.shape, str(s.dtype).removeprefix("torch."), s.init) \
                == (want[k].shape, jnp.dtype(want[k].dtype).name,
                    want[k].init), k
    assert dataclasses.asdict(_cfgs()[1]) == dataclasses.asdict(_cfgs()[0])
