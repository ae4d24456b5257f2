"""The port's xLSTM mixers (``nn/xlstm.py``) against the JAX package's on
the same parameters (the reference's ``init_tree``, constant leaves moved
off their init) and seeded numpy inputs, in fp32: mLSTM's chunkwise
prefill (one chunk, several, short), its final state, its recurrent
decode (from zeroed states and from a prefill's) and a one-token prefill;
sLSTM's scan in prefill and decode; the cache specs; the per-head norm's
population variance.

Tolerance: 2e-4 (the model tests' fp32 logit tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import xlstm as ref_xl
from repro.nn.config import XLSTMConfig as RefXLSTMConfig
from repro.nn.param import init_tree
from repro.nn.sharding import ShardCtx
from repro_torch.nn import xlstm as xl
from repro_torch.nn.config import XLSTMConfig
from repro_torch.nn.param import init_params

torch.set_num_threads(1)
CTX = ShardCtx(None)
TOL = 2e-4
D = 32
KINDS = {"mlstm": (ref_xl.mlstm_specs, ref_xl.mlstm_apply,
                   ref_xl.mlstm_cache_specs, xl.mlstm_specs,
                   xl.mlstm_apply, xl.mlstm_cache_specs),
         "slstm": (ref_xl.slstm_specs, ref_xl.slstm_apply,
                   ref_xl.slstm_cache_specs, xl.slstm_specs,
                   xl.slstm_apply, xl.slstm_cache_specs)}


def _cfgs(kind, **kw):
    a = dict(kind=kind, n_heads=2, proj_factor=2.0, chunk=8, **kw)
    return RefXLSTMConfig(**a), XLSTMConfig(**a)


def _params(kind, ref_cfg, seed=0):
    p = init_tree(jax.random.PRNGKey(seed),
                  KINDS[kind][0](ref_cfg, D, jnp.float32))
    rng = np.random.default_rng(seed)
    # constant leaves (biases, norm scales) off their init; the gate
    # weights (std 0.02) scaled up so that the gates move
    p = {k: (v + jnp.asarray(rng.uniform(-0.5, 0.5, v.shape), v.dtype)
             if np.ptp(np.asarray(v)) == 0 else
             v * 25 if k == "w_if" else v) for k, v in p.items()}
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(b, s, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, D)) \
        .astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("s", [1, 6, 8, 24])
def test_prefill_matches_reference(kind, s):
    """Outputs and the returned states: mLSTM's chunked form over one
    chunk, a short one (6) and three (its final state from the closed
    form), or its recurrent step for one token; sLSTM's scan."""
    ref_cfg, cfg = _cfgs(kind)
    p, pt = _params(kind, ref_cfg)
    x = _x(2, s)
    want, ref_cache = KINDS[kind][1](CTX, p, ref_cfg, jnp.asarray(x))
    got, cache = KINDS[kind][4](pt, cfg, torch.from_numpy(x))
    _close(got, want)
    assert sorted(cache) == sorted(ref_cache)
    for k in cache:
        _close(cache[k], ref_cache[k])


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("start", ["zeros", "prefill"])
def test_decode_matches_reference(kind, start):
    """Four recurrent steps from the zeroed cache specs (mLSTM's m from 0,
    sLSTM's n from 1) or from a 16-token prefill's states; the states are
    updated in place."""
    ref_cfg, cfg = _cfgs(kind)
    p, pt = _params(kind, ref_cfg, seed=2)
    apply = KINDS[kind][4]
    x = _x(2, 20, seed=3)
    if start == "zeros":
        cache = init_params(KINDS[kind][5](cfg, D, 2), None, "cpu")
        # a copy: jnp.asarray would alias the port's buffers, which its
        # decode then writes in place while JAX may still be reading them
        ref_cache = {k: jnp.array(v.numpy()) for k, v in cache.items()}
        lo = 0
    else:
        _, cache = apply(pt, cfg, torch.from_numpy(x[:, :16]))
        _, ref_cache = KINDS[kind][1](CTX, p, ref_cfg,
                                      jnp.asarray(x[:, :16]))
        lo = 16
    bufs = dict(cache)
    for t in range(lo, lo + 4):
        want, ref_cache = KINDS[kind][1](CTX, p, ref_cfg,
                                         jnp.asarray(x[:, t:t + 1]),
                                         cache=ref_cache)
        got, cache = apply(pt, cfg, torch.from_numpy(x[:, t:t + 1]),
                           cache=cache)
        _close(got, want)
    assert all(cache[k] is bufs[k] for k in bufs)
    for k in cache:
        _close(cache[k], ref_cache[k])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_prefill_over_chunks_equals_prefill_then_decode(kind):
    """A 16-token prefill (two mLSTM chunks) against an 8-token prefill
    and eight recurrent steps: the same last output."""
    ref_cfg, cfg = _cfgs(kind)
    _, pt = _params(kind, ref_cfg, seed=4)
    apply = KINDS[kind][4]
    x = torch.from_numpy(_x(1, 16, seed=5))
    full, _ = apply(pt, cfg, x)
    _, cache = apply(pt, cfg, x[:, :8])
    for t in range(8, 16):
        y, cache = apply(pt, cfg, x[:, t:t + 1], cache=cache)
    torch.testing.assert_close(y[:, 0], full[:, -1], atol=TOL, rtol=TOL)


def test_mlstm_chunked_and_final_state_match_reference():
    """``_mlstm_chunked`` and ``_mlstm_final_state`` alone, on gates wide
    enough that the stabiliser m moves between chunks."""
    ref_cfg, cfg = _cfgs("mlstm")
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
               for _ in range(3))
    i_pre = (3 * rng.standard_normal((2, 32, 2))).astype(np.float32)
    logf = np.log(rng.uniform(0.05, 1.0, (2, 32, 2))).astype(np.float32)
    want = ref_xl._mlstm_chunked(ref_cfg, *map(jnp.asarray,
                                               (q, k, v, i_pre, logf)))
    got = xl._mlstm_chunked(cfg, *map(torch.from_numpy,
                                      (q, k, v, i_pre, logf)))
    assert got.dtype == torch.float32
    _close(got, want)
    want = ref_xl._mlstm_final_state(ref_cfg, *map(jnp.asarray,
                                                   (k, v, i_pre, logf)))
    got = xl._mlstm_final_state(*map(torch.from_numpy, (k, v, i_pre, logf)))
    for key in ("c", "n", "m"):
        _close(got[key], want[key])


def test_mlstm_prefill_rejects_a_ragged_chunking():
    ref_cfg, cfg = _cfgs("mlstm")
    _, pt = _params("mlstm", ref_cfg)
    with pytest.raises(ValueError, match="must divide chunk 8"):
        xl.mlstm_apply(pt, cfg, torch.from_numpy(_x(1, 12)))


def test_headwise_norm_uses_the_population_variance():
    x = np.random.default_rng(7).standard_normal((2, 3, 2, 16)) \
        .astype(np.float32)
    scale = np.linspace(0.5, 1.5, 32).astype(np.float32)
    want = ref_xl._headwise_norm(jnp.asarray(x), jnp.asarray(scale))
    got = xl._headwise_norm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_specs_and_cache_specs_match_reference(kind):
    ref_cfg, cfg = _cfgs(kind)

    def norm(tree):
        return {k: (tuple(s.shape), str(s.dtype).removeprefix("torch.")
                    if isinstance(s.dtype, torch.dtype)
                    else jnp.dtype(s.dtype).name, s.init, s.scale)
                for k, s in tree.items()}

    assert norm(KINDS[kind][3](cfg, D, torch.bfloat16)) == \
        norm(KINDS[kind][0](ref_cfg, D, jnp.bfloat16))
    assert norm(KINDS[kind][5](cfg, D, 3)) == \
        norm(KINDS[kind][2](ref_cfg, D, 3))
