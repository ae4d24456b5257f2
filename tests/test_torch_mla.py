"""The port's multi-head latent attention (``nn/attention.py``: MLA) and
M-RoPE (``nn/basic.apply_rope``) against the JAX package's, on the same
parameters (the reference's ``init_tree``, carried over as numpy arrays)
and the same seeded inputs, in fp32.

MLA's prefill in the port folds the shared rope key into a (nope +
rope)-wide q/k and zero-pads v, then runs kernel 6 (its plain version on
the CPU) at every length; the reference does that above 512 tokens and
scores q_nope.k_nope + q_rope.k_rope explicitly below. Both sides of 512
are held within 1e-5 (sums in another order). Decode is the absorbed
latent form in both packages, within 1e-5, and the cache written in place
equals the reference's new cache. M-RoPE only selects which position
stream drives each frequency band: within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as ref_att
from repro.nn import basic as ref_basic
from repro.nn.config import AttnConfig as RefAttnConfig
from repro.nn.param import init_tree
from repro.nn.sharding import ShardCtx
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.nn import attention as att
from repro_torch.nn import basic
from repro_torch.nn.config import AttnConfig

torch.set_num_threads(1)
CTX = ShardCtx(None)
D = 32


def _mla_cfgs(q_lora: bool = True):
    a = dict(n_heads=4, n_kv_heads=4, head_dim=16, kind="mla",
             q_lora_rank=16 if q_lora else None, kv_lora_rank=16,
             qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    return RefAttnConfig(**a), AttnConfig(**a)


def _params(ref_cfg, seed=0):
    p = init_tree(jax.random.PRNGKey(seed),
                  ref_att.mla_specs(ref_cfg, D, jnp.float32))
    tree = jax.tree.map(np.asarray, p)
    return p, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _x(shape, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("s,q_lora", [(16, True), (16, False), (520, True)])
def test_mla_prefill_matches_reference(s, q_lora):
    ref_cfg, cfg = _mla_cfgs(q_lora)
    p, pt = _params(ref_cfg)
    x = _x((2, s, D))
    pos = np.arange(s, dtype=np.int32)[None].repeat(2, 0)
    before = flash_attention_fwd.plain_calls
    got, cache = att.mla_apply(pt, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos))
    assert flash_attention_fwd.plain_calls == before + 1
    want, ref_cache = ref_att.mla_apply(CTX, p, ref_cfg, jnp.asarray(x),
                                        jnp.asarray(pos))
    assert (s > ref_att.FLASH_THRESHOLD) == (s == 520)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for name in ("latent", "k_rope"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(ref_cache[name]), atol=1e-5)


@pytest.mark.parametrize("pos", [0, 9, 23])
def test_mla_decode_matches_reference(pos):
    """One absorbed decode step against a latent cache of random history;
    pos 23 writes the cache's last row."""
    ref_cfg, cfg = _mla_cfgs()
    p, pt = _params(ref_cfg, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, D)).astype(np.float32)
    lat = rng.standard_normal((3, 24, 16)).astype(np.float32)
    rope = rng.standard_normal((3, 24, 8)).astype(np.float32)
    ref_cache = {"latent": jnp.asarray(lat), "k_rope": jnp.asarray(rope)}
    cache = {"latent": torch.from_numpy(lat.copy()),
             "k_rope": torch.from_numpy(rope.copy())}
    positions = np.full((3, 1), pos, np.int32)
    got, new = att.mla_apply(pt, cfg, torch.from_numpy(x),
                             torch.from_numpy(positions), cache=cache,
                             cache_pos=pos)
    assert new is cache                      # written in place
    want, ref_new = ref_att.mla_apply(CTX, p, ref_cfg, jnp.asarray(x),
                                      jnp.asarray(positions),
                                      cache=ref_cache, cache_pos=pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for name in ("latent", "k_rope"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(ref_new[name]), atol=1e-6)


def test_mla_cache_specs_match_reference():
    ref_cfg, cfg = _mla_cfgs()
    ref = ref_att.mla_cache_specs(ref_cfg, 3, 40, jnp.bfloat16)
    got = att.mla_cache_specs(cfg, 3, 40, torch.bfloat16)
    assert {k: s.shape for k, s in got.items()} == \
        {k: tuple(s.shape) for k, s in ref.items()}


@pytest.mark.parametrize("streams", [3, 2])
@pytest.mark.parametrize("rot", [None, 8])
def test_mrope_matches_reference(streams, rot):
    """Positions as (3, B, S) with distinct temporal/height/width streams
    (a vision prefix), or as (B, S) broadcast to all three."""
    a = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_kind="mrope",
             mrope_sections=(2, 3, 3) if rot is None else (1, 1, 2),
             rope_theta=1e6)
    ref_cfg, cfg = RefAttnConfig(**a), AttnConfig(**a)
    x = _x((2, 11, 4, 16), seed=5)
    rng = np.random.default_rng(6)
    if streams == 3:
        pos = rng.integers(0, 50, size=(3, 2, 11)).astype(np.int32)
    else:
        pos = np.arange(11, dtype=np.int32)[None].repeat(2, 0) + 4
    got = basic.apply_rope(cfg, torch.from_numpy(x), torch.from_numpy(pos),
                           rot)
    want = ref_basic.apply_rope(ref_cfg, jnp.asarray(x), jnp.asarray(pos),
                                rot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
