"""The port's encoder-decoder pieces against the JAX package's, in fp32 on
the reference's parameters and seeded numpy inputs: ``cross_kv`` and
``gqa_apply`` with ``kv_override`` (kernel 6 without the causal mask in a
prefill, kernel 7 over every cross row in a decode; their plain versions
on the CPU), the bidirectional encoder attention ``_bidir_attn``,
``_encode``, and the shrunk seamless-m4t-large-v2's prefill (with
``enc_emb``) and decode through the cross K/V in its caches; the batcher
refuses an encoder-decoder config.

Tolerances: 1e-5 on a layer's output, 2e-4 on logits (tests/test_nn.py's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import shrink as ref_shrink
from repro.models import lm as ref_lm
from repro.nn import attention as ref_att
from repro.nn.config import AttnConfig as RefAttnConfig
from repro.nn.param import init_tree
from repro.nn.sharding import ShardCtx
from repro_torch.configs import get_config, shrink
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.models import lm
from repro_torch.nn import attention as att
from repro_torch.nn.config import AttnConfig
from repro_torch.nn.param import init_params
from repro_torch.serving.generator import ContinuousBatcher

torch.set_num_threads(1)
CTX = ShardCtx(None)
TOL = 2e-4
LAYER_TOL = 1e-5
NAME = "seamless-m4t-large-v2"
VOCAB = 128


def _attn(**kw):
    a = dict(dict(n_heads=4, n_kv_heads=2, head_dim=16), **kw)
    return RefAttnConfig(**a), AttnConfig(**a)


def _gqa(ref_cfg, seed=0):
    p = init_tree(jax.random.PRNGKey(seed),
                  ref_att.gqa_specs(ref_cfg, 32, jnp.float32))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _arr(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("sq,sk", [(5, 11), (11, 5), (1, 7)])
def test_cross_attention_prefill_matches_reference(sq, sk):
    """``cross_kv`` of an encoder output and the decoder's queries over
    all of its rows, Sq below, above and at one against Sk: one call of
    kernel 6 (its plain version here) without the causal mask."""
    ref_cfg, cfg = _attn(rope_kind="none")
    p, pt = _gqa(ref_cfg)
    enc, x = _arr((2, sk, 32), 1), _arr((2, sq, 32), 2)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (2, sq)).copy()
    rk, rv = ref_att.cross_kv(CTX, {"wk": p["wk"], "wv": p["wv"]}, ref_cfg,
                              jnp.asarray(enc))
    k, v = att.cross_kv(pt, cfg, torch.from_numpy(enc))
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), atol=LAYER_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=LAYER_TOL)
    want, _ = ref_att.gqa_apply(CTX, p, ref_cfg, jnp.asarray(x),
                                jnp.asarray(pos), kv_override=(rk, rv))
    before = (flash_attention_fwd.plain_calls, decode_attention.plain_calls)
    got, cache = att.gqa_apply(pt, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos), kv_override=(k, v))
    assert cache is None
    assert (flash_attention_fwd.plain_calls,
            decode_attention.plain_calls) == (before[0] + 1, before[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_TOL)


@pytest.mark.parametrize("sk", [1, 9])
def test_cross_attention_decode_matches_reference(sk):
    """One token over cached cross K/V: kernel 7 at pos = Sk - 1 (every
    row, the reference's all-true mask); a longer step is refused."""
    ref_cfg, cfg = _attn(rope_kind="none")
    p, pt = _gqa(ref_cfg, seed=3)
    k, v = _arr((2, sk, 2, 16), 4), _arr((2, sk, 2, 16), 5)
    x = _arr((2, 1, 32), 6)
    pos = np.full((2, 1), 7, np.int32)
    want, _ = ref_att.gqa_apply(CTX, p, ref_cfg, jnp.asarray(x),
                                jnp.asarray(pos),
                                kv_override=(jnp.asarray(k), jnp.asarray(v)))
    before = (flash_attention_fwd.plain_calls, decode_attention.plain_calls)
    got, _ = att.gqa_apply(pt, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos), cache_pos=7,
                           kv_override=tuple(map(torch.from_numpy, (k, v))))
    assert (flash_attention_fwd.plain_calls,
            decode_attention.plain_calls) == (before[0], before[1] + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_TOL)
    with pytest.raises(ValueError, match="one token"):
        att.gqa_apply(pt, cfg, torch.from_numpy(_arr((2, 2, 32), 7)),
                      torch.from_numpy(np.zeros((2, 2), np.int32)),
                      cache_pos=7,
                      kv_override=tuple(map(torch.from_numpy, (k, v))))


@pytest.mark.parametrize("kv,rope", [(2, "rope"), (4, "rope"), (2, "none")])
def test_bidir_attention_matches_reference(kv, rope):
    """The encoder's self-attention: rope on q and k (or none), no mask,
    GQA and MHA; kernel 6 without the causal mask."""
    ref_cfg, cfg = _attn(rope_kind=rope, n_kv_heads=kv)
    p, pt = _gqa(ref_cfg, seed=8)
    x = _arr((2, 13, 32), 9)
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13)).copy()
    want, _ = ref_lm._bidir_attn(CTX, p, ref_cfg, jnp.asarray(x),
                                 jnp.asarray(pos))
    before = flash_attention_fwd.plain_calls
    got = lm._bidir_attn(pt, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert flash_attention_fwd.plain_calls == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_TOL)


def _models(n_repeat: int = 1, enc_repeat: int = 1, seed: int = 0):
    """The shrunk seamless in both packages (n_repeat decoder layers,
    enc_repeat encoder layers), fp32, on the reference's parameters with
    their 1-d leaves moved off their init."""
    fp32 = dict(param_dtype="float32", compute_dtype="float32",
                enc_repeat=enc_repeat)
    size = dict(d_model=64, vocab=VOCAB, n_repeat=n_repeat)
    ref_cfg = dataclasses.replace(ref_shrink(ref_get_config(NAME), **size),
                                  **fp32)
    cfg = dataclasses.replace(shrink(get_config(NAME), **size), **fp32)
    ref = ref_lm.LM(ref_cfg)
    params = init_tree(jax.random.PRNGKey(seed), ref.param_specs())
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(rng.uniform(-0.1, 0.1, a.shape), a.dtype)
        if a.ndim == 1 else a, params)
    return ref, params, lm.LM(cfg), lm_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu")


def test_params_carry_the_encoder_stack():
    """``enc_blocks`` stacked over enc_repeat 3 arrive as three encoder
    layers in order; ``enc_norm``, ``frontend_proj`` and the decoder's
    ``cross``/``cross_norm`` leaf for leaf."""
    ref, params, m, pp = _models(n_repeat=2, enc_repeat=3)
    assert len(pp["enc_layers"]) == 3 and len(pp["layers"]) == 2
    for r in range(3):
        np.testing.assert_array_equal(
            pp["enc_layers"][r]["mixer"]["wq"].numpy(),
            np.asarray(params["enc_blocks"]["l0"]["mixer"]["wq"][r]))
    np.testing.assert_array_equal(
        pp["layers"][1]["cross"]["wv"].numpy(),
        np.asarray(params["blocks"]["l0"]["cross"]["wv"][1]))
    np.testing.assert_array_equal(pp["enc_norm"]["scale"].numpy(),
                                  np.asarray(params["enc_norm"]["scale"]))
    assert "frontend_proj" in pp and "cross_norm" in pp["layers"][0]


def test_encode_matches_reference():
    """``_encode``: three bidirectional layers at positions 0..S-1, then
    ``enc_norm``."""
    ref, params, m, pp = _models(enc_repeat=3)
    emb = _arr((2, 10, 64), 10)
    want = ref._encode(CTX, params, jnp.asarray(emb))
    got = m._encode(pp, torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def _enc_tree(ref_cfg, port_caches):
    """The port's per-layer cache list as the reference's tree (each
    superblock position stacked over n_repeat when n_repeat > 1)."""
    layers = [jax.tree.map(lambda t: jnp.array(t.numpy()), c)
              for c in port_caches["layers"]]
    if ref_cfg.n_repeat == 1:
        return {"blocks": {"l0": layers[0]}}
    return {"blocks": {"l0": jax.tree.map(lambda *a: jnp.stack(a),
                                          *layers)}}


@pytest.mark.parametrize("sq,s_enc", [(12, 20), (20, 12)])
def test_seamless_prefill_and_decode_match_reference(sq, s_enc):
    """Prefill logits over ``enc_emb``, the caches' decoder and cross K/V;
    then three decode steps on the prefill's caches (each self K/V grown
    by three empty rows), which read the cross K/V from the caches, held
    to the reference's decode on the same caches and to the full forward
    of the longer prompt."""
    ref, params, m, pp = _models(n_repeat=2, enc_repeat=2)
    toks = np.random.default_rng(11).integers(0, VOCAB, (2, sq + 3)) \
        .astype(np.int32)
    emb = _arr((2, s_enc, 64), 12)
    want, ref_caches = ref.prefill(CTX, params, {
        "tokens": jnp.asarray(toks[:, :sq]), "enc_emb": jnp.asarray(emb)})
    got, caches = m.prefill(pp, torch.from_numpy(toks[:, :sq]),
                            enc_emb=torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    for i, layer in enumerate(caches["layers"]):
        assert layer["cross_kv"]["k"].shape == (2, s_enc, 4, 16)
        for part, name in (("mixer", "k"), ("cross_kv", "v")):
            np.testing.assert_allclose(
                layer[part][name].numpy(),
                np.asarray(ref_caches["blocks"]["l0"][part][name][i]),
                atol=TOL)
    for layer in caches["layers"]:
        layer["mixer"] = {k: torch.cat([b, torch.zeros_like(b[:, :3])], 1)
                          for k, b in layer["mixer"].items()}
    ref_c = _enc_tree(ref.cfg, caches)
    for t in range(sq, sq + 3):
        want, ref_c = ref.decode(CTX, params, jnp.asarray(toks[:, t:t + 1]),
                                 ref_c, jnp.int32(t))
        got, caches = m.decode(pp, torch.from_numpy(toks[:, t:t + 1]),
                               caches, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    full, _ = m.prefill(pp, torch.from_numpy(toks),
                        enc_emb=torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=TOL)


def test_seamless_decode_from_cache_specs_matches_reference():
    """Decode from the zeroed ``cache_specs(batch, s_cache, enc_len)``,
    as the reference's smoke test does: its all-zero cross K/V give every
    row the mean of zero values."""
    ref, params, m, pp = _models()
    toks = np.random.default_rng(13).integers(0, VOCAB, (2, 3)) \
        .astype(np.int32)
    ref_c = jax.tree.map(jnp.zeros_like, init_tree(
        jax.random.PRNGKey(1), ref.cache_specs(2, 8, enc_len=5)))
    cc = init_params(m.cache_specs(2, 8, enc_len=5), None, "cpu")
    assert cc["layers"][0]["cross_kv"]["k"].shape == (2, 5, 4, 16)
    for t in range(3):
        want, ref_c = ref.decode(CTX, params, jnp.asarray(toks[:, t:t + 1]),
                                 ref_c, jnp.int32(t))
        got, cc = m.decode(pp, torch.from_numpy(toks[:, t:t + 1]), cc, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_seamless_prefill_needs_enc_emb_and_the_batcher_refuses_it():
    """An encoder-decoder prefill without ``enc_emb`` raises; the
    batcher, decoder-only as the reference's is (it passes no encoder
    output and its caches have no cross rows), refuses the config."""
    _, _, m, pp = _models()
    with pytest.raises(ValueError, match="enc_emb"):
        m.prefill(pp, torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="decoder-only"):
        ContinuousBatcher(m.cfg, params=pp, device="cpu")
