"""The port's model stack (``nn/basic``, ``nn/attention``, ``models/lm``,
``convert.lm_params_from_numpy``) against the JAX package's, on the same
parameters (made by the reference's ``init_tree`` and carried over as
numpy arrays) and the same inputs (numpy, seeded).

Tolerances: fp32 configs within 2e-4 on logits (tests/test_nn.py's), the
layers within 1e-5; bf16 within 3e-2 on logits and 2e-2 on a layer's
output (O(1) values): the reference scores attention in the input dtype
before its fp32 softmax and XLA fuses bf16 elementwise ops, so the two
round at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import shrink as ref_shrink
from repro.models.lm import LM as RefLM
from repro.nn import attention as ref_att
from repro.nn import basic as ref_basic
from repro.nn.config import AttnConfig as RefAttnConfig
from repro.nn.param import init_tree
from repro.nn.sharding import ShardCtx
from repro_torch.configs import get_config, shrink
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.models.lm import LM
from repro_torch.nn import attention as att
from repro_torch.nn import basic
from repro_torch.nn.config import AttnConfig, LayerSpec, ModelConfig
from repro_torch.nn.param import ParamSpec, init_params, param_count

torch.set_num_threads(1)
CTX = ShardCtx(None)
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dt="float32") -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(TDT[dt])


def _cfgs(name: str, dt: str, **kw):
    """The same shrunk config in both packages, in dtype ``dt``."""
    size = dict(d_model=64, vocab=128, n_repeat=2, **kw)
    ref = ref_shrink(ref_get_config(name), **size)
    port = shrink(get_config(name), **size)
    return (dataclasses.replace(ref, param_dtype=dt, compute_dtype=dt),
            dataclasses.replace(port, param_dtype=dt, compute_dtype=dt))


def _models(name: str, dt: str, seed: int = 0, **kw):
    ref_cfg, cfg = _cfgs(name, dt, **kw)
    ref = RefLM(ref_cfg)
    params = init_tree(jax.random.PRNGKey(seed), ref.param_specs())
    tree = jax.tree.map(np.asarray, params)
    return ref, params, LM(cfg), lm_params_from_numpy(tree, cfg, "cpu")


def _tokens(b: int, s: int, vocab: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, s)).astype(np.int32)


# ------------------------------------------------------------ layers


def _attn_pair(dt, **kw):
    a = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=1e6, **kw)
    return RefAttnConfig(**a), AttnConfig(**a)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rmsnorm_rope_ffn_match_reference(dt):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = rng.random(16).astype(np.float32) + 0.5
    tol = 1e-5 if dt == "float32" else 2e-2
    got = basic.rmsnorm({"scale": torch.from_numpy(scale)}, _t(x, dt), 1e-6)
    want = ref_basic.rmsnorm({"scale": jnp.asarray(scale)},
                             jnp.asarray(x, JDT[dt]), 1e-6)
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol)

    ref_cfg, cfg = _attn_pair(dt)
    pos = np.arange(7, dtype=np.int32)[None].repeat(2, 0) + 3
    for rot in (None, 8):
        got = basic.apply_rope(cfg, _t(x, dt), torch.from_numpy(pos), rot)
        want = ref_basic.apply_rope(ref_cfg, jnp.asarray(x, JDT[dt]),
                                    jnp.asarray(pos), rot)
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   atol=tol * 2)

    h = rng.standard_normal((3, 5, 32)).astype(np.float32)
    for act in ("swiglu", "gelu"):
        specs = ref_basic.ffn_specs(32, 48, JDT[dt], act)
        p = init_tree(jax.random.PRNGKey(2), specs)
        p = jax.tree.map(lambda a: a + 0.1, p)   # non-zero biases
        pt = {k: _t(np.asarray(v, np.float32), dt if v.dtype != jnp.float32
                    else "float32") for k, v in p.items()}
        got = basic.ffn(pt, _t(h, dt), act)
        want = ref_basic.ffn(CTX, p, jnp.asarray(h, JDT[dt]), act)
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   atol=tol * 4, rtol=tol)


def _gqa_params(ref_cfg, cfg, dt, seed=0):
    specs = ref_att.gqa_specs(ref_cfg, 32, JDT[dt])
    p = init_tree(jax.random.PRNGKey(seed), specs)
    if ref_cfg.qkv_bias:
        p = {k: (v + 0.05 if k.startswith("b") else v) for k, v in p.items()}
    tree = {k: np.asarray(v) for k, v in p.items()}
    lm_like = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k.startswith("b") else TDT[dt])
        for k, v in tree.items()}
    return p, lm_like


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,bias", [(None, True), (5, False)])
def test_gqa_prefill_matches_reference(dt, window, bias):
    ref_cfg, cfg = _attn_pair(dt, window=window, qkv_bias=bias)
    p, pt = _gqa_params(ref_cfg, cfg, dt)
    x = np.random.default_rng(3).standard_normal((2, 20, 32)) \
        .astype(np.float32)
    pos = np.arange(20, dtype=np.int32)[None].repeat(2, 0)
    before = flash_attention_fwd.plain_calls
    got, cache = att.gqa_apply(pt, cfg, _t(x, dt), torch.from_numpy(pos))
    assert flash_attention_fwd.plain_calls == before + 1
    want, ref_cache = ref_att.gqa_apply(CTX, p, ref_cfg,
                                        jnp.asarray(x, JDT[dt]),
                                        jnp.asarray(pos))
    tol = 1e-5 if dt == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].float().numpy(),
                                   _np(ref_cache[name]), atol=tol)


@pytest.mark.parametrize("case", ["full", "int8", "ring", "ring_wrapped"])
def test_gqa_decode_matches_reference(case):
    """One decode step against a cache holding random history: the full
    cache, the int8 cache (quantise, write, dequantise, attend), and a
    sliding-window ring before and after it wraps."""
    window = 8 if case.startswith("ring") else None
    ref_cfg, cfg = _attn_pair("float32", window=window, qkv_bias=True)
    p, pt = _gqa_params(ref_cfg, cfg, "float32", seed=4)
    rng = np.random.default_rng(5)
    s_cache = 8 if window else 24
    pos = {"full": 13, "int8": 9, "ring": 5, "ring_wrapped": 19}[case]
    x = rng.standard_normal((3, 1, 32)).astype(np.float32)
    hist = rng.standard_normal((2, 3, s_cache, 2, 16)).astype(np.float32)
    if case == "int8":
        k8, ks = ref_att._kv_quantize(jnp.asarray(hist[0]))
        v8, vs = ref_att._kv_quantize(jnp.asarray(hist[1]))
        ref_cache = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
        cache = {name: torch.from_numpy(np.asarray(a).copy())
                 for name, a in ref_cache.items()}
    else:
        ref_cache = {"k": jnp.asarray(hist[0]), "v": jnp.asarray(hist[1])}
        cache = {"k": torch.from_numpy(hist[0].copy()),
                 "v": torch.from_numpy(hist[1].copy())}
    positions = np.full((3, 1), pos, np.int32)
    before = decode_attention.plain_calls
    got, new = att.gqa_apply(pt, cfg, torch.from_numpy(x),
                             torch.from_numpy(positions), cache=cache,
                             cache_pos=pos)
    assert decode_attention.plain_calls == before + 1
    assert new is cache                      # updated in place
    want, ref_new = ref_att.gqa_apply(CTX, p, ref_cfg, jnp.asarray(x),
                                      jnp.asarray(positions),
                                      cache=ref_cache, cache_pos=pos)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)
    for name, a in ref_new.items():
        if a.dtype == jnp.int8:
            np.testing.assert_array_equal(cache[name].numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(cache[name].float().numpy(), _np(a),
                                       atol=1e-6)


def test_long_sequence_matches_reference_flash_branch():
    """Above 512 tokens the reference's prefill takes ``nn/flash``'s
    chunked ``sdpa_flash``; the port's kernel takes every length."""
    ref_cfg, cfg = _attn_pair("float32", window=100)
    p, pt = _gqa_params(ref_cfg, cfg, "float32", seed=6)
    x = np.random.default_rng(7).standard_normal((1, 600, 32)) \
        .astype(np.float32)
    pos = np.arange(600, dtype=np.int32)[None]
    assert 600 > ref_att.FLASH_THRESHOLD
    got, _ = att.gqa_apply(pt, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos))
    want, _ = ref_att.gqa_apply(CTX, p, ref_cfg, jnp.asarray(x),
                                jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


# ------------------------------------------------------------ the LM


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["search-r1-7b", "qwen3-0.6b"])
def test_lm_logits_match_reference(name, dt):
    """Full-forward logits and the prefill's last-position logits and
    caches of the shrunk agent (qkv bias, untied head) and judge (tied
    embeddings)."""
    ref, params, lm, pp = _models(name, dt)
    toks = _tokens(2, 24, 128)
    x = ref._embed(CTX, params, jnp.asarray(toks))
    h, _, _ = ref._run_stack(CTX, params, x, ref._positions(jnp.asarray(toks)))
    want = _np(ref._logits(CTX, params, h))
    t = torch.from_numpy(toks)
    hh, _, _ = lm._run_stack(pp, lm._embed(pp, t), lm._positions(t))
    got = lm._logits(pp, hh)
    assert got.dtype == TDT[dt] and got.shape == (2, 24, 128)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dt])
    last, caches = lm.prefill(pp, t)
    ref_last, ref_caches = ref.prefill(CTX, params, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(last.float().numpy(), _np(ref_last),
                               atol=TOL[dt])
    ref_k = _np(ref_caches["blocks"]["l0"]["mixer"]["k"])   # (R, B, S, KV, Dh)
    for i, layer in enumerate(caches["layers"]):
        # K after rope is O(3): in bf16 a few ulps apart relatively
        np.testing.assert_allclose(layer["mixer"]["k"].float().numpy(),
                                   ref_k[i], atol=TOL[dt], rtol=TOL[dt])


def _tiny_cfg(window=None) -> ModelConfig:
    attn = AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16, window=window)
    return ModelConfig("t", "dense", 64, 97,
                       blocks=(LayerSpec(kind="attn", attn=attn, d_ff=128),),
                       n_repeat=2, param_dtype="float32",
                       compute_dtype="float32")


def test_prefill_decode_consistency():
    """decode(t | prefill(0..t-1) cache) == full forward at position t
    (tests/test_nn.py:53's analogue): the flash kernel's path against the
    decode kernel's through the whole stack."""
    lm = LM(_tiny_cfg())
    params = init_params(lm.param_specs(), torch.Generator().manual_seed(0),
                         "cpu")
    s = 16
    toks = torch.from_numpy(_tokens(1, s + 1, 97))
    h, _, _ = lm._run_stack(params, lm._embed(params, toks),
                            lm._positions(toks))
    full = lm._logits(params, h)
    _, caches = lm.prefill(params, toks[:, :s])
    for layer in caches["layers"]:
        for name, buf in layer["mixer"].items():
            layer["mixer"][name] = torch.cat(
                [buf, torch.zeros_like(buf[:, :1])], dim=1)
    lg, _ = lm.decode(params, toks[:, s:s + 1], caches, s)
    np.testing.assert_allclose(lg[0, 0].numpy(), full[0, s].numpy(),
                               atol=2e-4)


def test_sliding_window_ring_decode_matches_full():
    """Ring-buffer sliding-window decode == full attention with the window
    mask (tests/test_nn.py:93's analogue): the ring's mask is the decode
    kernel's ``pos' = min(pos, S - 1)``."""
    cfg = _tiny_cfg(window=8)
    lm = LM(cfg)
    params = init_params(lm.param_specs(), torch.Generator().manual_seed(0),
                         "cpu")
    s = 24
    toks = torch.from_numpy(_tokens(1, s + 1, 97))
    h, _, _ = lm._run_stack(params, lm._embed(params, toks),
                            lm._positions(toks))
    full = lm._logits(params, h)
    caches = init_params(lm.cache_specs(1, s + 1), None, "cpu")
    assert caches["layers"][0]["mixer"]["k"].shape[1] == 8
    for t in range(s + 1):
        lg, caches = lm.decode(params, toks[:, t:t + 1], caches, t)
    np.testing.assert_allclose(lg[0, 0].numpy(), full[0, s].numpy(),
                               atol=3e-4)


def test_lm_decode_matches_reference_through_caches():
    """Step-by-step decode of the shrunk agent from empty caches, int8 KV
    too, logits within the fp32 tolerance of the reference's."""
    for kv_quant in (False, True):
        ref, params, lm, pp = _models("search-r1-7b", "float32", seed=2)
        toks = _tokens(2, 4, 128, seed=3)
        ref_c = jax.tree.map(jnp.zeros_like, init_tree(
            jax.random.PRNGKey(1), ref.cache_specs(2, 8, kv_quant=kv_quant)))
        caches = init_params(lm.cache_specs(2, 8, kv_quant=kv_quant), None,
                             "cpu")
        for t in range(4):
            want, ref_c = ref.decode(CTX, params, jnp.asarray(toks[:, t:t + 1]),
                                     ref_c, jnp.int32(t))
            got, caches = lm.decode(pp, torch.from_numpy(toks[:, t:t + 1]),
                                    caches, t)
            np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-4)


def test_lm_params_from_numpy_carries_bf16_bits():
    """A JAX bf16 tree (``ml_dtypes`` arrays) arrives bit for bit as
    ``torch.bfloat16``, each superblock layer of the scan stack as its own
    list entry, and the counts match the specs."""
    ref, params, lm, pp = _models("qwen3-0.6b", "bfloat16")
    table = np.asarray(params["embed"]["table"])
    assert table.dtype.name == "bfloat16"
    assert pp["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pp["embed"]["table"].view(torch.int16).numpy(), table.view(np.int16))
    wq = np.asarray(params["blocks"]["l0"]["mixer"]["wq"])   # (2, D, H*Dh)
    for r in range(2):
        np.testing.assert_array_equal(
            pp["layers"][r]["mixer"]["wq"].view(torch.int16).numpy(),
            wq[r].view(np.int16))
    assert "head" not in pp                        # tied embeddings
    assert param_count(lm.param_specs()) == sum(
        np.asarray(a).size for a in jax.tree.leaves(params))
    bad = jax.tree.map(np.asarray, params)
    bad["final_norm"]["scale"] = bad["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="spec"):
        lm_params_from_numpy(bad, lm.cfg, "cpu")


def test_init_params_draws_on_the_device_with_the_reference_laws():
    specs = {"w": ParamSpec((400, 300), torch.float32),
             "e": ParamSpec((50, 8), torch.bfloat16, scale=0.02),
             "u": ParamSpec((1000,), torch.float32, init="uniform", scale=0.5),
             "z": ParamSpec((3,), torch.float32, init="zeros"),
             "o": [ParamSpec((2,), torch.float16, init="ones")]}
    p = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    assert abs(p["w"].std().item() - 1 / np.sqrt(400)) < 2e-3
    assert p["e"].dtype == torch.bfloat16 and p["e"].float().std() < 0.03
    assert -0.5 <= p["u"].min().item() and p["u"].max().item() <= 0.5
    assert p["z"].tolist() == [0, 0, 0] and p["o"][0].tolist() == [1, 1]
    again = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["w"], again["w"])
