"""The ten assigned architectures in the port (``models/lm`` with MoE, MLA,
M-RoPE, prefix layers, Mamba, mLSTM and sLSTM, the encoder-decoder, the
vision and audio stubs and the MTP block's parameters;
``serving/generator``) against the JAX package's, shrunk, in fp32, on the
reference's parameters (``init_tree``, carried over with
``convert.lm_params_from_numpy``) and seeded numpy inputs; and kernels 6
and 7's plain versions at the head dims these models add (192: MLA's
folded prefill; 256: gemma3) against the Pallas kernels in interpret mode.

Tolerances: logits within 2e-4 (tests/test_nn.py's, as in
tests/test_torch_lm.py); the batcher's tokens exactly; kernels 3e-5
(tests/test_kernels.py's fp32 tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import shrink as ref_shrink
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash
from repro.models.lm import LM as RefLM
from repro.nn.param import init_tree
from repro.nn.sharding import ShardCtx
from repro.serving.generator import ContinuousBatcher as RefBatcher
from repro.serving.generator import GenRequest as RefRequest
from repro_torch.configs import ASSIGNED, get_config, shrink
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.lm import LM
from repro_torch.nn.param import init_params
from repro_torch.serving.generator import ContinuousBatcher, GenRequest

torch.set_num_threads(1)
CTX = ShardCtx(None)
TOL = 2e-4
VOCAB = 128
RECURRENT = ["jamba-1.5-large-398b", "xlstm-350m"]
SLICE_11A = [*RECURRENT, "seamless-m4t-large-v2"]
ENC_LEN = 5       # seamless: encoder frames of the prefill and the caches
CHUNK = 4         # Mamba's and mLSTM's time chunk in the shrunk configs


def _cfgs(name: str, n_repeat: int = 1):
    size = dict(d_model=64, vocab=VOCAB, n_repeat=n_repeat, seq_chunk=CHUNK)
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    return (dataclasses.replace(ref_shrink(ref_get_config(name), **size),
                                **fp32),
            dataclasses.replace(shrink(get_config(name), **size), **fp32))


def _models(name: str, seed: int = 0, n_repeat: int = 1):
    """Both models on the reference's parameters, their 1-d fp32 leaves
    (norm scales, biases, the sigmoid router's bias) moved off their
    constant init so that every leaf matters."""
    ref_cfg, cfg = _cfgs(name, n_repeat)
    ref = RefLM(ref_cfg)
    params = init_tree(jax.random.PRNGKey(seed), ref.param_specs())
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(rng.uniform(-0.1, 0.1, a.shape),
                                  a.dtype) if a.ndim == 1 else a, params)
    tree = jax.tree.map(np.asarray, params)
    return ref, params, LM(cfg), lm_params_from_numpy(tree, cfg, "cpu")


def _tokens(b: int, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, VOCAB, size=(b, s)).astype(np.int32)


def _vision_inputs(b: int, s: int, n_img: int = 6, seed: int = 2):
    """A frontend embedding on the first ``n_img`` positions and (3, B, S)
    M-RoPE positions whose height and width streams differ there."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, s, 64)).astype(np.float32)
    mask = np.zeros((b, s), bool)
    mask[:, :n_img] = True
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
    pos[1, :, :n_img] = np.arange(n_img) // 2
    pos[2, :, :n_img] = np.arange(n_img) % 2
    return {"frontend_emb": emb, "frontend_mask": mask, "positions": pos}


def _enc_emb(b: int, s: int = ENC_LEN, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, s, 64)) \
        .astype(np.float32)


@pytest.mark.parametrize("name", ASSIGNED)
def test_assigned_prefill_and_decode_match_reference(name):
    """Last-position prefill logits over 12 tokens (three Mamba / mLSTM
    chunks; qwen2-vl with its frontend inputs and M-RoPE positions,
    seamless over ENC_LEN encoder frames) and three decode steps from
    empty caches (seamless's cross rows zero)."""
    ref, params, lm, pp = _models(name)
    toks = _tokens(2, 12)
    batch = {"tokens": toks}
    if lm.cfg.frontend == "vision":
        batch.update(_vision_inputs(2, 12))
    if lm.cfg.enc_dec:
        batch["enc_emb"] = _enc_emb(2)
    want, _ = ref.prefill(CTX, params,
                          {k: jnp.asarray(v) for k, v in batch.items()})
    got, caches = lm.prefill(pp, torch.from_numpy(toks), **{
        k: torch.from_numpy(v) for k, v in batch.items() if k != "tokens"})
    assert got.shape == (2, 1, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    assert len(caches["layers"]) == len(lm.cfg.layer_iter())
    enc_len = ENC_LEN if lm.cfg.enc_dec else 0
    ref_c = init_tree(jax.random.PRNGKey(1),
                      ref.cache_specs(2, 6, enc_len=enc_len))
    cc = init_params(lm.cache_specs(2, 6, enc_len=enc_len), None, "cpu")
    for t in range(3):
        want, ref_c = ref.decode(CTX, params, jnp.asarray(toks[:, t:t + 1]),
                                 ref_c, jnp.int32(t))
        got, cc = lm.decode(pp, torch.from_numpy(toks[:, t:t + 1]), cc, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def _fold_ring(lm, caches, prompt: int):
    """Decode caches from a prefill of ``prompt`` tokens, as decode would
    have written them: a sliding-window layer's last ``window`` rows into
    its ring (row t at slot t % window), a full layer's rows plus one
    empty row for the next token."""
    out = []
    for spec, layer in zip(lm.layers, caches["layers"]):
        mix = {}
        for name, buf in layer["mixer"].items():
            w = spec.attn.window
            if w is not None and prompt > w:
                ring = torch.zeros_like(buf[:, :w])
                for t in range(prompt - w, prompt):
                    ring[:, t % w] = buf[:, t]
                mix[name] = ring
            else:
                mix[name] = torch.cat([buf, torch.zeros_like(buf[:, :1])], 1)
        out.append({"mixer": mix})
    return {"layers": out}


def _ref_tree(ref_cfg, port_caches):
    """The port's per-layer cache list as the reference's tree (prefix list,
    superblock positions stacked over n_repeat when n_repeat > 1)."""
    layers = [jax.tree.map(lambda t: jnp.array(t.numpy()), c)
              for c in port_caches["layers"]]
    npre, nb = len(ref_cfg.prefix), len(ref_cfg.blocks)
    rest = layers[npre:]
    blocks = {}
    for i in range(nb):
        reps = rest[i::nb]
        blocks[f"l{i}"] = reps[0] if ref_cfg.n_repeat == 1 else \
            jax.tree.map(lambda *a: jnp.stack(a), *reps)
    tree = {"blocks": blocks}
    if npre:
        tree["prefix"] = layers[:npre]
    return tree


def test_gemma3_decode_past_the_window_on_a_ring():
    """Shrunk gemma3 (window 8 on five of six layers), a 20-token prompt:
    prefill, fold each local layer's last 8 rows into its ring, decode
    token 20. The port's decode equals the reference's decode on the same
    ring, and the full forward's logits at position 20."""
    ref, params, lm, pp = _models("gemma3-12b")
    assert [sp.attn.window for sp in lm.layers] == [8] * 5 + [None]
    toks = _tokens(1, 21, seed=7)
    t = torch.from_numpy(toks)
    h, _, _ = lm._run_stack(pp, lm._embed(pp, t), lm._positions(t))
    full = lm._logits(pp, h)[:, -1:]
    _, caches = lm.prefill(pp, t[:, :20])
    caches = _fold_ring(lm, caches, 20)
    assert caches["layers"][0]["mixer"]["k"].shape[1] == 8
    ref_caches = _ref_tree(ref.cfg, caches)
    got, _ = lm.decode(pp, t[:, 20:], caches, 20)
    want, _ = ref.decode(CTX, params, jnp.asarray(toks[:, 20:]), ref_caches,
                         jnp.int32(20))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=TOL)


def _with_capacity(cfg, factor):
    return dataclasses.replace(cfg, **{part: tuple(
        dataclasses.replace(sp, moe=dataclasses.replace(
            sp.moe, capacity_factor=factor)) if sp.moe else sp
        for sp in getattr(cfg, part)) for part in ("prefix", "blocks")})


def test_moe_capacity_drops_through_the_model():
    """Shrunk deepseek-v2 at capacity factor 1: the prefill drops choices
    and its logits still equal the reference's. A one-token decode never
    drops, so decode after prefill differs from the full forward when the
    last token's experts were full; at a factor no choice can overflow
    (n_experts / top_k) the two agree (chip_smoke.py holds deepseek's
    decode after prefill there)."""
    from repro_torch.nn import moe

    ref, params, lm, pp = _models("deepseek-v2-236b")
    ref = RefLM(_with_capacity(ref.cfg, 1.0))
    lm1 = LM(_with_capacity(lm.cfg, 1.0))
    toks = _tokens(1, 21, seed=8)
    t = torch.from_numpy(toks)
    xg = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 20, 64)).astype(np.float32))
    plan = moe.moe_plan(pp["layers"][1]["moe"], lm1.layers[1].moe, xg)
    assert int((plan[5] == 4 * plan[6]).sum()) > 0
    want, _ = ref.prefill(CTX, params, {"tokens": jnp.asarray(toks)})
    got, _ = lm1.prefill(pp, t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    for factor, agree in ((1.0, False), (2.0, True)):
        m = LM(_with_capacity(lm.cfg, factor))
        h, _, _ = m._run_stack(pp, m._embed(pp, t), m._positions(t))
        full = m._logits(pp, h)[:, -1:]
        _, caches = m.prefill(pp, t[:, :20])
        caches = _fold_ring(m, caches, 20)
        dec, _ = m.decode(pp, t[:, 20:], caches, 20)
        assert np.allclose(dec.numpy(), full.numpy(), atol=TOL) == agree


def _requests(cls, n=5, seed=1, max_new=6):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(1, VOCAB, size=int(rng.integers(3, 8))),
                max_new=max_new) for i in range(n)]


@pytest.mark.parametrize("name,max_len", [("deepseek-v3-671b", 32),
                                          ("gemma3-12b", 24),
                                          ("jamba-1.5-large-398b", 32),
                                          ("xlstm-350m", 32)])
def test_batcher_tokens_equal_reference(name, max_len):
    """The same requests through both packages' ContinuousBatcher: the
    same tokens (MoE dispatch at the batcher's slots, MLA latent decode,
    gemma3's window-8 rings wrapping; jamba's and xlstm's recurrent states,
    which every step advances in every slot, idle ones on token 0, and
    which admit never clears, as in the reference: ROADMAP section 3)."""
    ref_cfg, cfg = _cfgs(name)
    params = init_tree(jax.random.PRNGKey(4), RefLM(ref_cfg).param_specs())
    ref = RefBatcher(ref_cfg, params=params, slots=3, max_len=max_len)
    port = ContinuousBatcher(cfg, slots=3, max_len=max_len, device="cpu",
                             params=lm_params_from_numpy(
                                 jax.tree.map(np.asarray, params), cfg,
                                 "cpu"))
    ref_reqs, reqs = _requests(RefRequest), _requests(GenRequest)
    for a, b in zip(ref_reqs, reqs):
        ref.submit(a)
        port.submit(b)
    assert port.run() == ref.run()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert all(r.done for r in reqs)


def test_params_carry_prefix_moe_mla_and_mtp():
    """deepseek-v3's tree: the three dense prefix layers first, the MoE
    leaves (the router and its bias in fp32) and the MTP block carried
    leaf for leaf."""
    ref, params, lm, pp = _models("deepseek-v3-671b")
    assert len(pp["layers"]) == 4
    for i in range(3):
        assert "ffn" in pp["layers"][i] and "moe" not in pp["layers"][i]
        np.testing.assert_array_equal(
            pp["layers"][i]["mixer"]["w_uk"].numpy(),
            np.asarray(params["prefix"][i]["mixer"]["w_uk"]))
    moe = pp["layers"][3]["moe"]
    assert moe["router"].dtype == moe["router_bias"].dtype == torch.float32
    np.testing.assert_array_equal(moe["router_bias"].numpy(), np.asarray(
        params["blocks"]["l0"]["moe"]["router_bias"]))
    np.testing.assert_array_equal(
        pp["mtp"]["block"]["moe"]["w_down"].numpy(),
        np.asarray(params["mtp"]["block"]["moe"]["w_down"]))


def _grow(lm, caches, rows: int):
    """A prefill's caches made ready for ``rows`` more decode steps: each
    attention layer's K/V grown by ``rows`` empty rows; recurrent states
    and cross K/V as they are."""
    for spec, layer in zip(lm.layers, caches["layers"]):
        if spec.kind == "attn":
            layer["mixer"] = {k: torch.cat([b, b.new_zeros(
                (b.shape[0], rows, *b.shape[2:]))], 1)
                for k, b in layer["mixer"].items()}
    return caches


@pytest.mark.parametrize("name", SLICE_11A)
def test_prefill_over_chunks_equals_prefill_then_decode(name):
    """A 12-token prefill (three chunks of the shrunk Mamba and mLSTM
    layers) against a 4-token prefill (one chunk) and eight decode steps
    through the caches it returned (recurrent states, K/V, seamless's
    cross K/V): the last logits agree, with each other and with the
    reference's 12-token prefill."""
    ref, params, lm, pp = _models(name, seed=5)
    toks = _tokens(1, 12, seed=6)
    extra = {"enc_emb": _enc_emb(1)} if lm.cfg.enc_dec else {}
    want, _ = ref.prefill(CTX, params, {
        "tokens": jnp.asarray(toks),
        **{k: jnp.asarray(v) for k, v in extra.items()}})
    extra = {k: torch.from_numpy(v) for k, v in extra.items()}
    full, _ = lm.prefill(pp, torch.from_numpy(toks), **extra)
    _, caches = lm.prefill(pp, torch.from_numpy(toks[:, :4]), **extra)
    caches = _grow(lm, caches, 8)
    for t in range(4, 12):
        got, caches = lm.decode(pp, torch.from_numpy(toks[:, t:t + 1]),
                                caches, t)
    logits = got.numpy()
    np.testing.assert_allclose(logits, full.numpy(), atol=TOL)
    np.testing.assert_allclose(logits, np.asarray(want), atol=TOL)


def test_recurrent_decode_matches_reference_on_prefill_states():
    """jamba's and xlstm's decode from a prefill's states (Mamba's conv and
    SSM states, mLSTM's closed-form final state, sLSTM's scan state, the
    attention layer's K/V) equals the reference's decode on the same
    caches, step for step."""
    for name in RECURRENT:
        ref, params, lm, pp = _models(name, seed=7)
        toks = _tokens(2, 11, seed=8)
        _, caches = lm.prefill(pp, torch.from_numpy(toks[:, :8]))
        caches = _grow(lm, caches, 3)
        ref_c = _ref_tree(ref.cfg, caches)
        for t in range(8, 11):
            want, ref_c = ref.decode(CTX, params,
                                     jnp.asarray(toks[:, t:t + 1]), ref_c,
                                     jnp.int32(t))
            got, caches = lm.decode(pp, torch.from_numpy(toks[:, t:t + 1]),
                                    caches, t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL, err_msg=name)


@pytest.mark.parametrize("name", ASSIGNED)
def test_every_assigned_config_builds_at_published_width(name):
    """``LM(get_config(name))`` for all ten: the parameter tree holds the
    reference's parameter count and bytes (the encoder, Mamba, xLSTM and
    cross-attention leaves included)."""
    from repro_torch.nn.param import param_bytes, param_count

    specs = LM(get_config(name)).param_specs()
    ref = jax.tree.leaves(RefLM(ref_get_config(name)).param_specs(),
                          is_leaf=lambda x: hasattr(x, "shape"))
    assert param_count(specs) == sum(int(np.prod(s.shape)) for s in ref)
    assert param_bytes(specs) == sum(
        int(np.prod(s.shape)) * jnp.dtype(s.dtype).itemsize for s in ref)


def _arr(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("dh", [192, 256])
@pytest.mark.parametrize("sq,sk,causal,win,bq,bk", [
    (64, 64, True, None, 32, 32), (48, 64, False, None, 16, 32),
    (64, 64, True, 20, 32, 16)])
def test_flash_plain_matches_pallas_at_wide_heads(dh, sq, sk, causal, win,
                                                  bq, bk):
    q, k, v = _arr((1, sq, 2, 2, dh), 1), _arr((1, sk, 2, dh), 2), \
        _arr((1, sk, 2, dh), 3)
    scale = 1 / np.sqrt(dh)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), scale=scale, causal=causal,
                                window=win, bq=bq, bk=bk))
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), scale, causal, win)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


@pytest.mark.parametrize("g,pos", [(2, 0), (2, 37), (7, 63)])
def test_decode_plain_matches_pallas_at_dh_256(g, pos):
    q, kc, vc = _arr((2, 2, g, 256), 4), _arr((2, 64, 2, 256), 5), \
        _arr((2, 64, 2, 256), 6)
    scale = 1 / 16
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), pos, scale=scale, bs=32))
    got = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), pos, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
