"""Kernels 6 and 7 at every shape the reference's attention takes: any
head dim Dh from 1 to 1024 and any G (the reference's Pallas kernels take
any Dh and G; its `_sdpa` runs the shrunk DeepSeek configs' folded q/k of
16 + 8 = 24). The CUDA kernels run only on the card, where
``chip_smoke.py attn_shapes`` holds every design to the plain versions;
here, on the CPU:

* the dispatch of both wrappers at every Dh × dtype × alignment: the
  design, the padded width of the tensor-core instance (the next multiple
  of 16 up to 128, of 32 above), the any-width CUDA-core design elsewhere,
  and the refusal above 1024; the alignment test at head widths whose rows
  leave 16-byte boundaries;
* kernel 7's split over G-tiles of 16 query rows and its scratch at G 17,
  29, 48, 71 and 128;
* the tensor-core rehearsal of test_torch_attention_designs.py (its
  rounding points) at padded widths, the rows zero-padded to the
  instance's width as the kernels pad them, and at G-tiles, against the
  Pallas kernels in interpret mode (bf16, 3e-2);
* the plain versions against the Pallas kernels at those shapes in fp32
  (3e-5, tests/test_kernels.py's);
* shrunk deepseek-v2 (MLA's folded q/k at 24, on the tensor-core design
  in bf16) and LMs whose AttnConfig is replaced to Dh 80 and to one KV
  head under 24 query heads, port against reference (2e-4,
  tests/test_torch_models.py's).
"""
import dataclasses
import math

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
from repro_torch.configs import get_config, shrink
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.lm import LM
from repro_torch.nn import flash as nn_flash
from repro_torch.nn.param import init_params
from test_torch_attention_designs import (_bf16, _c_signatures, _Entry,
                                          _tile_step, flash_tc_rehearsal)

torch.set_num_threads(1)
CTX = ShardCtx(None)
TOL_BF16 = 3e-2
TOL_FP32 = 3e-5
TOL_LM = 2e-4
NEG = -1.0e30
LOG2E = 1.4426950408889634
SMS = 132          # H100 SXM
VOCAB = 128
MODS = {"flash": fa, "decode": da}
SIMT_DIMS = {"flash": (16, 32, 64, 128, 192, 256),
             "decode": (16, 32, 64, 128, 256)}


# ------------------------------------------------------------ dispatch


@pytest.mark.parametrize("kernel", ["flash", "decode"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("aligned", [True, False])
def test_pick_design_at_every_head_dim(kernel, dtype, aligned):
    """Dh 1..1024: bf16 rows on 16-byte boundaries with Dh % 8 == 0 up to
    256 on the tensor cores, at the next multiple of 16 up to 128 and of
    32 above; everything else on the CUDA cores, at an instance of the
    models' widths or at Dh run time."""
    mod = MODS[kernel]
    seen = set()
    for dh in range(1, 1025):
        design = mod.pick_design(dtype, aligned, dh)
        if dtype == torch.bfloat16 and aligned and dh % 8 == 0 and dh <= 256:
            want = "tc"
            width = -(-dh // 16) * 16 if dh <= 128 else -(-dh // 32) * 32
            assert fa.tc_width(dh) == width and width >= dh
            assert width % 16 == 0 and width - dh < (16 if dh <= 128 else 32)
        else:
            want = "simt" if dh in SIMT_DIMS[kernel] else "simt_any"
        assert design == want, (dh, design, want)
        seen.add(design)
    # bf16 rows on 16-byte boundaries at the models' widths all go to
    # the tensor cores
    assert seen == ({"tc", "simt_any"}
                    if dtype == torch.bfloat16 and aligned
                    else {"simt", "simt_any"})
    for dh in (0, -1, 1025, 2048):
        with pytest.raises(ValueError, match=r"outside 1\.\.1024.*196,608"):
            mod.pick_design(dtype, aligned, dh)


def test_tc_widths_are_twelve():
    """The tensor-core instances: 12 widths, today's six among them."""
    widths = sorted({fa.tc_width(dh) for dh in range(1, 1025)} - {0})
    assert widths == [16, 32, 48, 64, 80, 96, 112, 128, 160, 192, 224, 256]
    assert {fa.tc_width(d) for d in fa.HEAD_DIMS} <= set(widths)
    assert all(fa.tc_width(d) == d for d in fa.HEAD_DIMS)
    assert [fa.tc_width(d) for d in (24, 80, 96, 40, 200, 8, 136)] == \
        [32, 80, 96, 48, 224, 16, 160]


@pytest.mark.parametrize("kernel", ["flash", "decode"])
@pytest.mark.parametrize("dh,width", [(16, 16), (24, 32), (80, 80),
                                      (200, 224)])
def test_tc_launch_passes_the_padded_width(monkeypatch, kernel, dh, width):
    """The wrapper owns the width rule: each tensor-core entry gets Dh and
    the instance's width ``tc_width(Dh)`` as its first two arguments."""
    import contextlib
    import types

    mod = MODS[kernel]
    lib = types.SimpleNamespace(**{n: _Entry() for n in _c_signatures(mod)})
    monkeypatch.setattr(mod.build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=5))
    wrapper = fa.flash_attention_fwd if kernel == "flash" else \
        da.decode_attention
    for name in ("launches", *(f"launches_{d}" for d in fa.DESIGNS)):
        monkeypatch.setattr(wrapper, name, 0)
    k = torch.zeros((1, 128, 1, dh), dtype=torch.bfloat16)
    if kernel == "flash":
        q = torch.zeros((1, 33, 1, 2, dh), dtype=torch.bfloat16)
        fa._launch("tc", q, k, k, 0.25, True, None, False)
        entry = lib.flash_attention_tc_launch
    else:
        monkeypatch.setattr(da, "_sm_count", lambda index: SMS)
        q = torch.zeros((1, 1, 24, dh), dtype=torch.bfloat16)
        da._launch("tc", q, k, k, 100, 0.25, False)
        entry = lib.decode_attention_tc_launch
    (call,) = entry.calls
    assert call[:2] == (dh, width)


def test_ctas_per_sm_is_two_up_to_128():
    """The wave that split_rows fills: two CTAs an SM up to Dh 128, one
    above (attention.cuh::ctas_per_sm_at sizes every instance so)."""
    assert [da.ctas_per_sm(d) for d in (1, 24, 128, 129, 256, 1024)] == \
        [2, 2, 2, 1, 1, 1]
    for dh in (0, 1025):
        with pytest.raises(ValueError, match=r"outside 1\.\.1024"):
            da.ctas_per_sm(dh)


@pytest.mark.parametrize("dh,dtype,aligned", [
    (24, torch.bfloat16, True), (12, torch.bfloat16, False),
    (80, torch.bfloat16, True), (3, torch.float32, False),
    (4, torch.float32, True), (100, torch.float32, True),
    (1, torch.bfloat16, False), (1024, torch.bfloat16, True)])
def test_rows_aligned_takes_the_head_width(dh, dtype, aligned):
    """A base pointer on a 16-byte boundary puts every row and head on
    one only where Dh elements make whole 16-byte chunks: Dh 12 in bf16
    and 3 in fp32 do not, so they take the element-wise loads."""
    q = torch.zeros((2, 5, 2, 3, dh), dtype=dtype)
    k = torch.zeros((2, 7, 2, dh), dtype=dtype)
    assert q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0
    assert fa.rows_aligned(q, k, k) == aligned
    assert da.rows_aligned(q[:, 0].contiguous(), k, k) == aligned


def _partial_rows(g: int) -> int:
    return da.g_tiles(g) * da.G_TILE


@pytest.mark.parametrize("g", [17, 29, 48, 71, 128])
@pytest.mark.parametrize("b,kvh,s,dh", [(4, 1, 8192, 128), (4, 8, 2048, 64),
                                         (1, 1, 32768, 96), (2, 2, 1024, 24)])
def test_split_and_scratch_over_g_tiles(g, b, kvh, s, dh):
    """ceil(G / 16) CTAs per (b, KV head, chunk): the split fills one wave
    of all of them (no chunk below MIN_CHUNK rows), and the scratch holds
    a partial per query row, G of them, whatever the tiles."""
    assert da.g_tiles(g) == -(-g // 16) and _partial_rows(g) >= g
    heads = b * kvh * da.g_tiles(g)
    chunk = da.split_rows(s, heads, SMS, da.ctas_per_sm(dh))
    nsplit = -(-s // chunk)
    assert chunk % da.TILE == 0 and chunk >= da.MIN_CHUNK
    assert heads * nsplit <= da.ctas_per_sm(dh) * SMS or chunk == da.MIN_CHUNK
    if nsplit > 1:   # one chunk fewer would leave SMs idle
        assert heads * (nsplit - 1) < da.ctas_per_sm(dh) * SMS
    # G-tiles share a wave: more tiles, fewer chunks each
    assert chunk >= da.split_rows(s, b * kvh, SMS, da.ctas_per_sm(dh))
    for design in ("tc", "simt", "simt_any"):
        shape = da.partial_shape(design, b * kvh, nsplit, g, dh)
        if design == "tc" and nsplit == 1:
            assert shape is None
        else:
            assert shape == (b * kvh, nsplit, g, dh + 2)


# ------------------------------------------- the tensor-core rehearsal


def _pad(x: torch.Tensor, width: int) -> torch.Tensor:
    """x's last dim zero-padded to ``width``, as cp_rows pads a row in
    shared memory."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def flash_tc_padded(q, k, v, scale, causal=True, window=None):
    """``flash_fwd_tc`` on the instance of width tc_width(Dh): the rows
    zero-padded (exact zeros in every score, accumulator columns never
    written out), 32-key tiles above 128."""
    dh = q.shape[-1]
    w = fa.tc_width(dh)
    out = flash_tc_rehearsal(_pad(q, w), _pad(k, w), _pad(v, w), scale,
                             causal, window, bk=32 if w > 128 else 64)
    return out[..., :dh]


def decode_tc_tiles(q, kc, vc, pos, scale, sms=SMS, tr=16, warps=4):
    """``decode_tc``'s arithmetic on the instance of width tc_width(Dh):
    chunks from ``split_rows`` over every (b, KV head, G-tile); in each, 4
    warps take 16-row tiles in turn with their own (m, l, acc), merged at
    the end; with several chunks, the combine's merge. A query row's
    arithmetic does not depend on its G-tile: the tiles set the split."""
    b, kvh, g, dh = q.shape
    w = fa.tc_width(dh)
    rows = min(pos, kc.shape[1] - 1) + 1
    chunk = da.split_rows(rows, b * kvh * da.g_tiles(g), sms, da.ctas_per_sm(w))
    qf = _pad(q, w).float()[..., None, :, :]            # (B, KV, 1, G, W)
    kf = _pad(kc, w).float().permute(0, 2, 1, 3)        # (B, KV, S, W)
    vf = _pad(vc, w).float().permute(0, 2, 1, 3)
    parts = []
    for j0 in range(0, rows, chunk):
        j1 = min(rows, j0 + chunk)
        ms, ls, accs = [], [], []
        for wp in range(warps):
            m = torch.full((b, kvh, 1, g), NEG)
            l = torch.zeros_like(m)
            acc = torch.zeros((b, kvh, 1, g, w))
            for r0 in range(j0 + wp * tr, j1, warps * tr):
                n = min(tr, j1 - r0)
                kt = torch.zeros((b, kvh, 1, tr, w))
                vt = torch.zeros_like(kt)
                kt[..., :n, :] = kf[:, :, None, r0:r0 + n]
                vt[..., :n, :] = vf[:, :, None, r0:r0 + n]
                s2 = (qf @ kt.transpose(-1, -2)) * (scale * LOG2E)
                s2 = torch.where(torch.arange(tr) < n, s2, -math.inf)
                m, l, acc = _tile_step(s2, m, l, acc, vt)
            ms.append(m)
            ls.append(l)
            accs.append(acc)
        m = torch.stack(ms)
        mx = m.amax(0)
        wt = torch.exp2(m - mx)
        parts.append((mx, (torch.stack(ls) * wt).sum(0),
                      (torch.stack(accs) * wt[..., None]).sum(0)))
    if len(parts) == 1:
        _, l, acc = parts[0]
    else:
        m = torch.stack([p[0] for p in parts]) / LOG2E
        wt = torch.exp(m - m.amax(0))
        l = (torch.stack([p[1] for p in parts]) * wt).sum(0)
        acc = (torch.stack([p[2] for p in parts]) * wt[..., None]).sum(0)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out[:, :, 0, :, :dh].to(torch.bfloat16)


# (B, Sq, Sk, KV, G, Dh, causal, window, bq, bk) at padded widths
FLASH_PADDED = [(1, 128, 128, 2, 2, 24, True, None, 64, 64),
                (1, 96, 96, 1, 2, 40, True, 33, 32, 32),
                (1, 128, 128, 2, 1, 80, True, None, 64, 64),
                (1, 64, 128, 1, 2, 96, False, None, 64, 64),
                (1, 64, 64, 1, 1, 200, True, None, 64, 64)]
# (B, KV, G, Dh, S, pos, bs): padded widths and G-tiles
DECODE_SHAPES = [(1, 2, 4, 24, 256, 200, 128), (1, 1, 2, 80, 512, 300, 128),
                 (2, 1, 24, 64, 512, 511, 128), (1, 1, 48, 96, 1024, 700, 256),
                 (1, 1, 71, 40, 512, 100, 128)]


def _jnp(x: torch.Tensor, dtype) -> jnp.ndarray:
    return jnp.asarray(x.float().numpy(), dtype)


@pytest.mark.parametrize("b,sq,sk,kv,g,dh,causal,win,bq,bk", FLASH_PADDED)
def test_flash_padded_rehearsal_matches_pallas(b, sq, sk, kv, g, dh, causal,
                                               win, bq, bk):
    rng = np.random.default_rng(12)
    q, k, v = (_bf16(rng, sh) for sh in ((b, sq, kv, g, dh),
                                          (b, sk, kv, dh), (b, sk, kv, dh)))
    assert fa.pick_design(q.dtype, fa.rows_aligned(q, k, v), dh) == "tc"
    scale = 1 / math.sqrt(dh)
    want = np.asarray(jax_flash(
        *(_jnp(x, jnp.bfloat16) for x in (q, k, v)), scale=scale,
        causal=causal, window=win, bq=bq, bk=bk), np.float32)
    got = flash_tc_padded(q, k, v, scale, causal, win)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL_BF16)


@pytest.mark.parametrize("b,kv,g,dh,s,pos,bs", DECODE_SHAPES)
def test_decode_tile_rehearsal_matches_pallas(b, kv, g, dh, s, pos, bs):
    rng = np.random.default_rng(13)
    q, kc, vc = (_bf16(rng, sh) for sh in ((b, kv, g, dh), (b, s, kv, dh),
                                            (b, s, kv, dh)))
    assert da.pick_design(q.dtype, da.rows_aligned(q, kc, vc), dh) == "tc"
    scale = 1 / math.sqrt(dh)
    want = np.asarray(jax_decode(*(_jnp(x, jnp.bfloat16) for x in (q, kc, vc)),
                                 pos, scale=scale, bs=bs), np.float32)
    got = decode_tc_tiles(q, kc, vc, pos, scale)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL_BF16)


@pytest.mark.parametrize("g,pos", [(24, 2047), (48, 255), (71, 1500),
                                   (128, 2047)])
def test_decode_tile_rehearsal_over_chunks_within_tolerance_of_plain(g, pos):
    """Several chunks of a long cache under one KV head (MQA), so the
    combine merges G-tiles' partials; against the plain version."""
    rng = np.random.default_rng(14)
    q = _bf16(rng, (2, 1, g, 64))
    kc, vc = (_bf16(rng, (2, 2048, 1, 64)) for _ in range(2))
    got = decode_tc_tiles(q, kc, vc, pos, 0.125)
    want = da.decode_attention_plain(q, kc, vc, pos, 0.125)
    assert float((got.float() - want.float()).abs().max()) <= TOL_BF16


# --------------------------------------- plain versions against Pallas


@pytest.mark.parametrize("b,sq,sk,kv,g,dh,causal,win,bq,bk", [
    *FLASH_PADDED, (1, 64, 64, 2, 2, 3, True, None, 32, 32),
    (1, 64, 32, 1, 1, 12, True, 5, 32, 32),
    (1, 32, 64, 1, 2, 320, False, None, 32, 32)])
def test_flash_plain_matches_pallas_fp32(b, sq, sk, kv, g, dh, causal, win,
                                         bq, bk):
    rng = np.random.default_rng(15)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, sq, kv, g, dh), (b, sk, kv, dh),
                          (b, sk, kv, dh)))
    scale = 1 / math.sqrt(dh)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     scale=scale, causal=causal, window=win, bq=bq, bk=bk)
    got = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                 scale=scale, causal=causal, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_FP32)


@pytest.mark.parametrize("b,kv,g,dh,s,pos,bs", [
    *DECODE_SHAPES, (1, 2, 17, 1, 256, 255, 128),
    (1, 1, 29, 12, 256, 100, 128), (1, 1, 3, 520, 256, 130, 128)])
def test_decode_plain_matches_pallas_fp32(b, kv, g, dh, s, pos, bs):
    rng = np.random.default_rng(16)
    q, kc, vc = (rng.standard_normal(sh).astype(np.float32)
                 for sh in ((b, kv, g, dh), (b, s, kv, dh), (b, s, kv, dh)))
    scale = 1 / math.sqrt(dh)
    want = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), pos,
                      scale=scale, bs=bs)
    got = da.decode_attention(*map(torch.from_numpy, (q, kc, vc)), pos,
                              scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_FP32)


# ------------------------------------------------------- through the LM


def _models(ref_cfg, cfg, seed: int = 0):
    """Both models in fp32 on the reference's parameters, their 1-d leaves
    moved off their constant init (as tests/test_torch_models.py does)."""
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_cfg, **fp32)
    cfg = dataclasses.replace(cfg, **fp32)
    ref = RefLM(ref_cfg)
    specs = ref.param_specs()
    params = jax.jit(lambda key: init_tree(key, specs))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(rng.uniform(-0.1, 0.1, a.shape),
                                  a.dtype) if a.ndim == 1 else a, params)
    tree = jax.tree.map(np.asarray, params)
    return ref, params, LM(cfg), lm_params_from_numpy(tree, cfg, "cpu")


def _shrunk(name: str, n_repeat: int = 1):
    size = dict(d_model=64, vocab=VOCAB, n_repeat=n_repeat, seq_chunk=4)
    return (ref_shrink(ref_get_config(name), **size),
            shrink(get_config(name), **size))


def _with_attn(cfg, **upd):
    """``cfg`` with every attention layer's AttnConfig replaced."""
    def fix(sp):
        if sp.attn is None:
            return sp
        return dataclasses.replace(sp, attn=dataclasses.replace(sp.attn,
                                                                 **upd))
    return dataclasses.replace(cfg, blocks=tuple(map(fix, cfg.blocks)),
                               prefix=tuple(map(fix, cfg.prefix)))


def _prefill_then_decode(ref, params, lm, pp, steps: int = 3):
    """Last-position prefill logits over 10 tokens and ``steps`` decode
    steps from empty caches, port against reference (each of the
    reference's two functions compiled once)."""
    toks = np.random.default_rng(1).integers(0, VOCAB, size=(2, 10)) \
        .astype(np.int32)
    prefill = jax.jit(lambda b: ref.prefill(CTX, params, b))
    decode = jax.jit(lambda *a: ref.decode(CTX, params, *a))
    want, _ = prefill({"tokens": jnp.asarray(toks)})
    got, _ = lm.prefill(pp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_LM)
    ref_c = init_tree(jax.random.PRNGKey(1), ref.cache_specs(2, steps))
    cc = init_params(lm.cache_specs(2, steps), None, "cpu")
    for t in range(steps):
        want, ref_c = decode(jnp.asarray(toks[:, t:t + 1]), ref_c,
                             jnp.int32(t))
        got, cc = lm.decode(pp, torch.from_numpy(toks[:, t:t + 1]), cc, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL_LM)


def _kernel6_inputs(monkeypatch) -> list:
    """Every (q, k, v) that reaches kernel 6 through nn/flash."""
    seen, real = [], nn_flash.flash_attention_fwd

    def record(q, k, v, **kw):
        seen.append((q, k, v))
        return real(q, k, v, **kw)
    monkeypatch.setattr(nn_flash, "flash_attention_fwd", record)
    return seen


def _mla_layer(seed: int = 0):
    """Shrunk deepseek-v2's MLA layer (nope 16 + rope 8, v 16) in both
    packages, on the reference's parameters."""
    from repro.nn import attention as ref_att

    ref_cfg, cfg = _shrunk("deepseek-v2-236b")
    ra, a = ref_cfg.blocks[0].attn, cfg.blocks[0].attn
    assert (a.qk_nope_dim, a.qk_rope_dim, a.v_head_dim) == (16, 8, 16)
    specs = ref_att.mla_specs(ra, ref_cfg.d_model, jnp.float32)
    p = jax.jit(lambda key: init_tree(key, specs))(jax.random.PRNGKey(seed))
    pt = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), p)
    return ref_att, ra, a, p, pt, ref_cfg.d_model


def test_shrunk_deepseek_v2_at_the_folded_24(monkeypatch):
    """shrink's MLA over 10 tokens: the port's prefill hands kernel 6 q/k/v
    24 wide where the reference scores them in `_sdpa`, then one absorbed
    decode step over the prefill's cache; port against reference. (The
    whole shrunk model is held in tests/test_torch_models.py, the
    reference's flash path above 512 tokens in tests/test_torch_mla.py.)
    In bf16 the port's prefill takes the tensor-core instance of width 32
    for the same inputs."""
    from repro_torch.nn import attention as att

    ref_att, ra, a, p, pt, d = _mla_layer()
    seen, s = _kernel6_inputs(monkeypatch), 10
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, s + 1, d)).astype(np.float32)
    pos = np.arange(s + 1, dtype=np.int32)[None].repeat(2, 0)
    got, cache = att.mla_apply(pt, a, torch.from_numpy(x[:, :s]),
                               torch.from_numpy(pos[:, :s]))
    # the reference's layer compiled once (its ops one by one compile each)
    ref_mla = jax.jit(lambda *args: ref_att.mla_apply(CTX, p, ra, *args))
    want, ref_cache = ref_mla(jnp.asarray(x[:, :s]), jnp.asarray(pos[:, :s]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_LM)
    assert [q.shape[-1] for q, _, _ in seen] == [24]
    grow = {k: torch.cat([v, torch.zeros_like(v[:, :1])], 1)
            for k, v in cache.items()}
    ref_grow = {k: jnp.concatenate([v, jnp.zeros_like(v[:, :1])], 1)
                for k, v in ref_cache.items()}
    got, _ = att.mla_apply(pt, a, torch.from_numpy(x[:, s:]),
                           torch.from_numpy(pos[:, s:]), grow, s)
    want, _ = ref_mla(jnp.asarray(x[:, s:]), jnp.asarray(pos[:, s:]),
                      ref_grow, jnp.int32(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_LM)
    seen.clear()
    bf = jax.tree.map(lambda t: t.to(torch.bfloat16), pt)
    att.mla_apply(bf, a, torch.from_numpy(x[:, :s]).to(torch.bfloat16),
                  torch.from_numpy(pos[:, :s]))
    (q, k, v), = seen
    assert q.dtype == torch.bfloat16 and q.shape[-1] == 24
    assert fa.pick_design(q.dtype, fa.rows_aligned(q, k, v), 24) == "tc"
    assert fa.tc_width(24) == 32


@pytest.mark.parametrize("upd,dh,g", [
    (dict(n_heads=2, n_kv_heads=2, head_dim=80), 80, 1),
    (dict(n_heads=24, n_kv_heads=1, head_dim=16), 16, 24)],
    ids=["dh80", "mqa-g24"])
def test_lm_at_other_attention_shapes(monkeypatch, upd, dh, g):
    """granite-3-8b shrunk to one layer with its AttnConfig replaced: heads
    of 80 (phi-2's width) and one KV head under 24 query heads (a
    multi-query model's G above one 16-row G-tile), port against
    reference; kernel 6 sees the width and G, and kernel 7's dispatch
    takes them."""
    ref_cfg, cfg = _shrunk("granite-3-8b")
    seen = _kernel6_inputs(monkeypatch)
    _prefill_then_decode(*_models(_with_attn(ref_cfg, **upd),
                                  _with_attn(cfg, **upd)))
    assert seen and {q.shape[-2:] for q, _, _ in seen} == {(g, dh)}
    assert da.pick_design(torch.bfloat16, True, dh) == "tc"
    assert da.g_tiles(g) == (2 if g > 16 else 1)
