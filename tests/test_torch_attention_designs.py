"""The two designs of kernels 6 and 7 (``flash_attention_fwd``,
``decode_attention``): which inputs take the bf16 tensor-core kernels, the
split of a cache into chunks and the scratch it needs, and a rehearsal of
the tensor-core kernels' rounding points in torch on the CPU.

The CUDA kernels run only on the card, where chip_smoke.py holds both
designs to the plain versions. What can be shown here, before any card
time, is that the tensor-core design's arithmetic fits the tolerance: the
rehearsal below rounds where ``flash_fwd_tc`` and ``decode_tc`` round
(bf16 Q/K/V; fp32 scores in the log2 domain; P rounded to bf16 before
P.V; l summed from the fp32 p; the online rescale once per key tile, in
the kernels' tile order: 64-key tiles per 64-row query block for kernel 6,
16-row tiles dealt to 4 warps per chunk and merged at the end for kernel
7), and is held to the Pallas kernels in interpret mode at
tests/test_kernels.py:39-87's shapes and to the plain versions at the
full-width shapes of chip_smoke.py, shrunk in length. Tolerance: 3e-2 in
bf16 (chip_smoke.ATTN_TOL, tests/test_kernels.py's).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

TOL_BF16 = 3e-2
NEG = -1.0e30
LOG2E = 1.4426950408889634
SMS = 132          # H100 SXM
# CTAs per SM of kernel 7 at each head dim, as the built library gives them
# (decode_attention_ctas_per_sm, attention.cuh::ctas_per_sm): one at Dh 256
CTAS_PER_SM = {16: 2, 32: 2, 64: 2, 128: 2, 256: 1}


def _bf16(rng, shape) -> torch.Tensor:
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _tile_step(s2, m, l, acc, vt):
    """One key tile of the online softmax on log2-domain scores ``s2``
    (..., rows, keys): returns the new (m, l, acc); p rounded to bf16 only
    for P.V."""
    m_new = torch.maximum(m, s2.amax(-1))
    alpha = torch.exp2(m - m_new)
    p = torch.exp2(s2 - m_new[..., None])
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vt
    return m_new, l, acc


def flash_tc_rehearsal(q, k, v, scale, causal=True, window=None,
                       bq=64, bk=64):
    """``flash_fwd_tc``'s arithmetic: per 64-row query block, 64-key tiles
    from the skip range (Sq <= Sk) with -1e30 masks and -inf past Sk."""
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    qf = q.float().permute(0, 2, 3, 1, 4)            # (B, KV, G, Sq, Dh)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]   # (B, KV, 1, Sk, Dh)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    out = torch.empty_like(qf)
    skip = sq <= sk
    for q0 in range(0, sq, bq):
        rows = torch.arange(q0, min(q0 + bq, sq))
        kbeg, kend = 0, sk
        if skip:
            if causal:
                kend = min(sk, q0 + bq)
            if window:
                kbeg = max(0, q0 - window + 1) // bk * bk
        m = torch.full((b, kvh, g, len(rows)), NEG)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, g, len(rows), dh))
        for k0 in range(kbeg, kend, bk):
            kj = torch.arange(k0, k0 + bk)
            kt = torch.zeros((b, kvh, 1, bk, dh))
            vt = torch.zeros_like(kt)
            n = min(bk, sk - k0)
            kt[..., :n, :], vt[..., :n, :] = kf[..., k0:k0 + n, :], \
                vf[..., k0:k0 + n, :]
            s2 = (qf[..., rows, :] @ kt.transpose(-1, -2)) * (scale * LOG2E)
            ok = torch.ones((len(rows), bk), dtype=torch.bool)
            if causal:
                ok &= kj[None] <= rows[:, None]
            if window:
                ok &= kj[None] > rows[:, None] - window
            s2 = torch.where(ok, s2, NEG)
            s2 = torch.where(kj < sk, s2, -math.inf)
            m, l, acc = _tile_step(s2, m, l, acc, vt)
        out[..., rows, :] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(torch.bfloat16)


def decode_tc_rehearsal(q, kc, vc, pos, scale, sms=SMS, tr=16, warps=4):
    """``decode_tc``'s arithmetic: chunks from ``split_rows``; in each, 4
    warps take 16-row tiles in turn, each with its own (m, l, acc), merged
    at the end; with several chunks, ``decode_combine``'s merge."""
    b, kvh, g, dh = q.shape
    rows = min(pos, kc.shape[1] - 1) + 1
    chunk = da.split_rows(rows, b * kvh, sms, CTAS_PER_SM[dh])
    qf = q.float()[..., None, :, :]                    # (B, KV, 1, G, Dh)
    kf = kc.float().permute(0, 2, 1, 3)                # (B, KV, S, Dh)
    vf = vc.float().permute(0, 2, 1, 3)
    parts = []
    for j0 in range(0, rows, chunk):
        j1 = min(rows, j0 + chunk)
        ms, ls, accs = [], [], []
        for w in range(warps):
            m = torch.full((b, kvh, 1, g), NEG)
            l = torch.zeros_like(m)
            acc = torch.zeros((b, kvh, 1, g, dh))
            for r0 in range(j0 + w * tr, j1, warps * tr):
                n = min(tr, j1 - r0)
                kt = torch.zeros((b, kvh, 1, tr, dh))
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
    else:  # decode_combine, on m in natural-log units
        m = torch.stack([p[0] for p in parts]) / LOG2E
        wt = torch.exp(m - m.amax(0))
        l = (torch.stack([p[1] for p in parts]) * wt).sum(0)
        acc = (torch.stack([p[2] for p in parts]) * wt[..., None]).sum(0)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out[:, :, 0].to(torch.bfloat16)


# ----------------------------------------------------------- the dispatch

@pytest.mark.parametrize("mod", [fa, da], ids=["flash", "decode"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_pick_design(mod, dtype, aligned, dh):
    want = "tc" if dtype == torch.bfloat16 and aligned else "simt"
    assert mod.pick_design(dtype, aligned, dh) == want


@pytest.mark.parametrize("mod,dh", [
    (fa, 8), (fa, 48), (fa, 512), (da, 8), (da, 48), (da, 512),
    (da, 192)], ids=["flash-8", "flash-48", "flash-512", "decode-8",
                     "decode-48", "decode-512", "decode-192"])
def test_pick_design_refuses_other_head_dims(mod, dh):
    """Head dims with no kernel instance stay refused; 192 is kernel 6's
    only (MLA's folded prefill: its decode runs over the latent, with no
    kernel)."""
    with pytest.raises(ValueError, match="head dim"):
        mod.pick_design(torch.bfloat16, True, dh)


@pytest.mark.parametrize("mod,dh", [(fa, 192), (fa, 256), (da, 256)],
                         ids=["flash-192", "flash-256", "decode-256"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("aligned", [True, False])
def test_pick_design_takes_wide_heads(mod, dh, dtype, aligned):
    """The wide heads of gemma3 (256) and MLA's prefill (192) take the same
    rule as the others: bf16 rows on 16-byte boundaries to the tensor
    cores, the rest to the CUDA cores."""
    want = "tc" if dtype == torch.bfloat16 and aligned else "simt"
    assert mod.pick_design(dtype, aligned, dh) == want


@pytest.mark.parametrize("s,chunks_128,chunks_256", [
    (1024, 4, 4), (8192, 8, 4), (32768, 8, 4)])
def test_split_at_dh_256_fills_one_wave_of_one_cta_per_sm(s, chunks_128,
                                                           chunks_256):
    """gemma3's decode (B 4 x KV 8 = 32 heads): at Dh 256 one CTA of either
    design has the SM (shared memory), so the split aims at one CTA per
    SM, half the chunks of Dh 128 once the cache is long."""
    for dh, want in ((128, chunks_128), (256, chunks_256)):
        chunk = da.split_rows(s, 32, SMS, CTAS_PER_SM[dh])
        assert -(-s // chunk) == want
        assert 32 * want <= CTAS_PER_SM[dh] * SMS


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def test_rows_aligned():
    """The wrapper's alignment test: base pointers and row strides; a dim
    of size 1 does not count (its stride is never used)."""
    rng = np.random.default_rng(0)
    q = _bf16(rng, (2, 40, 2, 2, 16))
    k = _bf16(rng, (2, 40, 2, 16))
    assert fa.rows_aligned(q, k, k) and da.rows_aligned(q, k, k)
    assert not fa.rows_aligned(_misaligned(q), k, k)
    assert not da.rows_aligned(q, _misaligned(k), k)
    odd = torch.empty((2, 41, 2, 2, 16), dtype=torch.bfloat16)[:, 1:]
    assert odd.data_ptr() % 16 == 0 and fa.rows_aligned(odd, k, k)
    # sequence stride of 68 bf16 (136 bytes): rows off 16-byte boundaries
    wide = torch.empty((2, 40, 68), dtype=torch.bfloat16)[..., :64]
    assert not fa.rows_aligned(wide.unflatten(-1, (2, 2, 16)), k, k)
    # a batch of 1 with a stride that is no multiple of 16 bytes
    one = torch.empty((1, 40, 2, 2, 16), dtype=torch.bfloat16)
    one = one.as_strided(one.shape, (7, *one.stride()[1:]))
    assert fa._row_strides(one) == (0, one.stride(1))
    assert fa.rows_aligned(one, k, k)


# ------------------------------------------------- split and scratch plan

@pytest.mark.parametrize("b,kvh,s,pos,nsplit", [
    (4, 4, 128, 127, 1),          # the batcher: one chunk, one launch
    (1, 4, 128, 0, 1),
    (1, 2, 1024, 255, 1),         # pos = chunk - 1
    (1, 2, 1024, 256, 2),         # pos = chunk: a second chunk
    (1, 4, 32768, 32767, 64),
    (8, 4, 32768, 32767, 8),
])
def test_split_and_scratch(b, kvh, s, pos, nsplit):
    rows = min(pos, s - 1) + 1
    chunk = da.split_rows(rows, b * kvh, SMS, CTAS_PER_SM[128])
    assert -(-rows // chunk) == nsplit
    tc = da.partial_shape("tc", b * kvh, nsplit, 8, 128)
    simt = da.partial_shape("simt", b * kvh, nsplit, 8, 128)
    assert simt == (b * kvh, nsplit, 8, 130)
    assert tc == (None if nsplit == 1 else simt)


# ---------------------------------------------- the rounding rehearsal

# tests/test_kernels.py:39-46's flash shapes, in bf16
FLASH_REF = [
    (2, 256, 256, 2, 2, 32, True, None, 64, 64),
    (1, 128, 128, 4, 1, 64, True, 48, 64, 32),
    (2, 128, 256, 2, 4, 16, False, None, 128, 128),
    (1, 512, 512, 1, 8, 128, True, None, 256, 128),
]
# tests/test_kernels.py:71-78's decode shapes, in bf16
DECODE_REF = [
    (2, 2, 4, 32, 256, 100, 64),
    (1, 4, 1, 64, 512, 511, 128),
    (4, 1, 8, 16, 128, 0, 128),
    (1, 8, 16, 128, 1024, 700, 256),
]


@pytest.mark.parametrize("b,sq,sk,kv,g,dh,causal,win,bq,bk", FLASH_REF)
def test_flash_rehearsal_matches_pallas(b, sq, sk, kv, g, dh, causal, win,
                                        bq, bk):
    rng = np.random.default_rng(2)
    q, k, v = (_bf16(rng, sh) for sh in ((b, sq, kv, g, dh),
                                          (b, sk, kv, dh), (b, sk, kv, dh)))
    scale = 1 / math.sqrt(dh)
    want = np.asarray(jax_flash(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
        scale=scale, causal=causal, window=win, bq=bq, bk=bk), np.float32)
    got = flash_tc_rehearsal(q, k, v, scale, causal, win)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL_BF16)


@pytest.mark.parametrize("b,kv,g,dh,s,pos,bs", DECODE_REF)
def test_decode_rehearsal_matches_pallas(b, kv, g, dh, s, pos, bs):
    rng = np.random.default_rng(3)
    q, kc, vc = (_bf16(rng, sh) for sh in ((b, kv, g, dh), (b, s, kv, dh),
                                            (b, s, kv, dh)))
    scale = 1 / math.sqrt(dh)
    want = np.asarray(jax_decode(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, kc, vc)),
        pos, scale=scale, bs=bs), np.float32)
    got = decode_tc_rehearsal(q, kc, vc, pos, scale)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL_BF16)


# chip_smoke.FLASH_FULL (B, Sq, KV, G) at Dh 128, the agent's 4096-token
# prefill cut to 512 and the judge's micro-batch of 8 to 2; plus edges of
# the 64-row tiles
FLASH_FULL_SHRUNK = [(1, 128, 8, 2), (2, 128, 8, 2), (1, 512, 4, 8),
                     (1, 65, 2, 2), (2, 63, 1, 1), (1, 1, 2, 2)]
# chip_smoke.DECODE_FULL (B, S) at KV 4, G 8, Dh 128, pos = S - 1, with
# 32768 cut to 2048 (8 chunks at B=1, so the combine runs)
DECODE_FULL_SHRUNK = [(1, 128), (4, 128), (8, 128), (1, 2048), (4, 2048)]


@pytest.mark.parametrize("b,s,kvh,g", FLASH_FULL_SHRUNK)
def test_flash_rehearsal_within_tolerance_of_plain(b, s, kvh, g):
    rng = np.random.default_rng(4)
    q = _bf16(rng, (b, s, kvh, g, 128))
    k, v = (_bf16(rng, (b, s, kvh, 128)) for _ in range(2))
    scale = 1 / math.sqrt(128)
    got = flash_tc_rehearsal(q, k, v, scale)
    want = fa.flash_attention_plain(q, k, v, scale)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL_BF16


@pytest.mark.parametrize("b,s", DECODE_FULL_SHRUNK)
def test_decode_rehearsal_within_tolerance_of_plain(b, s):
    rng = np.random.default_rng(5)
    q = _bf16(rng, (b, 4, 8, 128))
    kc, vc = (_bf16(rng, (b, s, 4, 128)) for _ in range(2))
    scale = 1 / math.sqrt(128)
    got = decode_tc_rehearsal(q, kc, vc, s - 1, scale)
    want = da.decode_attention_plain(q, kc, vc, s - 1, scale)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL_BF16


@pytest.mark.parametrize("g", [1, 7, 8, 16])
@pytest.mark.parametrize("pos", [0, 63, 64, 65, 255, 256, 1023])
def test_decode_rehearsal_edges(g, pos):
    """chip_smoke's decode edges: G off the 16-row tile, pos at the tile
    and chunk edges (a chunk is 256 rows here)."""
    rng = np.random.default_rng(6)
    q = _bf16(rng, (1, 2, g, 32))
    kc, vc = (_bf16(rng, (1, 1024, 2, 32)) for _ in range(2))
    scale = 1 / math.sqrt(32)
    got = decode_tc_rehearsal(q, kc, vc, pos, scale)
    want = da.decode_attention_plain(q, kc, vc, pos, scale)
    assert float((got.float() - want.float()).abs().max()) <= TOL_BF16


@pytest.mark.parametrize("dh", [192, 256])
@pytest.mark.parametrize("window", [None, 40])
def test_flash_rehearsal_at_wide_heads_within_tolerance_of_plain(dh, window):
    """``flash_fwd_tc`` at Dh 192 and 256 takes 32-key tiles (and reads
    Q's fragments from shared memory, which rounds nothing): the
    rehearsal with bk = 32 against the plain version."""
    rng = np.random.default_rng(7)
    q = _bf16(rng, (1, 96, 2, 2, dh))
    k, v = (_bf16(rng, (1, 96, 2, dh)) for _ in range(2))
    scale = 1 / math.sqrt(dh)
    got = flash_tc_rehearsal(q, k, v, scale, True, window, bk=32)
    want = fa.flash_attention_plain(q, k, v, scale, True, window)
    assert float((got.float() - want.float()).abs().max()) <= TOL_BF16


@pytest.mark.parametrize("s,pos", [(128, 127), (1024, 700), (2048, 2047)])
def test_decode_rehearsal_at_dh_256_within_tolerance_of_plain(s, pos):
    """gemma3's decode (KV 8, G 2, Dh 256) at one chunk and several: the
    chunks from ``split_rows`` at Dh 256 (one CTA per SM)."""
    rng = np.random.default_rng(8)
    q = _bf16(rng, (4, 8, 2, 256))
    kc, vc = (_bf16(rng, (4, s, 8, 256)) for _ in range(2))
    got = decode_tc_rehearsal(q, kc, vc, pos, 1 / 16)
    want = da.decode_attention_plain(q, kc, vc, pos, 1 / 16)
    assert float((got.float() - want.float()).abs().max()) <= TOL_BF16


# ------------------------------------------------- the C entry points

def _c_signatures(mod) -> dict:
    """Each extern "C" function of the module's CUDA source: its
    parameters as ctypes types."""
    import ctypes
    import re
    from pathlib import Path

    kind = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}
    src = (Path(mod.__file__).parent / "csrc" /
           f"{mod.__name__.rsplit('.', 1)[1]}.cu").read_text()
    body = src[src.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"^(?:int|const char\*) (\w+)\(([^)]*)\)", body,
                         re.M):
        params = [" ".join(x.split()) for x in m.group(2).split(",")]
        out[m.group(1)] = [ctypes.c_void_p if "*" in x else
                           kind[x.rsplit(" ", 1)[0]] for x in params]
    return out


class _Entry:
    def __init__(self):
        self.calls, self.argtypes, self.restype = [], None, None

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("mod", [fa, da], ids=["flash", "decode"])
def test_ctypes_signatures_match_the_c_entry_points(monkeypatch, mod):
    """``_lib`` types every entry point as the source declares it (kernel
    6's two launchers take the lse pointer after the output)."""
    import types

    sigs = _c_signatures(mod)
    lib = types.SimpleNamespace(**{n: _Entry() for n in sigs})
    monkeypatch.setattr(mod.build, "load", lambda name: lib)
    assert mod._lib() is lib
    for name, params in sigs.items():
        assert getattr(lib, name).argtypes == params, name
    if mod is fa:
        for name in ("flash_attention_launch", "flash_attention_tc_launch"):
            n = 7 if name == "flash_attention_launch" else 6
            assert len(sigs[name]) == n + 15   # ... q, k, v, o, lse, b, ...
    else:
        for name in ("decode_attention_launch", "decode_attention_tc_launch"):
            n = 8 if name == "decode_attention_launch" else 7
            assert len(sigs[name]) == n + 8    # ... o, lse, part, b, ...


@pytest.mark.parametrize("design", ["tc", "simt"])
@pytest.mark.parametrize("return_lse", [False, True])
def test_flash_launch_passes_lse_or_null(monkeypatch, design, return_lse):
    """``_launch`` hands the kernel a fresh (B, KV, G, Sq) fp32 lse after
    the output with ``return_lse``, else a null pointer (None)."""
    import contextlib
    import types

    lib = types.SimpleNamespace(**{n: _Entry() for n in _c_signatures(fa)})
    monkeypatch.setattr(fa.build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=5))
    for name in ("launches", "launches_tc", "launches_simt"):
        monkeypatch.setattr(fa.flash_attention_fwd, name, 0)
    q = torch.zeros((2, 33, 2, 3, 16), dtype=torch.bfloat16)
    k = v = torch.zeros((2, 40, 2, 16), dtype=torch.bfloat16)
    got = fa._launch(design, q, k, v, 0.25, True, None, return_lse)
    entry = lib.flash_attention_tc_launch if design == "tc" else \
        lib.flash_attention_launch
    (call,) = entry.calls
    at = 4 if design == "tc" else 5           # after dh (and dtype), q, k, v
    out, lse = got if return_lse else (got, None)
    assert call[at] == out.data_ptr()
    if return_lse:
        assert lse.shape == (2, 2, 3, 33) and lse.dtype == torch.float32
        assert call[at + 1] == lse.data_ptr()
    else:
        assert call[at + 1] is None
    assert call[at + 2:at + 7] == (2, 33, 40, 2, 3) and call[-1] == 5
    assert (fa.flash_attention_fwd.launches,
            getattr(fa.flash_attention_fwd, f"launches_{design}")) == (1, 1)


@pytest.mark.parametrize("design", ["tc", "simt"])
@pytest.mark.parametrize("return_lse", [False, True])
@pytest.mark.parametrize("pos", [100, 3000])
def test_decode_launch_passes_lse_or_null(monkeypatch, design, return_lse,
                                          pos):
    """``_launch`` hands kernel 7 a fresh (B, KV, G) fp32 lse after the
    output with ``return_lse``, else a null pointer (None), then the
    scratch (None only for the tensor-core design's one chunk)."""
    import contextlib
    import types

    lib = types.SimpleNamespace(**{n: _Entry() for n in _c_signatures(da)})
    monkeypatch.setattr(da.build, "load", lambda name: lib)
    monkeypatch.setattr(da, "_sm_count", lambda index: 132)
    monkeypatch.setattr(da, "ctas_per_sm", lambda dh: 2)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=5))
    for name in ("launches", "launches_tc", "launches_simt"):
        monkeypatch.setattr(da.decode_attention, name, 0)
    q = torch.zeros((2, 2, 3, 16), dtype=torch.bfloat16)
    kc = vc = torch.zeros((2, 4096, 2, 16), dtype=torch.bfloat16)
    got = da._launch(design, q, kc, vc, pos, 0.25, return_lse)
    entry = lib.decode_attention_tc_launch if design == "tc" else \
        lib.decode_attention_launch
    (call,) = entry.calls
    at = 4 if design == "tc" else 5           # after dh (and dtype), q, k, v
    out, lse = got if return_lse else (got, None)
    assert call[at] == out.data_ptr()
    if return_lse:
        assert lse.shape == (2, 2, 3) and lse.dtype == torch.float32
        assert call[at + 1] == lse.data_ptr()
    else:
        assert call[at + 1] is None
    one_chunk = design == "tc" and pos < da.MIN_CHUNK
    assert (call[at + 2] is None) == one_chunk
    assert call[at + 3:at + 8] == (2, 4096, 2, 3, pos + 1) and call[-1] == 5
    assert (da.decode_attention.launches,
            getattr(da.decode_attention, f"launches_{design}")) == (1, 1)


@pytest.mark.parametrize("cut", [1, 37, 64, 99])
def test_decode_lse_merges_split_rows(cut):
    """The plain version's lse is the masked scores' log-sum-exp, and two
    calls over rows ``0..cut-1`` and ``cut..pos`` merged by it (the mesh's
    combine in ``nn/attention.decode_attend``) give the call over all."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((2, 2, 3, 16)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((2, 128, 2, 16))
                               .astype(np.float32)) for _ in range(2))
    pos, scale = 99, 0.25
    whole, lse = da.decode_attention(q, kc, vc, pos, scale=scale,
                                     return_lse=True)
    s = np.einsum("bkgd,bskd->bkgs", q.numpy().astype(np.float64),
                  kc.numpy()[:, :pos + 1].astype(np.float64)) * scale
    mx = s.max(-1)
    want = mx + np.log(np.exp(s - mx[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    parts = [da.decode_attention(q, kc[:, :cut].contiguous(),
                                 vc[:, :cut].contiguous(), cut - 1,
                                 scale=scale, return_lse=True),
             da.decode_attention(q, kc[:, cut:].contiguous(),
                                 vc[:, cut:].contiguous(), pos - cut,
                                 scale=scale, return_lse=True)]
    m = torch.maximum(parts[0][1], parts[1][1])
    wts = [torch.exp(l - m) for _, l in parts]
    merged = sum(o * w[..., None] for (o, _), w in zip(parts, wts)) \
        / sum(wts)[..., None]
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=0,
                               atol=1e-5)
