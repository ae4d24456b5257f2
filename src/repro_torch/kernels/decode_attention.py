"""Decode attention: one new query token per (batch, KV head) against a KV
cache (every decode step of the continuous batcher), as CUDA kernels for
Hopper (``csrc/decode_attention.cu``) beside its plain PyTorch version.

Replaces ``repro/kernels/decode_attention.py::_decode_kernel``, the Pallas
TPU kernel, with its contract: ``q`` (B, KV, G, Dh), ``k_cache``/``v_cache``
(B, S, KV, Dh), fp32 or bf16, and a host integer ``pos`` -> (B, KV, G, Dh)
in q's dtype: the G query rows of each KV head attend over cache rows
``0..pos`` (the caller has written the new token's K/V at ``pos``), with
an fp32 softmax.

What bounds it on an H100: the bytes of cache rows 0..pos of K and V (the
Pallas kernel streams the whole cache; these kernels read only those rows).
For one batch row of the agent (KV 4, Dh 128, bf16) at pos = 32767 that is
67 MB per layer, about 20 µs.

Both designs split the rows (split-S, flash-decoding), because (b, KV
head) pairs alone would leave most of the 132 SMs idle (4 CTAs for one
agent row): :func:`split_rows` picks the chunk of cache rows per CTA so
that the CTAs fill the card in one wave, and one chunk when the cache is
short. :func:`pick_design` chooses the design from the dtype and the
alignment (``csrc/decode_attention.cu`` has the details):

* ``"tc"``: bf16 caches on 16-byte boundaries, which is every decode step
  of the LM path. The G <= 16 query rows are one ``mma.sync`` tile (padded
  to 16); each of a CTA's 4 warps streams its own 16-row tiles through a
  3-stage bf16 ring filled by ``cp.async`` and keeps its own (m, l, acc);
  the warps merge once at the end. With one chunk (the batcher's
  ``max_len`` of 128) that is the only launch and no scratch is allocated;
  with more, a combine pass merges the chunks' partials.
* ``"simt"``: fp32 (its 3e-5 check rules out bf16 products) and caches
  off a 16-byte boundary: 64-row tiles staged as fp32, fp32 FMAs on the
  CUDA cores, always a partial pass and a combine pass.

:func:`decode_attention` launches the kernels for CUDA tensors and raises
if it cannot; it takes :func:`decode_attention_plain` only for CPU tensors.
``decode_attention.launches`` counts every call that launched,
``.launches_tc`` and ``.launches_simt`` each design's, and ``.plain_calls``
the plain version's calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention

NEG = -1.0e30
HEAD_DIMS = (16, 32, 64, 128, 256)   # not kernel 6's 192: MLA decodes
                                     # over its latent, with no kernel
G_MAX = 16
TILE = 64          # chunks are multiples of 64 cache rows (one simt tile,
                   # one 16-row tile for each of a tc CTA's 4 warps)
MIN_CHUNK = 256    # no split below 4 tiles per tc warp
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def pick_design(dtype: torch.dtype, aligned: bool, dh: int) -> str:
    """Kernel 6's dispatch rule (``flash_attention.dtype_design``) for
    this kernel's head dims."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    return flash_attention.dtype_design(dtype, aligned)


@functools.lru_cache(maxsize=None)
def ctas_per_sm(dh: int) -> int:
    """CTAs of either design that share an SM at head dim ``dh``, from the
    built library (``attention.cuh::ctas_per_sm``: two up to Dh 128, one
    above)."""
    n = _lib().decode_attention_ctas_per_sm(dh)
    if n < 1:
        raise ValueError(f"head dim {dh} has no decode_attention instance")
    return n


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: int,
                           scale: float) -> torch.Tensor:
    """Plain PyTorch version (the reference's ``decode_attention_ref``):
    the fp32 softmax over the whole cache with rows past ``pos`` masked."""
    s_cache = k_cache.shape[1]
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k_cache.float()) * scale
    valid = torch.arange(s_cache, device=q.device) <= pos
    s = torch.where(valid, s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, v_cache.float()).to(q.dtype)


def split_rows(rows: int, heads: int, sms: int, ctas: int) -> int:
    """Cache rows per CTA for ``rows`` rows over ``heads`` (b, KV head)
    pairs on ``sms`` SMs: as many chunks per pair as fit the card in one
    wave of ``ctas`` CTAs per SM (:func:`ctas_per_sm`; a second,
    partial wave would double the time), each a multiple of TILE rows, and
    no chunk below MIN_CHUNK rows: a shorter one fills no warp's ring and
    costs the combine pass more than it saves, so a short cache (the
    batcher's 128 rows) is one chunk and one launch."""
    want = max(1, ctas * sms // heads)
    chunk = -(-rows // want)
    return max(MIN_CHUNK, -(-chunk // TILE) * TILE)


def rows_aligned(*xs: torch.Tensor) -> bool:
    """Every row of each contiguous tensor starts on a 16-byte boundary:
    the base pointer is (Dh * element size is a multiple of 16)."""
    return all(x.data_ptr() % 16 == 0 for x in xs)


def partial_shape(design: str, heads: int, nsplit: int, g: int,
                  dh: int) -> tuple[int, ...] | None:
    """The fp32 scratch of the chunks' (m, l, acc) per query row, or None
    where one launch writes the output itself (the tc design, one chunk)."""
    if design == "tc" and nsplit == 1:
        return None
    return (heads, nsplit, g, dh + 2)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k_cache, v_cache, pos) -> None:
    if q.ndim != 4 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"want q (B, KV, G, Dh), caches (B, S, KV, Dh); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, kvh, g, dh = q.shape
    if (k_cache.shape[0], k_cache.shape[2], k_cache.shape[3]) != \
            (b, kvh, dh) or k_cache.shape[1] < 1:
        raise ValueError(f"q {tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} disagree on B, KV or Dh")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise TypeError(f"q and the caches must all be float32 or bfloat16; "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if not isinstance(pos, int) or pos < 0:
        raise ValueError(f"pos must be a host int >= 0, got {pos!r}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{k_cache.device}, {v_cache.device}")


def _lib():
    lib = build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = [
            i, i, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        lib.decode_attention_launch.restype = i
        lib.decode_attention_tc_launch.argtypes = [
            i, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        lib.decode_attention_tc_launch.restype = i
        lib.decode_attention_ctas_per_sm.argtypes = [i]
        lib.decode_attention_ctas_per_sm.restype = i
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     scale: float) -> torch.Tensor:
    """Attention of one token's G query rows per KV head over cache rows
    ``0..pos`` (all rows when ``pos >= S``). CUDA tensors take
    :func:`pick_design`'s kernels. Inputs that require grad are refused
    while grad mode is on (``flash_attention.refuse_grad``)."""
    _check(q, k_cache, v_cache, pos)
    flash_attention.refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.device.type == "cpu":
        decode_attention.plain_calls += 1
        return decode_attention_plain(q, k_cache, v_cache, pos, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.shape[2] > G_MAX:
        raise ValueError(f"G={q.shape[2]} above {G_MAX}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("decode_attention needs contiguous q and caches")
    design = pick_design(q.dtype, rows_aligned(q, k_cache, v_cache),
                         q.shape[-1])
    return _launch(design, q, k_cache, v_cache, pos, scale)


def _launch(design: str, q: torch.Tensor, k_cache: torch.Tensor,
            v_cache: torch.Tensor, pos: int, scale: float) -> torch.Tensor:
    """Launch ``design``'s kernels on checked CUDA inputs and count the
    call (chip_smoke.py also calls it to time the CUDA-core design on
    inputs the dispatch sends to the tensor cores)."""
    b, kvh, g, dh = q.shape
    s_cache = k_cache.shape[1]
    rows = min(pos, s_cache - 1) + 1
    chunk = split_rows(rows, b * kvh, _sm_count(q.device.index),
                       ctas_per_sm(dh))
    shape = partial_shape(design, b * kvh, -(-rows // chunk), g, dh)
    part = None if shape is None else torch.empty(
        shape, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                out.data_ptr(), None if part is None else part.data_ptr(), b,
                s_cache, kvh, g, rows, chunk, float(scale), stream)
        if design == "tc":
            err = lib.decode_attention_tc_launch(dh, *args)
        else:
            err = lib.decode_attention_launch(_DTYPE_CODE[q.dtype], dh, *args)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(
            f"decode_attention launch failed (cuda error {err}: {msg}) at "
            f"q {tuple(q.shape)} cache {tuple(k_cache.shape)} pos={pos} "
            f"dtype={q.dtype} design={design}")
    decode_attention.launches += 1
    if design == "tc":
        decode_attention.launches_tc += 1
    else:
        decode_attention.launches_simt += 1
    return out


decode_attention.launches = 0
decode_attention.launches_tc = 0
decode_attention.launches_simt = 0
decode_attention.plain_calls = 0
