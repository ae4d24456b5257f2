"""Decode attention: one new query token per (batch, KV head) against a KV
cache (every decode step of the continuous batcher), as a CUDA kernel for
Hopper (``csrc/decode_attention.cu``) beside its plain PyTorch version.

Replaces ``repro/kernels/decode_attention.py::_decode_kernel``, the Pallas
TPU kernel, with its contract: ``q`` (B, KV, G, Dh), ``k_cache``/``v_cache``
(B, S, KV, Dh), fp32 or bf16, and a host integer ``pos`` -> (B, KV, G, Dh)
in q's dtype: the G query rows of each KV head attend over cache rows
``0..pos`` (the caller has written the new token's K/V at ``pos``), with
an fp32 softmax.

What bounds it on an H100: the bytes of cache rows 0..pos of K and V (the
Pallas kernel streams the whole cache; this kernel reads only those rows).
For one batch row of the agent (KV 4, Dh 128, bf16) at pos = 32767 that is
67 MB per layer, about 20 µs.

The design (``csrc/decode_attention.cu``): split-S (flash-decoding) at
every length, because (b, KV head) pairs alone would leave most of the 132
SMs idle (4 CTAs for one agent row). :func:`split_rows` picks the chunk of
cache rows per CTA so that about two CTAs per SM are in flight; a second
pass combines the chunks' partial (max, denominator, accumulator). At the
batcher's ``max_len`` of 128 a row of the batch is one or two chunks.

:func:`decode_attention` launches the kernel for CUDA tensors and raises
if it cannot; it takes :func:`decode_attention_plain` only for CPU tensors.
``decode_attention.launches`` and ``.plain_calls`` count the two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG = -1.0e30
HEAD_DIMS = (16, 32, 64, 128)
G_MAX = 16
TILE = 64          # cache rows per shared-memory tile; chunks are multiples
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def split_rows(rows: int, heads: int, sms: int) -> int:
    """Cache rows per CTA for ``rows`` rows over ``heads`` (b, KV head)
    pairs: enough chunks for about two CTAs per SM, each a multiple of the
    64-row tile."""
    want = max(1, -(-2 * sms // heads))
    chunk = -(-rows // want)
    return max(TILE, -(-chunk // TILE) * TILE)


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
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     scale: float) -> torch.Tensor:
    """Attention of one token's G query rows per KV head over cache rows
    ``0..pos`` (all rows when ``pos >= S``)."""
    _check(q, k_cache, v_cache, pos)
    if q.device.type == "cpu":
        decode_attention.plain_calls += 1
        return decode_attention_plain(q, k_cache, v_cache, pos, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    b, kvh, g, dh = q.shape
    s_cache = k_cache.shape[1]
    if dh not in HEAD_DIMS or g > G_MAX:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS} or G={g} above "
                         f"{G_MAX}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("decode_attention needs contiguous q and caches")
    rows = min(pos, s_cache - 1) + 1
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk = split_rows(rows, b * kvh, sms)
    nsplit = -(-rows // chunk)
    part = torch.empty((b * kvh, nsplit, g, dh + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            _DTYPE_CODE[q.dtype], dh, q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), out.data_ptr(), part.data_ptr(), b, s_cache,
            kvh, g, rows, chunk, float(scale), stream)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(
            f"decode_attention launch failed (cuda error {err}: {msg}) at "
            f"q {tuple(q.shape)} cache {tuple(k_cache.shape)} pos={pos} "
            f"dtype={q.dtype}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.plain_calls = 0
