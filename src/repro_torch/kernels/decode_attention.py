"""Decode attention: one new query token per (batch, KV head) against a KV
cache (every decode step of the continuous batcher), as CUDA kernels for
Hopper (``csrc/decode_attention.cu``) beside its plain PyTorch version.

Replaces ``repro/kernels/decode_attention.py::_decode_kernel``, the Pallas
TPU kernel, with its contract: ``q`` (B, KV, G, Dh), ``k_cache``/``v_cache``
(B, S, KV, Dh), fp32 or bf16, and ``pos`` -> (B, KV, G, Dh) in q's dtype:
the G query rows of each KV head attend over cache rows ``0..pos`` (the
caller has written the new token's K/V at ``pos``), with an fp32 softmax.

``pos`` is a host int, or a 0-d integer tensor on the caches' device: the
TPU kernel's ``pos_ref``, which the kernels read from device memory, so
that a captured CUDA graph of a decode step (``serving/generator.py``)
follows the position of each replay. The host then cannot plan by it: the
launch is planned for all S rows (the TPU kernel's grid is sized from the
cache length as well), and a chunk that starts past ``pos`` reads nothing
and is skipped by the combine pass. A host int plans for rows ``0..pos``
alone. For equal values both give the same result.

What bounds it on an H100: the bytes of cache rows 0..pos of K and V (the
Pallas kernel streams the whole cache; these kernels read only those rows).
For one batch row of the agent (KV 4, Dh 128, bf16) at pos = 32767 that is
67 MB per layer, about 20 µs.

Both designs split the rows (split-S, flash-decoding), because (b, KV
head) pairs alone would leave most of the 132 SMs idle (4 CTAs for one
agent row): :func:`split_rows` picks the chunk of cache rows per CTA so
that the CTAs fill the card in one wave, and one chunk when the cache is
short. A KV head's G query rows go in G-tiles of :data:`G_TILE` (a CTA
per (b, KV head, chunk, G-tile); multi-query models have G 48 or 71), so
any G runs, and :func:`split_rows` counts those CTAs. :func:`pick_design`
chooses the design from the dtype, the alignment and the head dim
(``csrc/decode_attention.cu`` has the details; any Dh from 1 to
``flash_attention.DH_MAX``, as kernel 6):

* ``"tc"``: bf16 caches on 16-byte boundaries, Dh a multiple of 8 up to
  256, which is every decode step of the LM path. A G-tile's query rows
  are one ``mma.sync`` tile (padded to 16); each of a CTA's 4 warps
  streams its own 16-row tiles through a 3-stage bf16 ring filled by
  ``cp.async`` and keeps its own (m, l, acc); the warps merge once at the
  end. With one chunk (the batcher's ``max_len`` of 128) that is the only
  launch and no scratch is allocated; with more, a combine pass merges the
  chunks' partials. One instance a width of
  ``flash_attention.tc_width``'s 12, a head without its own zero-padded.
* ``"simt"``: fp32 (its 3e-5 check rules out bf16 products) and caches
  off a 16-byte boundary, at the widths of :data:`HEAD_DIMS`: 64-row
  tiles staged as fp32, fp32 FMAs on the CUDA cores, always a partial
  pass and a combine pass.
* ``"simt_any"``: the same at every other width, Dh a runtime argument,
  the accumulator in shared memory and the tiles sized at launch.

:func:`decode_attention` launches the kernels for CUDA tensors and raises
if it cannot; it takes :func:`decode_attention_plain` only for CPU tensors.
With ``return_lse=True`` it also returns each query row's log-sum-exp
(B, KV, G) fp32, ``m + log(max(l, 1e-30))``: with it a caller merges
outputs over disjoint row ranges of one cache (a cache whose rows are
split across ranks: ``nn/attention.decode_attend``). Both designs write
it; without it nothing changes. The wrapper's body is the op
``torch.ops.repro_torch.decode_attention`` (``decode_attention_at`` for a
tensor ``pos``), so that the device picks the version (CPU: plain, CUDA:
the kernels), a ``meta`` or fake tensor gets the outputs' shapes alone
(the dry run), and ``torch.utils.flop_counter`` counts its products over
rows ``0..pos`` (all S rows for a tensor ``pos``).
``decode_attention.launches`` counts every call that launched,
``.launches_tc``, ``.launches_simt`` and ``.launches_simt_any`` each
design's, and ``.plain_calls`` the plain version's calls. A call captured into a CUDA graph by
``kernels/graphs.StepGraph`` counts at each replay, not at its capture.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention

NEG = -1.0e30
HEAD_DIMS = (16, 32, 64, 128, 256)   # "simt"'s instances; not kernel 6's
                                     # 192: MLA decodes over its latent
G_TILE = 16        # query rows of a KV head per CTA (one mma.sync tile)
TILE = 64          # chunks are multiples of 64 cache rows (one simt tile,
                   # one 16-row tile for each of a tc CTA's 4 warps)
MIN_CHUNK = 256    # no split below 4 tiles per tc warp
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def pick_design(dtype: torch.dtype, aligned: bool, dh: int) -> str:
    """Kernel 6's dispatch rule (``flash_attention.design_for``) with this
    kernel's CUDA-core instances."""
    return flash_attention.design_for(dtype, aligned, dh, HEAD_DIMS)


def g_tiles(g: int) -> int:
    """CTAs a (b, KV head, chunk) takes: its G query rows in tiles of
    :data:`G_TILE`."""
    return -(-g // G_TILE)


def ctas_per_sm(dh: int) -> int:
    """CTAs of any design that share an SM at head dim ``dh``: two up to
    Dh 128, one above, where the tensor-core tiles of a wide head take
    the SM (every instance's shared memory is sized for this count,
    ``attention.cuh::ctas_per_sm_at``)."""
    flash_attention.check_head_dim(dh)
    return 1 if dh > 128 else 2


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: int | torch.Tensor,
                           scale: float, return_lse: bool = False):
    """Plain PyTorch version (the reference's ``decode_attention_ref``):
    the fp32 softmax over the whole cache with rows past ``pos`` (a host
    int, or a 0-d tensor, read as the kernels read it) masked; with
    ``return_lse`` also its rows' log-sum-exp (B, KV, G)."""
    s_cache = k_cache.shape[1]
    s = torch.einsum("bkgd,bskd->bkgs", flash_attention.wide(q),
                     flash_attention.wide(k_cache)) * scale
    if isinstance(pos, torch.Tensor):
        pos = pos.clamp_min(0)
    valid = torch.arange(s_cache, device=q.device) <= pos
    s = torch.where(valid, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p,
                       flash_attention.wide(v_cache)).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def split_rows(rows: int, heads: int, sms: int, ctas: int) -> int:
    """Cache rows per CTA for ``rows`` rows over ``heads`` (b, KV head,
    G-tile) triples (:func:`g_tiles`) on ``sms`` SMs: as many chunks per pair as fit the card in one
    wave of ``ctas`` CTAs per SM (:func:`ctas_per_sm`; a second,
    partial wave would double the time), each a multiple of TILE rows, and
    no chunk below MIN_CHUNK rows: a shorter one fills no warp's ring and
    costs the combine pass more than it saves, so a short cache (the
    batcher's 128 rows) is one chunk and one launch."""
    want = max(1, ctas * sms // heads)
    chunk = -(-rows // want)
    return max(MIN_CHUNK, -(-chunk // TILE) * TILE)


def rows_aligned(*xs: torch.Tensor) -> bool:
    """Every row of every head of each contiguous tensor starts on a
    16-byte boundary: the base pointer does and a head's Dh elements make
    whole 16-byte chunks (each row and head starts a multiple of Dh
    elements in; Dh 12 in bf16 or 3 in fp32 does not)."""
    return all(x.data_ptr() % 16 == 0 and
               x.shape[-1] * x.element_size() % 16 == 0 for x in xs)


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
    if not flash_attention.dtype_ok(q) or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise TypeError(f"q and the caches must all be float32 or bfloat16 "
                        f"(or float64 on the CPU); got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if isinstance(pos, torch.Tensor):
        if pos.ndim != 0 or pos.dtype not in (torch.int32, torch.int64) \
                or pos.device != q.device:
            raise ValueError(f"a tensor pos must be a 0-d int32 or int64 on "
                             f"{q.device}; got {tuple(pos.shape)} "
                             f"{pos.dtype} on {pos.device}")
    elif not isinstance(pos, int) or pos < 0:
        raise ValueError(f"pos must be a host int >= 0 or a 0-d device "
                         f"tensor, got {pos!r}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{k_cache.device}, {v_cache.device}")


def _lib():
    lib = build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        # q, k, v, o, lse (None: a null pointer, no lse written), scratch,
        # pos (None: the host's rows)
        lib.decode_attention_launch.argtypes = [
            i, i, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        lib.decode_attention_launch.restype = i
        lib.decode_attention_any_launch.argtypes = \
            lib.decode_attention_launch.argtypes
        lib.decode_attention_any_launch.restype = i
        lib.decode_attention_tc_launch.argtypes = [
            i, i, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        lib.decode_attention_tc_launch.restype = i
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int | torch.Tensor, *,
                     scale: float, return_lse: bool = False):
    """Attention of one token's G query rows per KV head over cache rows
    ``0..pos`` (all rows when ``pos >= S``); ``pos`` a host int, or a 0-d
    integer tensor on q's device that the kernels read there. CUDA
    tensors take :func:`pick_design`'s kernels. Inputs that require grad
    are refused while grad mode is on (``flash_attention.refuse_grad``).
    Returns ``out``, or ``(out, lse)`` with ``return_lse``."""
    _check(q, k_cache, v_cache, pos)
    flash_attention.refuse_grad("decode_attention", q, k_cache, v_cache)
    op = torch.ops.repro_torch.decode_attention_at \
        if isinstance(pos, torch.Tensor) else \
        torch.ops.repro_torch.decode_attention
    out, lse = op(q, k_cache, v_cache, pos, float(scale), return_lse)
    return (out, lse) if return_lse else out


def _on_cpu(q, k_cache, v_cache, pos, scale: float, return_lse: bool):
    decode_attention.plain_calls += 1
    return flash_attention._lse_or_none(decode_attention_plain(
        q, k_cache, v_cache, pos, scale, return_lse), return_lse)


def _on_cuda(q, k_cache, v_cache, pos, scale: float, return_lse: bool):
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("decode_attention needs contiguous q and caches")
    design = pick_design(q.dtype, rows_aligned(q, k_cache, v_cache),
                         q.shape[-1])
    return flash_attention._lse_or_none(_launch(
        design, q, k_cache, v_cache, pos, scale, return_lse), return_lse)


def _shapes_only(q, k_cache, v_cache, pos, scale: float, return_lse: bool):
    """The outputs of a call on ``meta`` or fake tensors, nothing run."""
    shape = q.shape[:3] if return_lse else (0,)
    return torch.empty_like(q), q.new_empty(shape, dtype=torch.float32)


_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("decode_attention(Tensor q, Tensor k_cache, Tensor v_cache, "
            "int pos, float scale, bool return_lse) -> (Tensor, Tensor)")
_OPS.impl("decode_attention", _on_cpu, "CPU")
_OPS.impl("decode_attention", _on_cuda, "CUDA")
torch.library.register_fake("repro_torch::decode_attention", _shapes_only,
                            lib=_OPS)
# the same with pos in device memory (a 0-d int32 or int64 tensor)
_OPS.define("decode_attention_at(Tensor q, Tensor k_cache, Tensor v_cache, "
            "Tensor pos, float scale, bool return_lse) -> (Tensor, Tensor)")
_OPS.impl("decode_attention_at", _on_cpu, "CPU")
_OPS.impl("decode_attention_at", _on_cuda, "CUDA")
torch.library.register_fake("repro_torch::decode_attention_at",
                            _shapes_only, lib=_OPS)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _flops(q_shape, k_shape, v_shape, pos: int, *args, **kwargs) -> int:
    """Its two products over rows ``0..pos``: 4 Dh per (query row,
    row)."""
    b, kvh, g, dh = q_shape
    return 4 * b * kvh * g * (min(pos, k_shape[1] - 1) + 1) * dh


@register_flop_formula(torch.ops.repro_torch.decode_attention_at)
def _flops_at(q_shape, k_shape, *args, **kwargs) -> int:
    """A device ``pos`` the host cannot read: the products over all S
    rows, the most the call can do."""
    b, kvh, g, dh = q_shape
    return 4 * b * kvh * g * k_shape[1] * dh


def _launch(design: str, q: torch.Tensor, k_cache: torch.Tensor,
            v_cache: torch.Tensor, pos: int | torch.Tensor, scale: float,
            return_lse: bool = False):
    """Launch ``design``'s kernels on checked CUDA inputs and count the
    call (chip_smoke.py also calls it to time the CUDA-core design on
    inputs the dispatch sends to the tensor cores). A tensor ``pos`` is
    passed by pointer and the launch planned for all S rows; a host int
    plans for rows ``0..pos``. Returns ``out``, or ``(out, lse)`` with
    ``return_lse``."""
    b, kvh, g, dh = q.shape
    s_cache = k_cache.shape[1]
    on_device = isinstance(pos, torch.Tensor)
    if on_device:
        pos = pos.to(torch.int32)
    rows = s_cache if on_device else min(pos, s_cache - 1) + 1
    chunk = split_rows(rows, b * kvh * g_tiles(g), _sm_count(q.device.index),
                       ctas_per_sm(dh))
    shape = partial_shape(design, b * kvh, -(-rows // chunk), g, dh)
    part = None if shape is None else torch.empty(
        shape, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, kvh, g), dtype=torch.float32,
                      device=q.device) if return_lse else None
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                out.data_ptr(), None if lse is None else lse.data_ptr(),
                None if part is None else part.data_ptr(),
                pos.data_ptr() if on_device else None, b, s_cache, kvh, g,
                rows, chunk, float(scale), stream)
        if design == "tc":
            err = lib.decode_attention_tc_launch(
                dh, flash_attention.tc_width(dh), *args)
        elif design == "simt":
            err = lib.decode_attention_launch(_DTYPE_CODE[q.dtype], dh, *args)
        else:
            err = lib.decode_attention_any_launch(_DTYPE_CODE[q.dtype], dh,
                                                  *args)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(
            f"decode_attention launch failed (cuda error {err}: {msg}) at "
            f"q {tuple(q.shape)} cache {tuple(k_cache.shape)} "
            f"pos={'on the device' if on_device else pos} "
            f"dtype={q.dtype} design={design}")
    flash_attention.count(decode_attention, design)
    return (out, lse) if return_lse else out


decode_attention.launches = 0
for _d in flash_attention.DESIGNS:
    setattr(decode_attention, f"launches_{_d}", 0)
decode_attention.plain_calls = 0
