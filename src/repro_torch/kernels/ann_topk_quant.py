"""The warm tier's coarse stage 1: exact int8 scores + top-k, as a CUDA
kernel for Hopper (``csrc/ann_topk_quant.cu``) beside its plain PyTorch
version.

Replaces ``repro/kernels/ann_topk_quant.py::_annq_kernel``, the Pallas TPU
kernel, and the finalist merge after it. Same contract: ``emb_q`` (N, D)
int8, ``scales`` (N,) fp32, ``active`` (N,), ``qq`` (B, D) int8 and
``q_scales`` (B,) fp32 -> ``vals`` (B, k) fp32 and ``rows`` (B, k) int32.
Each score is the exact int32 dot rescaled as ``float(i32) * row_scale``,
then ``* q_scale``, each product rounded to nearest; inactive rows score
``NEG``; order is value descending then row ascending on ties. The values
are the numpy path's coarse scores bit for bit, so the kernel and the host
agree on every row, ties included (int8 scores tie exactly far more often
than fp32 ones). Callers rescore the finalists in fp32.

What bounds it on an H100: a scan must read the active mask (N bytes),
each active row's D int8 values and scale, and the queries, and do 2·D·B
int8 operations per active row, so the bytes bound it up to B ≈ 300
(3.35 TB/s against 1979 TOP/s of int8 tensor-core rate). The kernel reads
every row: N·D + 5·N + B·D bytes. The simple design is
``ann_topk.cu``'s: 512-row tiles per CTA, the int8 query block in shared
memory, 16-byte row loads summed with ``__dp4a`` in int32 (exact in any
order), then per-tile argmax passes and a merge pass.

:func:`ann_topk_quant` launches the kernel for CUDA tensors and raises if
it cannot; it takes :func:`ann_topk_quant_plain` only for CPU tensors.
``ann_topk_quant.launches`` and ``ann_topk_quant.plain_calls`` count the
two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ann_topk import K_MAX, NEG, QUERY_BLOCKS, query_block

TILE_N = 512   # rows per CTA tile in csrc/ann_topk_quant.cu


def int8_scores(emb_q: torch.Tensor, scales: torch.Tensor,
                qq: torch.Tensor, q_scales: torch.Tensor) -> torch.Tensor:
    """(B, N) rescaled int8 scores, as the reference computes them. The
    int32 dot products go through float64, where every partial sum of int8
    products is an exact integer (|sum| <= D·127² < 2^53) and which CUDA
    can multiply (it has no integer matmul); the conversion to fp32 rounds
    to nearest as numpy's ``astype(np.float32)`` of the int32 does."""
    acc = (qq.double() @ emb_q.double().T).float()
    s = acc * scales.float()[None, :]
    return s * q_scales.float()[:, None]


def ann_topk_quant_plain(emb_q: torch.Tensor, scales: torch.Tensor,
                         active: torch.Tensor, qq: torch.Tensor,
                         q_scales: torch.Tensor, k: int = 16
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the rescaled int8 scores, the
    NEG mask and a stable sort of the negated scores (so ties keep the
    lowest row). Fewer than k rows are padded with NEG."""
    n = emb_q.shape[0]
    s = int8_scores(emb_q, scales, qq, q_scales)
    s = torch.where(active.bool()[None, :], s, NEG)
    if n < k:
        s = torch.cat([s, s.new_full((s.shape[0], k - n), NEG)], dim=1)
    order = torch.sort(-s, dim=1, stable=True).indices[:, :k]
    return s.gather(1, order), order.to(torch.int32)


def _check(emb_q, scales, active, qq, q_scales, k) -> None:
    if emb_q.ndim != 2 or qq.ndim != 2 or scales.ndim != 1 \
            or active.ndim != 1 or q_scales.ndim != 1:
        raise ValueError(
            f"want emb_q (N, D), scales (N,), active (N,), qq (B, D), "
            f"q_scales (B,); got {tuple(emb_q.shape)}, {tuple(scales.shape)}, "
            f"{tuple(active.shape)}, {tuple(qq.shape)}, "
            f"{tuple(q_scales.shape)}")
    n, d = emb_q.shape
    b = qq.shape[0]
    if scales.shape[0] != n or active.shape[0] != n or qq.shape[1] != d \
            or q_scales.shape[0] != b or n < 1 or b < 1:
        raise ValueError(f"shape mismatch: emb_q {tuple(emb_q.shape)}, "
                         f"scales {tuple(scales.shape)}, active "
                         f"{tuple(active.shape)}, qq {tuple(qq.shape)}, "
                         f"q_scales {tuple(q_scales.shape)}")
    if emb_q.dtype != torch.int8 or qq.dtype != torch.int8:
        raise TypeError(f"emb_q and qq must be int8; got {emb_q.dtype}, "
                        f"{qq.dtype}")
    if scales.dtype != torch.float32 or q_scales.dtype != torch.float32:
        raise TypeError(f"scales and q_scales must be float32; got "
                        f"{scales.dtype}, {q_scales.dtype}")
    if active.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"active must be bool or uint8, got {active.dtype}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in [1, {K_MAX}], got {k}")
    devices = {t.device for t in (emb_q, scales, active, qq, q_scales)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")


def _lib():
    lib = build.load("ann_topk_quant")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ann_topk_quant_launch.argtypes = [i, p, p, p, p, p, i, i, i, i,
                                              p, p, p, p, p]
        lib.ann_topk_quant_launch.restype = i
        lib.ann_topk_quant_error_string.argtypes = [i]
        lib.ann_topk_quant_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def ann_topk_quant(emb_q: torch.Tensor, scales: torch.Tensor,
                   active: torch.Tensor, qq: torch.Tensor,
                   q_scales: torch.Tensor, k: int = 16, *,
                   qb: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k rows of ``emb_q`` by rescaled int8 score against each query
    of ``qq``. ``qb`` overrides :func:`query_block` on CUDA."""
    _check(emb_q, scales, active, qq, q_scales, k)
    if qb is not None and qb not in QUERY_BLOCKS:
        raise ValueError(f"qb must be one of {QUERY_BLOCKS}, got {qb}")
    if emb_q.device.type == "cpu":
        ann_topk_quant.plain_calls += 1
        return ann_topk_quant_plain(emb_q, scales, active, qq, q_scales, k)
    if emb_q.device.type != "cuda":
        raise ValueError(f"ann_topk_quant runs on cuda or cpu, not "
                         f"{emb_q.device}")
    if not all(t.is_contiguous() for t in (emb_q, scales, active, qq,
                                           q_scales)):
        raise ValueError("ann_topk_quant needs contiguous inputs")
    n, d = emb_q.shape
    b = qq.shape[0]
    qb = qb or query_block(b)
    ntiles = -(-n // TILE_N)
    dev = emb_q.device
    fv = torch.empty((b, ntiles, k), dtype=torch.float32, device=dev)
    fr = torch.empty((b, ntiles, k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    rows = torch.empty((b, k), dtype=torch.int32, device=dev)
    act = active.view(torch.uint8) if active.dtype == torch.bool else active
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ann_topk_quant_launch(
            qb, emb_q.data_ptr(), scales.data_ptr(), act.data_ptr(),
            qq.data_ptr(), q_scales.data_ptr(), n, d, b, k, fv.data_ptr(),
            fr.data_ptr(), vals.data_ptr(), rows.data_ptr(), stream)
    if err != 0:
        msg = lib.ann_topk_quant_error_string(err).decode()
        raise RuntimeError(f"ann_topk_quant launch failed (cuda error {err}: "
                           f"{msg}) at n={n} d={d} b={b} k={k} qb={qb}")
    ann_topk_quant.launches += 1
    return vals, rows


ann_topk_quant.launches = 0
ann_topk_quant.plain_calls = 0
