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
(3.35 TB/s against 1979 TOP/s of int8 tensor-core rate).

Two designs (``csrc/ann_topk_quant.cu`` has the details), chosen by
:func:`pick_design` from the alignment and D; both sum exact int32 dots
and rescale the same way, so their values are bitwise the same:

* ``"tc"``: rows on 16-byte boundaries with D % 32 == 0 (D = 128 and 768,
  every call of the warm tier). One launch on the int8 tensor cores
  (``mma.sync`` m16n8k32): rows on M, a block of 8 or 16 queries on N
  (:func:`tc_query_block`), row tiles sized by ``ann_topk.tile_plan`` in
  steps of 16 rows, row groups with no active row skipped, and the merge
  in the last CTA of each query block, as ``ann_topk``'s ``"fused"``.
* ``"dp4a"``: other widths and alignments: the first design, 512-row
  tiles summed with ``__dp4a`` on the CUDA cores, blocks of 1, 4 or 16
  queries, and a second launch that merges the finalists.

:func:`ann_topk_quant` launches a kernel for CUDA tensors and raises if
it cannot; it takes :func:`ann_topk_quant_plain` only for CPU tensors.
``ann_topk_quant.launches`` counts every launch, ``.launches_tc`` and
``.launches_dp4a`` each design's, and ``.plain_calls`` the plain
version's calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ann_topk import (K_MAX, NEG, QUERY_BLOCKS, TILE_N,
                                         query_block, scratch, sm_count,
                                         tickets, tile_plan)

TC_ROWS = 16            # rows of an m16 tile: the step of "tc"'s row tiles
TC_QUERY_BLOCKS = (8, 16)  # queries per CTA of "tc" (N of one or two m16n8)
DESIGNS = ("tc", "dp4a")


def pick_design(aligned: bool, d: int) -> str:
    """The design of a CUDA call: ``"tc"`` (int8 tensor cores) when
    ``emb_q``'s base lies on a 16-byte boundary and D % 32 == 0 (so every
    row does, and D is whole k-steps of 32 bytes), else ``"dp4a"``."""
    return "tc" if aligned and d % 32 == 0 else "dp4a"


def tc_query_block(b: int) -> int:
    """Queries per CTA of ``"tc"`` for a batch of ``b``: one n8 tile up to
    8 queries, two above."""
    return TC_QUERY_BLOCKS[0] if b <= TC_QUERY_BLOCKS[0] else TC_QUERY_BLOCKS[1]


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
        lib.ann_topk_quant_tc_launch.argtypes = [i, i, p, p, p, p, p, i, i,
                                                 i, i, p, p, p, p, p, p]
        lib.ann_topk_quant_tc_launch.restype = i
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
    of ``qq``. CUDA tensors take :func:`pick_design`'s kernel; ``qb``
    overrides its query block there (``TC_QUERY_BLOCKS`` for ``"tc"``,
    ``QUERY_BLOCKS`` for ``"dp4a"``)."""
    _check(emb_q, scales, active, qq, q_scales, k)
    if qb is not None and qb not in QUERY_BLOCKS + TC_QUERY_BLOCKS:
        raise ValueError(f"qb must be one of {QUERY_BLOCKS} or "
                         f"{TC_QUERY_BLOCKS}, got {qb}")
    if emb_q.device.type == "cpu":
        ann_topk_quant.plain_calls += 1
        return ann_topk_quant_plain(emb_q, scales, active, qq, q_scales, k)
    if emb_q.device.type != "cuda":
        raise ValueError(f"ann_topk_quant runs on cuda or cpu, not "
                         f"{emb_q.device}")
    if not all(t.is_contiguous() for t in (emb_q, scales, active, qq,
                                           q_scales)):
        raise ValueError("ann_topk_quant needs contiguous inputs")
    design = pick_design(emb_q.data_ptr() % 16 == 0, emb_q.shape[1])
    return _launch(design, emb_q, scales, active, qq, q_scales, k, qb)


def _launch(design: str, emb_q: torch.Tensor, scales: torch.Tensor,
            active: torch.Tensor, qq: torch.Tensor, q_scales: torch.Tensor,
            k: int, qb: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``design``'s kernel on checked CUDA inputs and count it
    (chip_smoke.py also calls it to hold and time ``"dp4a"`` on inputs the
    dispatch sends to ``"tc"``)."""
    n, d = emb_q.shape
    b = qq.shape[0]
    tc = design == "tc"
    blocks = TC_QUERY_BLOCKS if tc else QUERY_BLOCKS
    if qb is not None and qb not in blocks:
        raise ValueError(f"design {design!r} takes qb in {blocks}, got {qb}")
    qb = qb or (tc_query_block(b) if tc else query_block(b))
    dev = emb_q.device
    if tc:
        tile_n, ntiles, nqb = tile_plan(n, b, k, qb, sm_count(dev), TC_ROWS)
    else:
        ntiles = -(-n // TILE_N)
    buf = scratch(b, ntiles, k, dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    rows = torch.empty((b, k), dtype=torch.int32, device=dev)
    act = active.view(torch.uint8) if active.dtype == torch.bool else active
    lib = _lib()
    ptrs = (emb_q.data_ptr(), scales.data_ptr(), act.data_ptr(),
            qq.data_ptr(), q_scales.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tc:
            err = lib.ann_topk_quant_tc_launch(
                qb, tile_n, *ptrs, n, d, b, k, buf["fv"].data_ptr(),
                buf["fr"].data_ptr(), tickets(dev, nqb).data_ptr(),
                vals.data_ptr(),
                rows.data_ptr(), stream)
        else:
            err = lib.ann_topk_quant_launch(
                qb, *ptrs, n, d, b, k, buf["fv"].data_ptr(),
                buf["fr"].data_ptr(), vals.data_ptr(), rows.data_ptr(),
                stream)
    if err != 0:
        msg = lib.ann_topk_quant_error_string(err).decode()
        raise RuntimeError(f"ann_topk_quant launch failed (cuda error {err}: "
                           f"{msg}) at n={n} d={d} b={b} k={k} qb={qb} "
                           f"design={design}")
    ann_topk_quant.launches += 1
    setattr(ann_topk_quant, f"launches_{design}",
            getattr(ann_topk_quant, f"launches_{design}") + 1)
    return vals, rows


ann_topk_quant.launches = 0
ann_topk_quant.launches_tc = 0
ann_topk_quant.launches_dp4a = 0
ann_topk_quant.plain_calls = 0
