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

Three designs (``csrc/ann_topk_quant.cu`` has the details), chosen by
:func:`pick_design` from k, the alignment and D; all sum exact int32 dots
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
* ``"wide"``: k above ``K_MAX`` (the warm tier's 4k coarse candidates at
  ``top_k`` 17 or more): ``"dp4a"``'s tiles, each keeping its
  min(k, 512) best, and ``ann_topk``'s ``"wide"`` merge.

Each takes the largest query block whose shared memory fits ``SMEM_MAX``
(``ann_topk.fit_block``); where none does, the smallest block reads its
queries from device memory.

:func:`ann_topk_quant` launches a kernel for CUDA tensors and raises if
it cannot; it takes :func:`ann_topk_quant_plain` only for CPU tensors.
``ann_topk_quant.launches`` counts every call that launches,
``.launches_<design>`` each design's, and ``.plain_calls`` the plain
version's calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ann_topk import (K_MAX, MERGE_SMEM, NEG,
                                         QUERY_BLOCKS, SMEM_MAX, TILE_N,
                                         TILE_SMEM, _aligned, fit_block,
                                         query_block, scratch, sm_count,
                                         tickets, tile_plan, wide_scratch)

TC_ROWS = 16            # rows of an m16 tile: the step of "tc"'s row tiles
TC_QUERY_BLOCKS = (8, 16)  # queries per CTA of "tc" (N of one or two m16n8)
DESIGNS = ("tc", "dp4a", "wide")


def pick_design(aligned: bool, d: int, k: int = 1) -> str:
    """The design of a CUDA call: ``"wide"`` for k above ``K_MAX``, else
    ``"tc"`` (int8 tensor cores) when ``emb_q``'s base lies on a 16-byte
    boundary and D % 32 == 0 (so every row does, and D is whole k-steps
    of 32 bytes), else ``"dp4a"``."""
    if k > K_MAX:
        return "wide"
    return "tc" if aligned and d % 32 == 0 else "dp4a"


def tc_qstride(d: int) -> int:
    """Bytes of a query row in "tc"'s shared query block
    (``csrc/ann_topk_quant.cu::tc_qstride``)."""
    return d + 16 * ((4 - d // 16) & 7)


def tc_smem(qb: int, d: int, tile_n: int, qglobal: bool) -> int:
    """Bytes of dynamic shared memory of a "tc" CTA
    (``csrc/ann_topk_quant.cu::launch_tc``)."""
    body = qb * tile_n * 4 + (0 if qglobal else qb * tc_qstride(d)) + tile_n
    return -(-max(body, MERGE_SMEM) // 16) * 16 + TILE_SMEM


def tiles_smem(qb: int, d: int, qglobal: bool) -> int:
    """Bytes of dynamic shared memory of a "dp4a" or "wide" tile CTA."""
    return qb * (TILE_N * 4 + (0 if qglobal else d))


def plan(design: str, n: int, d: int, b: int, k: int, sms: int,
         qb: int | None = None) -> dict:
    """How ``design`` cuts a call, as ``ann_topk.plan`` does: ``qb``,
    ``qglobal``, ``nqb``, ``tile_n``, ``ntiles``, ``kt`` and the CTA's
    shared memory."""
    if design == "tc":
        blocks = TC_QUERY_BLOCKS

        def smem_of(x, g):
            return tc_smem(x, d, tile_plan(n, b, k, x, sms, TC_ROWS)[0], g)
    else:
        blocks = QUERY_BLOCKS

        def smem_of(x, g):
            return tiles_smem(x, d, g)
    if qb is None:
        qb, qglobal = fit_block(b, smem_of, blocks)
    else:
        qglobal = smem_of(qb, False) > SMEM_MAX
    if design == "tc":
        tile_n, ntiles, nqb = tile_plan(n, b, k, qb, sms, TC_ROWS)
    else:
        tile_n, ntiles, nqb = TILE_N, -(-n // TILE_N), -(-b // qb)
    return {"qb": qb, "qglobal": qglobal, "nqb": nqb, "tile_n": tile_n,
            "ntiles": ntiles, "kt": min(k, TILE_N),
            "smem": smem_of(qb, qglobal)}


def tc_query_block(b: int) -> int:
    """Queries per CTA of ``"tc"`` for a batch of ``b`` where shared memory
    allows: one n8 tile up to 8 queries, two above."""
    return query_block(b, TC_QUERY_BLOCKS)


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
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    devices = {t.device for t in (emb_q, scales, active, qq, q_scales)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")


def _lib():
    lib = build.load("ann_topk_quant")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ann_topk_quant_launch.argtypes = [i, i, p, p, p, p, p, i, i, i,
                                              i, p, p, p, p, p]
        lib.ann_topk_quant_launch.restype = i
        lib.ann_topk_quant_tc_launch.argtypes = [i, i, i, p, p, p, p, p, i,
                                                 i, i, i, p, p, p, p, p, p]
        lib.ann_topk_quant_tc_launch.restype = i
        lib.ann_topk_quant_wide_launch.argtypes = [i, i, p, p, p, p, p, i, i,
                                                   i, i, p, p, p, p, p, p, p]
        lib.ann_topk_quant_wide_launch.restype = i
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
    ``QUERY_BLOCKS`` for the others)."""
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
    design = pick_design(emb_q.data_ptr() % 16 == 0, emb_q.shape[1], k)
    return _launch(design, emb_q, scales, active, qq, q_scales, k, qb)


def _launch(design: str, emb_q: torch.Tensor, scales: torch.Tensor,
            active: torch.Tensor, qq: torch.Tensor, q_scales: torch.Tensor,
            k: int, qb: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``design``'s kernel on checked CUDA inputs and count it
    (chip_smoke.py also calls it to hold and time ``"dp4a"`` on inputs the
    dispatch sends to ``"tc"``)."""
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design!r}")
    if design != "wide" and k > K_MAX:
        raise ValueError(f"design {design!r} takes k up to {K_MAX}, got {k}")
    n, d = emb_q.shape
    b = qq.shape[0]
    tc = design == "tc"
    blocks = TC_QUERY_BLOCKS if tc else QUERY_BLOCKS
    if qb is not None and qb not in blocks:
        raise ValueError(f"design {design!r} takes qb in {blocks}, got {qb}")
    dev = emb_q.device
    cut = plan(design, n, d, b, k, sm_count(dev), qb)
    qb, ntiles, qglobal = cut["qb"], cut["ntiles"], cut["qglobal"]
    if qglobal:
        qq = _aligned(qq)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    rows = torch.empty((b, k), dtype=torch.int32, device=dev)
    act = active.view(torch.uint8) if active.dtype == torch.bool else active
    lib = _lib()
    ptrs = (emb_q.data_ptr(), scales.data_ptr(), act.data_ptr(),
            qq.data_ptr(), q_scales.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if design == "wide":
            size = wide_scratch(b, ntiles, cut["kt"], k)
            fv, gv = torch.empty((2, size), dtype=torch.float32, device=dev)
            fr, gr = torch.empty((2, size), dtype=torch.int32, device=dev)
            err = lib.ann_topk_quant_wide_launch(
                qb, int(qglobal), *ptrs, n, d, b, k, fv.data_ptr(),
                fr.data_ptr(), gv.data_ptr(), gr.data_ptr(), vals.data_ptr(),
                rows.data_ptr(), stream)
        elif tc:
            buf = scratch(b, ntiles, k, dev)
            err = lib.ann_topk_quant_tc_launch(
                qb, cut["tile_n"], int(qglobal), *ptrs, n, d, b, k,
                buf["fv"].data_ptr(), buf["fr"].data_ptr(),
                tickets(dev, cut["nqb"]).data_ptr(), vals.data_ptr(),
                rows.data_ptr(), stream)
        else:
            buf = scratch(b, ntiles, k, dev)
            err = lib.ann_topk_quant_launch(
                qb, int(qglobal), *ptrs, n, d, b, k, buf["fv"].data_ptr(),
                buf["fr"].data_ptr(), vals.data_ptr(), rows.data_ptr(),
                stream)
    if err != 0:
        msg = lib.ann_topk_quant_error_string(err).decode()
        raise RuntimeError(f"ann_topk_quant launch failed (cuda error {err}: "
                           f"{msg}) at n={n} d={d} b={b} k={k} qb={qb} "
                           f"qglobal={qglobal} design={design}")
    ann_topk_quant.launches += 1
    setattr(ann_topk_quant, f"launches_{design}",
            getattr(ann_topk_quant, f"launches_{design}") + 1)
    return vals, rows


ann_topk_quant.launches = 0
ann_topk_quant.launches_tc = 0
ann_topk_quant.launches_dp4a = 0
ann_topk_quant.launches_wide = 0
ann_topk_quant.plain_calls = 0
