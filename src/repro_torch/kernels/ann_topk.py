"""Seri stage 1: fused exact cosine scores + top-k, as a CUDA kernel for
Hopper (``csrc/ann_topk.cu``) beside its plain PyTorch version.

Replaces ``repro/kernels/ann_topk.py::_ann_kernel``, the Pallas TPU kernel,
and the finalist merge after it. Same contract: ``emb`` (N, D) fp32 or
bf16, ``active`` (N,), ``q`` (B, D) of emb's type -> ``vals`` (B, k) fp32
and ``rows`` (B, k) int32. Products and sums in fp32, inactive rows score
``NEG``, order is value descending then row ascending on ties, and entries
with ``vals <= NEG / 2`` carry unspecified rows (callers drop them through
the τ_sim gate).

What bounds it on an H100: a scan must read the active mask (N bytes),
the active rows (D·4 bytes each) and the queries, and do 2·D·B fp32
operations per active row; the kernel reads every row, N·D·4 + N + B·D·4
bytes. At D = 768 the bytes bound it below B ≈ 40
(3.35 TB/s against 67 TFLOP/s of fp32 CUDA-core rate) and the operations
above; the engine's micro-batches sit well below. The simple design
streams each 512-row tile once per block of 1, 4 or 16 queries (the
smallest that holds B, see :func:`query_block`), with 16-byte loads and
the partial sums of 4 rows × the block's queries in registers, and keeps
one summation order for every row (no tensor cores: TF32 would break row
parity with the host path). ``csrc/ann_topk.cu`` has the details.

:func:`ann_topk` launches the kernel for CUDA tensors and raises if it
cannot; it takes :func:`ann_topk_plain` only for CPU tensors.
``ann_topk.launches`` and ``ann_topk.plain_calls`` count the two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

TILE_N = 512   # rows per CTA tile in csrc/ann_topk.cu
K_MAX = 64
NEG = -3.0e38  # the reference's inactive-row score
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
QUERY_BLOCKS = (1, 4, 16)  # queries per CTA the kernel is compiled for


def query_block(b: int) -> int:
    """Queries per CTA for a batch of ``b``: the smallest block that holds
    it, up to 16. Unused slots cost registers and shuffles; chip_smoke.py
    times each block at B = 1 and 4 against the block of 16."""
    return next((qb for qb in QUERY_BLOCKS if b <= qb), QUERY_BLOCKS[-1])


def ann_topk_plain(emb: torch.Tensor, active: torch.Tensor, q: torch.Tensor,
                   k: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: an fp32 matmul, the NEG mask
    and a stable sort of the negated scores (so ties keep the lowest row).
    Fewer than k rows are padded with NEG, as the reference pads its last
    tile."""
    n = emb.shape[0]
    s = q.float() @ emb.float().T                       # (B, N)
    s = torch.where(active.bool()[None, :], s, NEG)
    if n < k:
        s = torch.cat([s, s.new_full((s.shape[0], k - n), NEG)], dim=1)
    order = torch.sort(-s, dim=1, stable=True).indices[:, :k]
    return s.gather(1, order), order.to(torch.int32)


def _check(emb, active, q, k) -> None:
    if emb.ndim != 2 or q.ndim != 2 or active.ndim != 1:
        raise ValueError(f"want emb (N, D), active (N,), q (B, D); got "
                         f"{tuple(emb.shape)}, {tuple(active.shape)}, "
                         f"{tuple(q.shape)}")
    n, d = emb.shape
    if active.shape[0] != n or q.shape[1] != d or n < 1 or q.shape[0] < 1:
        raise ValueError(f"shape mismatch: emb {tuple(emb.shape)}, active "
                         f"{tuple(active.shape)}, q {tuple(q.shape)}")
    if emb.dtype not in _DTYPE_CODE or q.dtype != emb.dtype:
        raise TypeError(f"emb and q must both be float32 or bfloat16; got "
                        f"{emb.dtype}, {q.dtype}")
    if active.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"active must be bool or uint8, got {active.dtype}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in [1, {K_MAX}], got {k}")
    if not (emb.device == active.device == q.device):
        raise ValueError(f"tensors on different devices: {emb.device}, "
                         f"{active.device}, {q.device}")


def _lib():
    lib = build.load("ann_topk")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ann_topk_launch.argtypes = [i, i, p, p, p, i, i, i, i, p, p, p,
                                        p, p]
        lib.ann_topk_launch.restype = i
        lib.ann_topk_error_string.argtypes = [i]
        lib.ann_topk_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def ann_topk(emb: torch.Tensor, active: torch.Tensor, q: torch.Tensor,
             k: int = 4, *, qb: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k rows of ``emb`` by dot product with each query of ``q``.
    ``qb`` overrides :func:`query_block` on CUDA (for timing it)."""
    _check(emb, active, q, k)
    if qb is not None and qb not in QUERY_BLOCKS:
        raise ValueError(f"qb must be one of {QUERY_BLOCKS}, got {qb}")
    if emb.device.type == "cpu":
        ann_topk.plain_calls += 1
        return ann_topk_plain(emb, active, q, k)
    if emb.device.type != "cuda":
        raise ValueError(f"ann_topk runs on cuda or cpu, not {emb.device}")
    if not (emb.is_contiguous() and active.is_contiguous()
            and q.is_contiguous()):
        raise ValueError("ann_topk needs contiguous emb, active and q")
    n, d = emb.shape
    b = q.shape[0]
    qb = qb or query_block(b)
    ntiles = -(-n // TILE_N)
    dev = emb.device
    fv = torch.empty((b, ntiles, k), dtype=torch.float32, device=dev)
    fr = torch.empty((b, ntiles, k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    rows = torch.empty((b, k), dtype=torch.int32, device=dev)
    act = active.view(torch.uint8) if active.dtype == torch.bool else active
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ann_topk_launch(
            _DTYPE_CODE[emb.dtype], qb, emb.data_ptr(), act.data_ptr(),
            q.data_ptr(), n, d, b, k, fv.data_ptr(), fr.data_ptr(),
            vals.data_ptr(), rows.data_ptr(), stream)
    if err != 0:
        msg = lib.ann_topk_error_string(err).decode()
        raise RuntimeError(f"ann_topk launch failed (cuda error {err}: {msg}) "
                           f"at n={n} d={d} b={b} k={k} qb={qb} "
                           f"dtype={emb.dtype}")
    ann_topk.launches += 1
    return vals, rows


ann_topk.launches = 0
ann_topk.plain_calls = 0
