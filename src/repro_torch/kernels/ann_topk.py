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
operations per active row. At D = 768 the bytes bound it below B ≈ 40
(3.35 TB/s against 67 TFLOP/s of fp32 CUDA-core rate) and the operations
above. At the engine's shapes (8192 × 128 rows at B = 1, routing over 64
or 512 centroids) a call is microseconds of work, and launches and CTA
count decide its time. Every design keeps ``csrc/dot.cuh``'s one
summation order, so a row scores bitwise the same here and in the routed
scan, and no tensor cores (TF32 would break row parity with the host
path).

Three designs (``csrc/ann_topk.cu`` has the details), chosen by
:func:`pick_design` from k, the dtype, the alignment and D:

* ``"fused"``: fp32 rows on 16-byte boundaries with D % 4 == 0, every
  call of the engine and of the routing. One launch: :func:`tile_plan`
  sizes the row tiles from N, B and the SM count so that the scan fills
  the card; each warp scores :func:`fused_rows` rows × the query block at
  once, skips row groups with no active row and combines the lanes' sums
  scattered over the lanes; the CTA that finishes its query block last
  (an atomic ticket, :func:`tickets`) merges the tiles' finalists.
* ``"twopass"``: bf16, and fp32 rows off a 16-byte boundary or with
  D % 4 != 0: the first design, 512-row tiles and a second launch that
  merges the finalists.
* ``"wide"``: k above ``K_MAX`` (the sorting networks' limit), any dtype
  (the warm tier's 4k coarse candidates, routing at nprobe above 64).
  ``"twopass"``'s tiles, each writing its min(k, 512) best in order,
  then :func:`merge_levels`: launches that merge the lists two by two by
  merge path, a thread an output entry, until one list of k is left.
  Its rows, those of NEG entries included, are the plain version's.

Each takes a block of 1, 4 or 16 queries per CTA: the smallest that holds
B (:func:`query_block`) where its shared memory fits ``SMEM_MAX``, else
the largest smaller block that fits; where not even a block of 1 fits (D
above about 55,000), a block of 1 that reads its query from device memory
(:func:`fit_block`). Every block sums each row in the same order, so the
block changes no score.

:func:`ann_topk` launches a kernel for CUDA tensors and raises if it
cannot; it takes :func:`ann_topk_plain` only for CPU tensors.
``ann_topk.launches`` counts every call that launches, ``.launches_<design>``
each design's, and ``.plain_calls`` the plain version's calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

TILE_N = 512   # rows per CTA tile of "twopass", and the most "fused" takes
CTAS_PER_SM = 2  # what tile_plan aims for
K_MAX = 64     # the largest k of "fused" and "twopass" (sorting networks)
NEG = -3.0e38  # the reference's inactive-row score
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
QUERY_BLOCKS = (1, 4, 16)  # queries per CTA the kernel is compiled for
DESIGNS = ("fused", "twopass", "wide")
SMEM_MAX = 232448  # H100: shared memory a CTA can take
# select.cuh's buffers beside a one-launch tile (THREADS = 256, 8 warps):
# the threshold pass's TILE_CAP = 64 pairs a warp and the last CTA's
# MERGE_CAP = 512 pairs a warp
TILE_SMEM = 8 * 64 * 8
MERGE_SMEM = 8 * 512 * 8


def query_block(b: int, blocks: tuple = QUERY_BLOCKS) -> int:
    """Queries per CTA for a batch of ``b`` where shared memory allows
    (:func:`fit_block`): the smallest of ``blocks`` that holds it, else
    the largest. Unused slots cost registers and shuffles; chip_smoke.py
    times each block at B = 1 and 4 against the block of 16."""
    return next((qb for qb in blocks if b <= qb), blocks[-1])


def fit_block(b: int, smem_of, blocks: tuple = QUERY_BLOCKS
              ) -> tuple[int, bool]:
    """``(qb, qglobal)`` of a call: the block :func:`query_block` gives
    where ``smem_of(qb, False)`` bytes of shared memory fit ``SMEM_MAX``,
    else the largest smaller block of ``blocks`` that fits; where none
    does, the smallest block, reading its queries from device memory
    (``qglobal``) instead of shared memory."""
    top = query_block(b, blocks)
    for qb in reversed(blocks):
        if qb <= top and smem_of(qb, False) <= SMEM_MAX:
            return qb, False
    return blocks[0], True


def fused_smem(qb: int, d: int, tile_n: int, qglobal: bool) -> int:
    """Bytes of dynamic shared memory of a "fused" CTA
    (``csrc/ann_topk.cu::launch_fused``): the query block unless it is
    read from device memory, the tile's scores and active bytes (or the
    last CTA's merge buffers, if larger), then the threshold pass's."""
    body = (0 if qglobal else qb * d * 4) + qb * tile_n * 4 + tile_n
    return -(-max(body, MERGE_SMEM) // 16) * 16 + TILE_SMEM


def tiles_smem(qb: int, d: int, qglobal: bool) -> int:
    """Bytes of dynamic shared memory of a "twopass" or "wide" tile CTA
    (``csrc/ann_topk.cu::launch_tiles``): the fp32 query block unless it
    is read from device memory, and the 512-row tile's scores."""
    return qb * TILE_N * 4 + (0 if qglobal else qb * d * 4)


def pick_design(dtype: torch.dtype, aligned: bool, d: int,
                k: int = 1) -> str:
    """The design of a CUDA call: ``"wide"`` for k above ``K_MAX``, else
    ``"fused"`` for fp32 rows that start on 16-byte boundaries
    (``aligned``: emb's base on one, and D % 4 == 0 so every row is), else
    ``"twopass"``."""
    if k > K_MAX:
        return "wide"
    if dtype == torch.float32 and aligned and d % 4 == 0:
        return "fused"
    return "twopass"


def merge_levels(ntiles: int, kt: int, k: int) -> list[tuple[int, int]]:
    """``(lists, length)`` a query of each level of "wide"'s merge
    (``csrc/select.cuh::merge_pairs``): level 0 the tiles' lists of ``kt``
    (= min(k, 512)), each next level lists 2i and 2i + 1 of the one before
    merged and cut to k, the last level one list of k, the result. A
    level's lists lie one after another, a query's after the other's."""
    levels = [(ntiles, kt)]
    while len(levels) == 1 or levels[-1][0] > 1:
        cnt, ln = levels[-1]
        nxt = -(-cnt // 2)
        levels.append((nxt, k if nxt == 1 else min(k, 2 * ln)))
    return levels


def wide_scratch(b: int, ntiles: int, kt: int, k: int) -> int:
    """Entries of each of "wide"'s two scratch buffers: levels 0, 2, ...
    in the first, 1, 3, ... in the second, the last level in the
    results."""
    return b * max(c * ln for c, ln in merge_levels(ntiles, kt, k)[:-1])


def fused_rows(qb: int) -> int:
    """Rows a warp of "fused" scores at once for a block of ``qb``
    queries, the step of its tiles (``csrc/ann_topk.cu::fused_rows``): 8,
    so one shared-memory read of a query feeds 8 FMAs; 4 for a block of
    16, where 8 x 16 sums take 254 registers and leave one CTA per SM,
    which was slower at B = 16 and 64 on an H100 (PERF.md)."""
    return 4 if qb == 16 else 8


def tile_plan(n: int, b: int, k: int, qb: int, sms: int, step: int,
              tile_max: int = TILE_N
              ) -> tuple[int, int, int]:
    """``(tile_n, ntiles, nqb)`` of a one-launch scan: ``nqb`` query blocks
    of ``qb``, and row tiles of ``tile_n`` rows, the largest multiple of
    ``step`` in [k, tile_max] that still gives ``CTAS_PER_SM`` CTAs per SM
    over the ``ntiles * nqb`` (tile, query block) pairs; the smallest
    tile, rounded up to k, where N is too small for that."""
    nqb = -(-b // qb)
    want = -(-CTAS_PER_SM * sms // nqb)          # tiles wanted
    lo = -(-k // step) * step
    tile_n = min(max(n // want // step * step, lo), tile_max)
    return tile_n, -(-n // tile_n), nqb


def scratch_shapes(b: int, ntiles: int, k: int) -> dict:
    """The scratch a call allocates beside its (b, k) results, name ->
    (shape, dtype): every tile's k finalists; a one-launch design also
    takes ``nqb`` of the shared :func:`tickets`."""
    return {"fv": ((b, ntiles, k), torch.float32),
            "fr": ((b, ntiles, k), torch.int32)}


def scratch(b: int, ntiles: int, k: int, dev: torch.device) -> dict:
    """:func:`scratch_shapes`' tensors, uninitialised, on ``dev``."""
    return {name: torch.empty(shape, dtype=dt, device=dev)
            for name, (shape, dt) in scratch_shapes(b, ntiles, k).items()}


_tickets: dict[torch.device, torch.Tensor] = {}


def tickets(dev: torch.device, count: int) -> torch.Tensor:
    """``count`` int32 tickets of the one-launch designs, one per query
    block, all 0: a buffer kept per device and grown (zeroed) when a call
    needs more. Each launch leaves the tickets it took at 0 again (the
    last CTA of a block resets its own), so launches on one stream share
    it; launches in flight on two streams at once must not."""
    buf = _tickets.get(dev)
    if buf is None or buf.numel() < count:
        size = max(count, 2 * (0 if buf is None else buf.numel()), 64)
        buf = _tickets[dev] = torch.zeros(size, dtype=torch.int32,
                                          device=dev)
    return buf


_sms: dict[torch.device, int] = {}


def sm_count(dev: torch.device) -> int:
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sms[dev]


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
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if not (emb.device == active.device == q.device):
        raise ValueError(f"tensors on different devices: {emb.device}, "
                         f"{active.device}, {q.device}")


def _lib():
    lib = build.load("ann_topk")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ann_topk_launch.argtypes = [i, i, p, p, p, p, i, i, i, i, p, p,
                                        p, p, p]
        lib.ann_topk_launch.restype = i
        lib.ann_topk_fused_launch.argtypes = [i, i, i, p, p, p, i, i, i, i,
                                              p, p, p, p, p, p]
        lib.ann_topk_fused_launch.restype = i
        lib.ann_topk_wide_launch.argtypes = [i, i, p, p, p, p, i, i, i, i, p,
                                             p, p, p, p, p, p]
        lib.ann_topk_wide_launch.restype = i
        lib.ann_topk_error_string.argtypes = [i]
        lib.ann_topk_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def ann_topk(emb: torch.Tensor, active: torch.Tensor, q: torch.Tensor,
             k: int = 4, *, qb: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k rows of ``emb`` by dot product with each query of ``q``.
    CUDA tensors take :func:`pick_design`'s kernel; ``qb`` overrides
    :func:`query_block` there (for timing it)."""
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
    design = pick_design(emb.dtype, emb.data_ptr() % 16 == 0, emb.shape[1],
                         k)
    return _launch(design, emb, active, q, k, qb)


def plan(design: str, n: int, d: int, b: int, k: int, sms: int,
         qb: int | None = None) -> dict:
    """How ``design`` cuts a call: the query block ``qb`` (:func:`fit_block`
    unless given), ``qglobal``, ``nqb`` blocks, ``tile_n``-row tiles
    (:func:`tile_plan` for "fused", 512 rows else), ``ntiles``, the
    finalists a tile keeps (``kt``) and the CTA's shared memory."""
    if design == "fused":
        def smem_of(x, g):
            return fused_smem(x, d, tile_plan(n, b, k, x, sms,
                                              fused_rows(x))[0], g)
    else:
        def smem_of(x, g):
            return tiles_smem(x, d, g)
    if qb is None:
        qb, qglobal = fit_block(b, smem_of)
    else:
        qglobal = smem_of(qb, False) > SMEM_MAX
    if design == "fused":
        tile_n, ntiles, nqb = tile_plan(n, b, k, qb, sms, fused_rows(qb))
    else:
        tile_n, ntiles, nqb = TILE_N, -(-n // TILE_N), -(-b // qb)
    return {"qb": qb, "qglobal": qglobal, "nqb": nqb, "tile_n": tile_n,
            "ntiles": ntiles, "kt": min(k, TILE_N),
            "smem": smem_of(qb, qglobal)}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy on a 16-byte boundary: a kernel reading its
    queries from device memory reads them 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(design: str, emb: torch.Tensor, active: torch.Tensor,
            q: torch.Tensor, k: int, qb: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``design``'s kernel on checked CUDA inputs and count it
    (chip_smoke.py also calls it to hold and time "twopass" on inputs the
    dispatch sends to "fused")."""
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design!r}")
    if design != "wide" and k > K_MAX:
        raise ValueError(f"design {design!r} takes k up to {K_MAX}, got {k}")
    n, d = emb.shape
    b = q.shape[0]
    dev = emb.device
    cut = plan(design, n, d, b, k, sm_count(dev), qb)
    qb, ntiles = cut["qb"], cut["ntiles"]
    # a query block read from device memory is read as fp32 16 bytes at a
    # time, so it must be fp32 on a 16-byte boundary
    qf = _aligned(q.float()) if cut["qglobal"] else None
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    rows = torch.empty((b, k), dtype=torch.int32, device=dev)
    act = active.view(torch.uint8) if active.dtype == torch.bool else active
    qfp = 0 if qf is None else qf.data_ptr()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if design == "fused":
            buf = scratch(b, ntiles, k, dev)
            qp = q.data_ptr() if qf is None else qfp
            err = lib.ann_topk_fused_launch(
                qb, cut["tile_n"], int(cut["qglobal"]), emb.data_ptr(),
                act.data_ptr(), qp, n, d, b, k, buf["fv"].data_ptr(),
                buf["fr"].data_ptr(), tickets(dev, cut["nqb"]).data_ptr(),
                vals.data_ptr(), rows.data_ptr(), stream)
        elif design == "twopass":
            buf = scratch(b, ntiles, k, dev)
            err = lib.ann_topk_launch(
                _DTYPE_CODE[emb.dtype], qb, emb.data_ptr(), act.data_ptr(),
                q.data_ptr(), qfp, n, d, b, k, buf["fv"].data_ptr(),
                buf["fr"].data_ptr(), vals.data_ptr(), rows.data_ptr(),
                stream)
        else:
            size = wide_scratch(b, ntiles, cut["kt"], k)
            fv, gv = torch.empty((2, size), dtype=torch.float32, device=dev)
            fr, gr = torch.empty((2, size), dtype=torch.int32, device=dev)
            err = lib.ann_topk_wide_launch(
                _DTYPE_CODE[emb.dtype], qb, emb.data_ptr(), act.data_ptr(),
                q.data_ptr(), qfp, n, d, b, k, fv.data_ptr(), fr.data_ptr(),
                gv.data_ptr(), gr.data_ptr(), vals.data_ptr(),
                rows.data_ptr(), stream)
    if err != 0:
        msg = lib.ann_topk_error_string(err).decode()
        raise RuntimeError(f"ann_topk launch failed (cuda error {err}: {msg}) "
                           f"at n={n} d={d} b={b} k={k} qb={qb} "
                           f"qglobal={cut['qglobal']} dtype={emb.dtype} "
                           f"design={design}")
    ann_topk.launches += 1
    setattr(ann_topk, f"launches_{design}",
            getattr(ann_topk, f"launches_{design}") + 1)
    return vals, rows


ann_topk.launches = 0
ann_topk.launches_fused = 0
ann_topk.launches_twopass = 0
ann_topk.launches_wide = 0
ann_topk.plain_calls = 0
