"""Clustered (IVF) stage 1: the routed bucket scans, as CUDA kernels for
Hopper (``csrc/ann_topk_ivf.cu``) beside their plain PyTorch versions.

Replaces ``repro/kernels/ann_topk_ivf.py::_ivf_kernel`` (fp32, the hot
tier) and ``::_ivf_quant_kernel`` (int8, the warm tier's coarse scan), the
Pallas TPU kernels whose scalar-prefetch index maps read ``sel[b, j]`` to
DMA one cluster bucket per grid step. Same contract: ``sel``/``enabled``
(B, nprobe) int32, the (C, cap, D) cluster-major buckets and their
(C, cap) valid mask -> per-probe finalists ``vals``/``slots``
(B, nprobe, k). Probe (b, j) scores bucket ``sel[b, j]`` against query b;
invalid slots and disabled probes score ``NEG``; order is value
descending then slot ascending on ties (buckets hold their rows in
ascending order, so that is the lowest row). Where fewer than k slots
remain, or the probe is disabled, the missing finalists are ``NEG`` at
slots 0, 1, ... in the order a stable sort gives; callers drop them with
``vals > NEG / 2``. The fp32 scores use ``ann_topk.cu``'s summation order
(``csrc/dot.cuh``), so a row scores bitwise the same in the brute and the
routed scan; the int8 scores are the exact int32 dots rescaled as
``float(i32) * slot_scale``, then ``* q_scale``.

What bounds them on an H100: a scan must read, for each distinct probed
bucket, its cap-byte valid mask and its valid slots, D·4 (fp32) or D + 4
(int8 and the slot's scale) bytes each, and do 2·D operations per valid
slot of each enabled probe; at the sizes the router builds the bytes bound
them. The routed scans of this module and the shard-owned ones of
``ann_topk_sharded`` (kernels 3–5) share one dispatch, :func:`pick_design`
(``csrc/ann_topk_ivf.cu`` has the details):

* ``"warp"``: buckets of at most ``WARP_CAP`` = 64 slots (every bucket the
  engine lays out at its sizes). One warp per (query, probe),
  ``WARP_PROBES`` probes a CTA and no block barrier: the warp scores only
  the row groups that hold a valid slot, keeps two scores a lane, sorts
  them with one bitonic network and writes the probe's k finalists.
* ``"block"``: larger buckets (the real-size router's), and any k: one
  CTA of 256 threads per (query, probe) that reads its own
  ``sel``/``enabled`` entry (the TPU's scalar prefetch), scores every slot
  of the bucket into shared memory and runs k block-wide argmax passes.
* ``"chunked"``: buckets whose scores and query overflow shared memory
  (:func:`block_smem`; a cap above about 57,000 slots at D = 768): the
  CTA reads its query in place and scores the bucket in chunks of
  :func:`chunk_slots` slots, merging each chunk into a running list of
  the probe's k best kept in device memory.

All three give the same finalists bitwise, the slots of NEG entries
included. A shape a design cannot take fails at launch, with the shape and
the design in the error; there is no fall back to another design.

:func:`ann_topk_ivf` and :func:`ann_topk_ivf_quant` launch the kernels for
CUDA tensors and raise if they cannot; they take the plain versions only
for CPU tensors. Each counts ``launches``, each design's launches
(``launches_<design>``) and ``plain_calls``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ann_topk import K_MAX, NEG, _aligned
from repro_torch.kernels.ann_topk_quant import int8_scores


DESIGNS = ("warp", "block", "chunked")
_DESIGN_CODE = {"block": 0, "warp": 1, "chunked": 2}  # ::Design
WARP_CAP = 64      # the largest bucket "warp" takes: two slots a lane
WARP_PROBES = 4    # probes (warps) in a CTA of "warp"
SMEM_MAX = 232448  # H100: shared memory a CTA can take


def warp_smem(d: int, quant: bool, sharded: bool = True) -> int:
    """Bytes of shared memory a CTA of "warp" takes at width ``d``: each
    warp's query, 16-byte aligned, and for the sharded writer its
    finalists and slot rows (the unsharded writer stores its finalists
    from registers)."""
    query = -(-d * (1 if quant else 4) // 16) * 16
    return WARP_PROBES * (query + (K_MAX * 8 + WARP_CAP * 4 if sharded
                                   else 0))


def block_smem(cap: int, d: int, k: int, quant: bool,
               sharded: bool = True) -> int:
    """Bytes of shared memory a CTA of "block" takes
    (``csrc/ann_topk_ivf.cu::launch``): the cap scores, the query on a
    16-byte boundary, and for the sharded writer its k finalists and
    their slots after it, on another."""
    query = -(-cap * 4 // 16) * 16 + d * (1 if quant else 4)
    return -(-query // 16) * 16 + k * 8 if sharded else query


def chunk_slots(cap: int) -> int:
    """Slots a chunk of "chunked" scores into shared memory: as many
    multiples of 256 as fit ``SMEM_MAX`` (1 KB left for the CTA's own
    variables), or the whole bucket where it is smaller."""
    return min(cap, (SMEM_MAX - 1024) // 4 // 256 * 256)


def pick_design(cap: int, k: int, d: int, quant: bool,
                sharded: bool = True) -> str:
    """The design of a CUDA call of kernels 3–5: ``"warp"`` for buckets of
    at most ``WARP_CAP`` slots (any k up to ``K_MAX``: its network sorts
    max(cap, k) <= 64 entries) whose queries fit its shared memory, else
    ``"block"`` where the bucket's scores and the query fit shared memory
    (:func:`block_smem`), else ``"chunked"``. ``sharded`` names the writer
    (kernel 5's, or kernels 3 and 4's)."""
    if cap <= WARP_CAP and k <= K_MAX \
            and warp_smem(d, quant, sharded) <= SMEM_MAX:
        return "warp"
    if block_smem(cap, d, k, quant, sharded) <= SMEM_MAX:
        return "block"
    return "chunked"


def _stable_topk(s: torch.Tensor, k: int):
    """(value desc, index asc) top-k along the last axis of ``s``, padded
    with NEG past its end."""
    m = s.shape[-1]
    if m < k:
        s = torch.cat([s, s.new_full((*s.shape[:-1], k - m), NEG)], dim=-1)
    order = torch.sort(-s, dim=-1, stable=True).indices[..., :k]
    return s.gather(-1, order), order.to(torch.int32)


def _probe_mask(sel_b, enabled_b, bucket_valid):
    return bucket_valid[sel_b].bool() & (enabled_b != 0)[:, None]


def ann_topk_ivf_plain(sel: torch.Tensor, enabled: torch.Tensor,
                       q: torch.Tensor, buckets: torch.Tensor,
                       bucket_valid: torch.Tensor, k: int = 4
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fp32 kernel: per query, gather its
    probed buckets, score them with one fp32 matmul, mask, stable-sort."""
    b, nprobe = sel.shape
    vals = torch.empty((b, nprobe, k), dtype=torch.float32, device=q.device)
    slots = torch.empty((b, nprobe, k), dtype=torch.int32, device=q.device)
    for i in range(b):
        sb = sel[i].long()
        s = buckets[sb] @ q[i].float()                     # (nprobe, cap)
        s = torch.where(_probe_mask(sb, enabled[i], bucket_valid), s, NEG)
        vals[i], slots[i] = _stable_topk(s, k)
    return vals, slots


def ann_topk_ivf_quant_plain(sel: torch.Tensor, enabled: torch.Tensor,
                             qq: torch.Tensor, q_scales: torch.Tensor,
                             buckets_q: torch.Tensor,
                             bucket_scale: torch.Tensor,
                             bucket_valid: torch.Tensor, k: int = 16
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the int8 kernel: per query, the rescaled
    int8 scores of its probed buckets (``int8_scores``), masked, stable-
    sorted."""
    b, nprobe = sel.shape
    _, cap, d = buckets_q.shape
    vals = torch.empty((b, nprobe, k), dtype=torch.float32, device=qq.device)
    slots = torch.empty((b, nprobe, k), dtype=torch.int32, device=qq.device)
    for i in range(b):
        sb = sel[i].long()
        s = int8_scores(buckets_q[sb].reshape(-1, d),
                        bucket_scale[sb].reshape(-1), qq[i:i + 1],
                        q_scales[i:i + 1]).reshape(nprobe, cap)
        s = torch.where(_probe_mask(sb, enabled[i], bucket_valid), s, NEG)
        vals[i], slots[i] = _stable_topk(s, k)
    return vals, slots


def _check(sel, enabled, q, buckets, bucket_valid, k, *, q_dtype,
           bucket_dtype, extra=()) -> tuple[int, int, int, int, int]:
    if sel.ndim != 2 or enabled.shape != sel.shape:
        raise ValueError(f"want sel and enabled (B, nprobe); got "
                         f"{tuple(sel.shape)}, {tuple(enabled.shape)}")
    if buckets.ndim != 3 or bucket_valid.shape != buckets.shape[:2]:
        raise ValueError(f"want buckets (C, cap, D) and bucket_valid "
                         f"(C, cap); got {tuple(buckets.shape)}, "
                         f"{tuple(bucket_valid.shape)}")
    b, nprobe = sel.shape
    c, cap, d = buckets.shape
    if q.shape != (b, d):
        raise ValueError(f"want queries ({b}, {d}); got {tuple(q.shape)}")
    if min(b, nprobe, c, cap, d) < 1:
        raise ValueError("empty input")
    if sel.dtype != torch.int32 or enabled.dtype != torch.int32:
        raise TypeError(f"sel and enabled must be int32; got {sel.dtype}, "
                        f"{enabled.dtype}")
    if q.dtype != q_dtype or buckets.dtype != bucket_dtype:
        raise TypeError(f"want queries {q_dtype} and buckets {bucket_dtype}; "
                        f"got {q.dtype}, {buckets.dtype}")
    if bucket_valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"bucket_valid must be bool or uint8, got "
                        f"{bucket_valid.dtype}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    tensors = (sel, enabled, q, buckets, bucket_valid, *extra)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: "
                         f"{sorted(map(str, devices))}")
    dev = sel.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel needs contiguous inputs")
    return b, nprobe, c, cap, d


def _lib():
    lib = build.load("ann_topk_ivf")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ann_topk_ivf_launch.argtypes = [p] * 5 + [i] * 7 + [p, p, p]
        lib.ann_topk_ivf_launch.restype = i
        lib.ann_topk_ivf_quant_launch.argtypes = [p] * 7 + [i] * 7 + \
            [p, p, p]
        lib.ann_topk_ivf_quant_launch.restype = i
        lib.ann_topk_ivf_sharded_launch.argtypes = [p] * 7 + [i] * 8 + \
            [p, p, p]
        lib.ann_topk_ivf_sharded_launch.restype = i
        lib.ann_topk_ivf_quant_sharded_launch.argtypes = [p] * 9 + \
            [i] * 8 + [p, p, p]
        lib.ann_topk_ivf_quant_sharded_launch.restype = i
        lib.ann_topk_ivf_chunked_launch.argtypes = [i] + [p] * 9 + [i] * 8 \
            + [p] * 5
        lib.ann_topk_ivf_chunked_launch.restype = i
        lib.ann_topk_ivf_error_string.argtypes = [i]
        lib.ann_topk_ivf_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _u8(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _launch(design: str, wrapper, *args, k: int, chunk: int | None = None):
    """Launch ``design``'s kernel for ``wrapper`` (any of the routed scans
    of kernels 3–5) on its checked CUDA inputs, in the wrapper's argument
    order, on the inputs' current stream, into fresh (B, nprobe, k)
    outputs, or (S, B, nprobe, k) stacks for the shard-owned scans, and
    count it; raises with the shape and the design if it fails.
    chip_smoke.py also calls it to hold and time "block" on inputs the
    dispatch sends to "warp", and "chunked" at a smaller ``chunk`` than
    :func:`chunk_slots`'s on inputs "block" takes."""
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design!r}")
    # the int8 scans carry the queries' scales after the queries, and the
    # shard-owned scans bucket_rows and bounds after bucket_valid
    quant = args[2].dtype == torch.int8
    at = 6 if quant else 4                      # bucket_valid
    sel, buckets = args[0], args[4 if quant else 3]
    b, nprobe = sel.shape
    c, cap, d = buckets.shape
    lead = (args[-1].numel() - 1,) if len(args) > at + 1 else ()
    dev = sel.device
    vals = torch.empty((*lead, b, nprobe, k), dtype=torch.float32, device=dev)
    idx = torch.empty((*lead, b, nprobe, k), dtype=torch.int32, device=dev)
    name = wrapper.__name__
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if design == "chunked":
            chunk = chunk or chunk_slots(cap)
            tmp_v = torch.empty((b, nprobe, k), dtype=torch.float32,
                                device=dev)
            tmp_i = torch.empty((b, nprobe, k), dtype=torch.int32,
                                device=dev)
            # the query is read in place, 16 bytes at a time
            q = _aligned(args[2])
            scales = (args[3], args[5]) if quant else (None, None)
            tail = args[at + 1:] if lead else (None, None)
            ptrs = [0 if t is None else t.data_ptr() for t in (
                sel, args[1], q, scales[0], buckets, scales[1], _u8(args[at]),
                *tail)]
            err = lib.ann_topk_ivf_chunked_launch(
                int(quant), *ptrs, *(lead or (1,)), b, nprobe, c, cap, d, k,
                chunk, tmp_v.data_ptr(), tmp_i.data_ptr(), vals.data_ptr(),
                idx.data_ptr(), stream)
        else:
            ptrs = [t.data_ptr() for t in (*args[:at], _u8(args[at]),
                                           *args[at + 1:])]
            err = getattr(lib, f"{name}_launch")(
                *ptrs, *lead, b, nprobe, c, cap, d, k, _DESIGN_CODE[design],
                vals.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        msg = lib.ann_topk_ivf_error_string(err).decode()
        where = f"s={lead[0]} " if lead else ""
        raise RuntimeError(f"{name} launch failed (cuda error {err}: {msg}) "
                           f"at {where}b={b} nprobe={nprobe} c={c} cap={cap} "
                           f"d={d} k={k} design={design}")
    wrapper.launches += 1
    setattr(wrapper, f"launches_{design}",
            getattr(wrapper, f"launches_{design}") + 1)
    return vals, idx


def ann_topk_ivf(sel: torch.Tensor, enabled: torch.Tensor, q: torch.Tensor,
                 buckets: torch.Tensor, bucket_valid: torch.Tensor,
                 k: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Routed fp32 scan: per-probe top-k slots of the selected buckets."""
    shape = _check(sel, enabled, q, buckets, bucket_valid, k,
                   q_dtype=torch.float32, bucket_dtype=torch.float32)
    if sel.device.type == "cpu":
        ann_topk_ivf.plain_calls += 1
        return ann_topk_ivf_plain(sel, enabled, q, buckets, bucket_valid, k)
    design = pick_design(shape[3], k, shape[4], quant=False, sharded=False)
    return _launch(design, ann_topk_ivf, sel, enabled, q, buckets,
                   bucket_valid, k=k)


def ann_topk_ivf_quant(sel: torch.Tensor, enabled: torch.Tensor,
                       qq: torch.Tensor, q_scales: torch.Tensor,
                       buckets_q: torch.Tensor, bucket_scale: torch.Tensor,
                       bucket_valid: torch.Tensor, k: int = 16
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Routed int8 coarse scan: per-probe top-k slots by rescaled int8
    score. Callers rescore the finalists in fp32."""
    shape = _check(sel, enabled, qq, buckets_q, bucket_valid, k,
                   q_dtype=torch.int8, bucket_dtype=torch.int8,
                   extra=(q_scales, bucket_scale))
    b, _, c, cap, _ = shape
    if q_scales.shape != (b,) or bucket_scale.shape != (c, cap) \
            or q_scales.dtype != torch.float32 \
            or bucket_scale.dtype != torch.float32:
        raise ValueError(f"want q_scales ({b},) and bucket_scale ({c}, {cap}) "
                         f"float32; got {tuple(q_scales.shape)} "
                         f"{q_scales.dtype}, {tuple(bucket_scale.shape)} "
                         f"{bucket_scale.dtype}")
    if sel.device.type == "cpu":
        ann_topk_ivf_quant.plain_calls += 1
        return ann_topk_ivf_quant_plain(sel, enabled, qq, q_scales, buckets_q,
                                        bucket_scale, bucket_valid, k)
    design = pick_design(cap, k, shape[4], quant=True, sharded=False)
    return _launch(design, ann_topk_ivf_quant, sel, enabled, qq, q_scales,
                   buckets_q, bucket_scale, bucket_valid, k=k)


for _w in (ann_topk_ivf, ann_topk_ivf_quant):
    _w.launches = 0
    _w.launches_warp = 0
    _w.launches_block = 0
    _w.launches_chunked = 0
    _w.plain_calls = 0
