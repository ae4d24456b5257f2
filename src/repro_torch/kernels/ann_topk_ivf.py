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
them. The simple design (one kernel for both payload types) gives each
(query, probe) one CTA that reads its own ``sel``/``enabled`` entry (the
TPU's scalar prefetch), scores every slot of the bucket into shared memory
and runs k block-wide argmax passes. A bucket too large for shared memory
fails at launch, with the shape in the error.

:func:`ann_topk_ivf` and :func:`ann_topk_ivf_quant` launch the kernels for
CUDA tensors and raise if they cannot; they take the plain versions only
for CPU tensors. Each counts ``launches`` and ``plain_calls``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ann_topk import K_MAX, NEG
from repro_torch.kernels.ann_topk_quant import int8_scores


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
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in [1, {K_MAX}], got {k}")
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
        lib.ann_topk_ivf_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            p, p, p]
        lib.ann_topk_ivf_launch.restype = i
        lib.ann_topk_ivf_quant_launch.argtypes = [p, p, p, p, p, p, p, i, i,
                                                  i, i, i, i, p, p, p]
        lib.ann_topk_ivf_quant_launch.restype = i
        lib.ann_topk_ivf_error_string.argtypes = [i]
        lib.ann_topk_ivf_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _u8(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _launch(name: str, dev, shape, args, k):
    b, nprobe, c, cap, d = shape
    vals = torch.empty((b, nprobe, k), dtype=torch.float32, device=dev)
    slots = torch.empty((b, nprobe, k), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{name}_launch")(
            *[t.data_ptr() for t in args], b, nprobe, c, cap, d, k,
            vals.data_ptr(), slots.data_ptr(), stream)
    if err != 0:
        msg = lib.ann_topk_ivf_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed (cuda error {err}: {msg}) "
                           f"at b={b} nprobe={nprobe} c={c} cap={cap} d={d} "
                           f"k={k}")
    return vals, slots


def ann_topk_ivf(sel: torch.Tensor, enabled: torch.Tensor, q: torch.Tensor,
                 buckets: torch.Tensor, bucket_valid: torch.Tensor,
                 k: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Routed fp32 scan: per-probe top-k slots of the selected buckets."""
    shape = _check(sel, enabled, q, buckets, bucket_valid, k,
                   q_dtype=torch.float32, bucket_dtype=torch.float32)
    if sel.device.type == "cpu":
        ann_topk_ivf.plain_calls += 1
        return ann_topk_ivf_plain(sel, enabled, q, buckets, bucket_valid, k)
    out = _launch("ann_topk_ivf", sel.device, shape,
                  (sel, enabled, q, buckets, _u8(bucket_valid)), k)
    ann_topk_ivf.launches += 1
    return out


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
    out = _launch("ann_topk_ivf_quant", sel.device, shape,
                  (sel, enabled, qq, q_scales, buckets_q, bucket_scale,
                   _u8(bucket_valid)), k)
    ann_topk_ivf_quant.launches += 1
    return out


ann_topk_ivf.launches = 0
ann_topk_ivf.plain_calls = 0
ann_topk_ivf_quant.launches = 0
ann_topk_ivf_quant.plain_calls = 0
