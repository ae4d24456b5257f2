"""Sharded clustered stage 1 (DESIGN.md §13): the shard-owned routed
scans, as CUDA kernels for Hopper (``csrc/ann_topk_ivf.cu``'s sharded
entry points) beside their plain PyTorch versions.

Replaces ``repro/kernels/ann_topk_sharded.py::ann_topk_ivf_sharded`` and
``::ann_topk_ivf_quant_sharded``, which run the Pallas routed-scan kernels
once per shard. ``sel`` carries GLOBAL cluster ids from the shared router;
shard s owns the contiguous cluster range ``[bounds[s], bounds[s+1])``
(a repeated cut point is an empty shard). The cut points ascend, as the
router's prefix of shard sizes does: the CUDA designs find a bucket's
owner by binary search over them, so a ``bounds`` that descends is
refused where it lies on the host (on a card it is not read back). Output contract, the
reference's: ``(vals, rows)`` stacks of shape (S, B, nprobe, k), where
entry (s, b, j) holds probe (b, j)'s finalists if shard s owns
``sel[b, j]`` and NEG otherwise, rows are GLOBAL index rows, -1 where
``vals <= NEG / 2``. ``kernels/ops.py::_merge_shards`` merges the stacks.

Input contract, one change from the reference: the reference takes a
padded (S, Cmax, cap, D) copy of the buckets, laid out so that a device
mesh can hold one shard's slice per device. On one device every shard's
slice is the contiguous range ``[bounds[s], bounds[s+1])`` of the
unsharded (C, cap, D) layout that ``ClusterRouter.kernel_layout`` already
keeps on the device, so these functions take that layout, its
``bucket_valid`` and ``bucket_rows`` (C, cap), and ``bounds`` (S+1,)
int32, and no second copy of the payload exists.

The CUDA kernels write each probe's whole (S, k) column of the stacks:
the finalists with their global rows (read from ``bucket_rows``) at the
shard that owns its bucket, NEG / -1 at the others (and throughout for a
probe that is disabled, out of range or on a bucket no shard owns). They
score exactly as ``ann_topk_ivf`` / ``ann_topk_ivf_quant`` do (the same
device code), so at S = 1 the stacks equal the unsharded kernels'
bitwise after the slot -> row map. They share the unsharded scans'
dispatch and launcher (``ann_topk_ivf.pick_design``: ``"warp"``, a warp
a probe, for buckets of at most 64 slots at k <= 64; ``"grouped"``
above, which reads each probed bucket once for all its probes, tile by
tile, and writes the stacks from the group's last CTA).
``csrc/ann_topk_ivf.cu`` has the details. Shapes a design cannot take
fail at launch, with the shape, S and the design in the error; there is
no fall back to another design.

:func:`ann_topk_ivf_sharded` and :func:`ann_topk_ivf_quant_sharded` launch
the kernels for CUDA tensors and raise if they cannot; they take the plain
versions only for CPU tensors. Each counts ``launches``, each design's
launches (``launches_<design>``) and ``plain_calls``.

The reference's ``shard_map`` mode, one shard's bucket range per device,
is :func:`ann_topk_ivf_sharded_parts` /
:func:`ann_topk_ivf_quant_sharded_parts`: the same wrappers launched once
per shard, each on its own device with a one-shard ``bounds``, over that
device's :class:`ShardPart` (kept by
``ClusterRouter.kernel_shard_buckets``). Its dispatch rule is the
reference's: one device per shard when S > 1, the index is on CUDA and
:func:`mesh_available`; otherwise the one-device path above. Each shard
costs the host a copy up, a launch and a copy down, so where the scan is
short (one query, engine-sized buckets) S cards take longer than one card
(PERF.md section 5).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.kernels.ann_topk import NEG
from repro_torch.kernels.ann_topk_ivf import (  # noqa: F401 (kernel 5's names)
    DESIGNS, SMEM_MAX, WARP_CAP, WARP_PROBES, _check, _launch,
    ann_topk_ivf_plain, ann_topk_ivf_quant_plain, pick_design, warp_smem)


def mesh_available(n_shards: int) -> bool:
    """True when the host can lay one cache shard per CUDA device."""
    return torch.cuda.device_count() >= n_shards


def shard_devices(n_shards: int, device: torch.device
                  ) -> Optional[list[torch.device]]:
    """The reference's dispatch rule: the devices of
    ``launch/mesh.make_shard_mesh(n_shards)`` when S > 1, the index is on
    CUDA and the host has S CUDA devices; else None (every shard on the
    index's device)."""
    if n_shards > 1 and device.type == "cuda" and mesh_available(n_shards):
        from repro_torch.launch.mesh import make_shard_mesh

        return make_shard_mesh(n_shards)
    return None


@dataclasses.dataclass
class ShardPart:
    """One shard's owned bucket range ``[lo, hi)`` of the clustered layout,
    on its own device: the payload, ``bucket_valid`` and ``bucket_rows``
    of those buckets and the one-shard cut points ``[0, hi - lo]``."""

    device: torch.device
    lo: int
    hi: int
    payload: Any                 # (n, cap, D) fp32, or int8 and (n, cap) f32
    bucket_valid: torch.Tensor   # (n, cap) bool
    bucket_rows: torch.Tensor    # (n, cap) int32 global rows, -1 = empty
    bounds: torch.Tensor         # (2,) int32: [0, n]


def _own_probes(sel: torch.Tensor, en: torch.Tensor, lo: int, hi: int):
    """Mask ``sel`` down to one shard's owned cluster range and translate
    to its local bucket ids. Non-owned probes come back disabled with a
    clipped (in-range, never scanned) local id."""
    own = (sel >= lo) & (sel < hi)
    loc = (sel - lo).clamp(0, hi - lo - 1).to(torch.int32)
    return loc, (en * own).to(torch.int32)


def _sharded_plain(scan, sel, enabled, bucket_rows, bounds, k):
    """The reference's per-shard loop: per shard, mask the probes to its
    range, ``scan(loc, en_s, lo, hi)`` its slice of the buckets, then map
    the winning slots to global rows. An empty shard scans nothing: all
    its probes are disabled, so its entries are NEG / -1."""
    b, nprobe = sel.shape
    s, cap = bounds.numel() - 1, bucket_rows.shape[1]
    vals = torch.full((s, b, nprobe, k), NEG, dtype=torch.float32,
                      device=sel.device)
    rows = torch.full((s, b, nprobe, k), -1, dtype=torch.int32,
                      device=sel.device)
    for si in range(s):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        if hi <= lo:
            continue
        loc, en_s = _own_probes(sel, enabled, lo, hi)
        v, slots = scan(loc, en_s, lo, hi)
        # a masked finalist's slot may lie past the bucket (k > cap)
        r = bucket_rows[lo:hi][loc.long()[:, :, None],
                               slots.long().clamp(0, cap - 1)]
        vals[si] = v
        rows[si] = torch.where(v > NEG / 2, r, -1)
    return vals, rows


def ann_topk_ivf_sharded_plain(sel, enabled, q, buckets, bucket_valid,
                               bucket_rows, bounds, k: int = 4):
    """Plain PyTorch version of the fp32 sharded scan: the plain
    ``ann_topk_ivf`` over each shard's slice."""
    return _sharded_plain(
        lambda loc, en_s, lo, hi: ann_topk_ivf_plain(
            loc, en_s, q, buckets[lo:hi], bucket_valid[lo:hi], k),
        sel, enabled, bucket_rows, bounds, k)


def ann_topk_ivf_quant_sharded_plain(sel, enabled, qq, q_scales, buckets_q,
                                     bucket_scale, bucket_valid, bucket_rows,
                                     bounds, k: int = 16):
    """Plain PyTorch version of the int8 sharded scan: the plain
    ``ann_topk_ivf_quant`` over each shard's slice."""
    return _sharded_plain(
        lambda loc, en_s, lo, hi: ann_topk_ivf_quant_plain(
            loc, en_s, qq, q_scales, buckets_q[lo:hi], bucket_scale[lo:hi],
            bucket_valid[lo:hi], k),
        sel, enabled, bucket_rows, bounds, k)


def _check_shards(c: int, cap: int, bucket_rows, bounds) -> None:
    if bucket_rows.shape != (c, cap) or bucket_rows.dtype != torch.int32:
        raise ValueError(f"want bucket_rows ({c}, {cap}) int32; got "
                         f"{tuple(bucket_rows.shape)} {bucket_rows.dtype}")
    if bounds.ndim != 1 or bounds.numel() < 2 or bounds.dtype != torch.int32:
        raise ValueError(f"want bounds (S+1,) int32 with S >= 1; got "
                         f"{tuple(bounds.shape)} {bounds.dtype}")
    if bounds.device.type == "cpu" and bool((bounds[1:] < bounds[:-1]).any()):
        raise ValueError(f"want ascending bounds; got {bounds.tolist()}")


def ann_topk_ivf_sharded(sel: torch.Tensor, enabled: torch.Tensor,
                         q: torch.Tensor, buckets: torch.Tensor,
                         bucket_valid: torch.Tensor,
                         bucket_rows: torch.Tensor, bounds: torch.Tensor,
                         k: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 shard-owned routed scan: (S, B, nprobe, k) stacks of vals and
    global rows."""
    shape = _check(sel, enabled, q, buckets, bucket_valid, k,
                   q_dtype=torch.float32, bucket_dtype=torch.float32,
                   extra=(bucket_rows, bounds))
    _check_shards(shape[2], shape[3], bucket_rows, bounds)
    if sel.device.type == "cpu":
        ann_topk_ivf_sharded.plain_calls += 1
        return ann_topk_ivf_sharded_plain(sel, enabled, q, buckets,
                                          bucket_valid, bucket_rows, bounds,
                                          k)
    design = pick_design(shape[3], k, shape[4], quant=False, sharded=True)
    return _launch(design, ann_topk_ivf_sharded, sel, enabled, q, buckets,
                   bucket_valid, bucket_rows, bounds, k=k)


def ann_topk_ivf_quant_sharded(sel: torch.Tensor, enabled: torch.Tensor,
                               qq: torch.Tensor, q_scales: torch.Tensor,
                               buckets_q: torch.Tensor,
                               bucket_scale: torch.Tensor,
                               bucket_valid: torch.Tensor,
                               bucket_rows: torch.Tensor,
                               bounds: torch.Tensor, k: int = 16
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 shard-owned routed coarse scan, the quantized sibling of
    :func:`ann_topk_ivf_sharded`. Callers rescore the finalists in fp32."""
    shape = _check(sel, enabled, qq, buckets_q, bucket_valid, k,
                   q_dtype=torch.int8, bucket_dtype=torch.int8,
                   extra=(q_scales, bucket_scale, bucket_rows, bounds))
    b, _, c, cap, _ = shape
    if q_scales.shape != (b,) or bucket_scale.shape != (c, cap) \
            or q_scales.dtype != torch.float32 \
            or bucket_scale.dtype != torch.float32:
        raise ValueError(f"want q_scales ({b},) and bucket_scale ({c}, {cap}) "
                         f"float32; got {tuple(q_scales.shape)} "
                         f"{q_scales.dtype}, {tuple(bucket_scale.shape)} "
                         f"{bucket_scale.dtype}")
    _check_shards(c, cap, bucket_rows, bounds)
    if sel.device.type == "cpu":
        ann_topk_ivf_quant_sharded.plain_calls += 1
        return ann_topk_ivf_quant_sharded_plain(
            sel, enabled, qq, q_scales, buckets_q, bucket_scale,
            bucket_valid, bucket_rows, bounds, k)
    design = pick_design(cap, k, shape[4], quant=True, sharded=True)
    return _launch(design, ann_topk_ivf_quant_sharded, sel, enabled, qq,
                   q_scales, buckets_q, bucket_scale, bucket_valid,
                   bucket_rows, bounds, k=k)


def _packed_probes(sel, enabled, queries, bounds):
    """Every shard's probes and the queries as one byte row a shard, on
    ``sel``'s device, and the views that unpack a row: (offset, nbytes,
    dtype, shape) for the probes (2, B, nprobe) int32, local bucket ids
    then enables, and for each query tensor. Shard s's probes are masked
    to its range ``[bounds[s], bounds[s+1])`` and translated to local
    ids, all shards at once; a probe it does not own is disabled, at
    local bucket 0 (never scanned). Each piece starts 16-byte aligned."""
    lo, hi = bounds[:-1, None, None], bounds[1:, None, None]
    own = (sel >= lo) & (sel < hi)
    probes = torch.stack([(sel - lo) * own, enabled * own], 1)
    pieces = [probes.to(torch.int32)] + [x[None] for x in queries]
    views, at = [], 0
    for x in pieces:
        n = x[0].numel() * x.element_size()
        views.append((at, n, x.dtype, tuple(x.shape[1:])))
        at += -(-n // 16) * 16
    rows = torch.empty((bounds.numel() - 1, at), dtype=torch.uint8,
                       device=sel.device)
    for x, (o, n, _, _) in zip(pieces, views):
        rows[:, o:o + n].copy_(x.reshape(x.shape[0], -1).view(torch.uint8))
    return rows, views


def _parts(scan, sel, enabled, queries, parts: list[Optional[ShardPart]],
           bounds: torch.Tensor, k: int):
    """Run ``scan(loc, en_s, queries_s, part)`` -> (1, B, nprobe, k) stacks
    once per non-empty shard on its own device, and gather the stacks on
    ``sel``'s device into the (S, B, nprobe, k) stacks; an empty shard's
    entries are NEG / -1. A shard costs the host one copy up (its row of
    :func:`_packed_probes`), the launch, one stack of vals and rows and
    one copy down. Every copy up is issued before any launch (a copy runs
    on the sending device's stream, so one queued behind that device's
    own scan would hold the next device back), and every launch before
    any copy down, so the devices scan at the same time."""
    b, nprobe = sel.shape
    rows, views = _packed_probes(sel, enabled, queries, bounds)
    ups = [(si, part, rows[si].to(part.device))
           for si, part in enumerate(parts) if part is not None]
    out = []
    for si, part, row in ups:
        (probes, *qs) = [row[o:o + n].view(dt).view(shape)
                         for o, n, dt, shape in views]
        v, r = scan(probes[0], probes[1], qs, part)
        out.append((si, torch.stack([v[0].view(torch.int32), r[0]])))
    stacks = torch.empty((len(parts), 2, b, nprobe, k), dtype=torch.int32,
                         device=sel.device)
    for si, part in enumerate(parts):
        if part is None:
            stacks[si, 0].view(torch.float32).fill_(NEG)
            stacks[si, 1].fill_(-1)
    for si, x in out:
        stacks[si].copy_(x)
    return stacks[:, 0].view(torch.float32), stacks[:, 1]


def ann_topk_ivf_sharded_parts(sel: torch.Tensor, enabled: torch.Tensor,
                               q: torch.Tensor,
                               parts: list[Optional[ShardPart]],
                               bounds: torch.Tensor, k: int = 4
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 shard-owned routed scan with shard s's buckets on
    ``parts[s].device`` (None: an empty shard) and its range
    ``[bounds[s], bounds[s+1])`` (``bounds`` on ``sel``'s device): kernel
    5 once per non-empty shard on its device; the stacks on ``sel``'s
    device, equal to :func:`ann_topk_ivf_sharded`'s over the whole
    layout."""
    return _parts(
        lambda loc, en_s, qs, p: ann_topk_ivf_sharded(
            loc, en_s, qs[0], p.payload, p.bucket_valid, p.bucket_rows,
            p.bounds, k),
        sel, enabled, [q], parts, bounds, k)


def ann_topk_ivf_quant_sharded_parts(sel: torch.Tensor, enabled: torch.Tensor,
                                     qq: torch.Tensor,
                                     q_scales: torch.Tensor,
                                     parts: list[Optional[ShardPart]],
                                     bounds: torch.Tensor, k: int = 16
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 sibling of :func:`ann_topk_ivf_sharded_parts`."""
    return _parts(
        lambda loc, en_s, qs, p: ann_topk_ivf_quant_sharded(
            loc, en_s, qs[0], qs[1], p.payload[0], p.payload[1],
            p.bucket_valid, p.bucket_rows, p.bounds, k),
        sel, enabled, [qq, q_scales], parts, bounds, k)


for _w in (ann_topk_ivf_sharded, ann_topk_ivf_quant_sharded):
    _w.launches = 0
    _w.launches_warp = 0
    _w.launches_grouped = 0
    _w.launches_block = 0
    _w.launches_chunked = 0
    _w.plain_calls = 0
