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
* ``"grouped"``: every other scan, unsharded (kernels 3 and 4) or
  shard-owned (kernel 5; the real-size router's buckets of thousands of
  slots, buckets larger than shared memory, any k, any S). Each probed
  bucket is read once for all the probes on it, and only its valid rows:
  a first launch groups the probes by bucket on the device (a counting
  sort, at most ``qb`` probes a group; kernel 5 takes only the probes
  whose bucket a shard owns and writes every other probe's (S, k) column
  NEG / -1); the second runs one CTA per (group, tile of ``tile``
  slots), which stages the group's queries in shared memory, scores each
  valid row of its tile against all of them and keeps each probe's best
  min(k, tile) of the tile; the CTA that finishes a group last merges its
  probes' tile lists, in shared memory where their network fits
  (:func:`shared_merge`), else by levels in device memory, so no cap, D,
  k, B, nprobe or S is refused. Kernel 5 writes a probe's finalists at the
  shard that owns its bucket, with their global rows, and NEG / -1 at the
  others. :func:`grouped_plan` picks ``qb`` and ``tile`` from the shape
  alone (the tile so that the grid fills the card at B = 1), and the
  scratch, which does not grow with S; two CUDA launches a call.
* ``"block"``: one CTA of 256 threads per (query, probe) that reads its
  own ``sel``/``enabled`` entry (the TPU's scalar prefetch), scores every
  slot of the bucket into shared memory and runs k block-wide argmax
  passes.
* ``"chunked"``: "block" for buckets whose scores and query overflow
  shared memory (:func:`block_smem`; a cap above about 57,000 slots at
  D = 768): the CTA reads its query in place and scores the bucket in
  chunks of :func:`chunk_slots` slots, merging each chunk into a running
  list of the probe's k best kept in device memory.

No dispatch takes "block" or "chunked"; both stay launchable for every
scan (``_launch``), as the designs chip_smoke.py holds and times
"grouped" against. All four give the same finalists bitwise, the slots of NEG
entries included. A shape a design cannot take fails, with the shape and
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


DESIGNS = ("warp", "grouped", "block", "chunked")
_DESIGN_CODE = {"block": 0, "warp": 1, "chunked": 2,
                "grouped": 3}  # csrc/ann_topk_ivf.cu::Design
WARP_CAP = 64      # the largest bucket "warp" takes: two slots a lane
WARP_PROBES = 4    # probes (warps) in a CTA of "warp"
SMEM_MAX = 232448  # H100: shared memory a CTA can take
GROUP_ROWS = 32    # "grouped": the scorer's row step (8 warps x 4 rows)
# "grouped"'s picks, each timed by ``chip_smoke.py grouped_sweep`` (PERF.md
# §6 cites the sweep beside each):
GROUPED_QBS = (1, 4)       # the probes a group can hold
GROUPED_FILL = 2048        # CTAs the grid aims at (16 an SM)
GROUPED_TILE_BYTES = 384 << 10  # the least payload a tile holds
GROUPED_TILE_MAX = 8192    # the largest tile the fill picks
_TILE_SMEM = 8 * 64 * 8    # select.cuh::tile_smem<256>()
# "grouped": the dynamic shared memory a CTA may take (1 KB left for its
# static variables), and the largest tile whose scan fits it (one probe a
# group, its query read in place: T scores and T slots)
GROUPED_SMEM = SMEM_MAX - 1024
GROUPED_TILE_LARGEST = (GROUPED_SMEM - _TILE_SMEM) // 8 // GROUP_ROWS \
    * GROUP_ROWS


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


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


def grouped_tile(b: int, nprobe: int, c: int, cap: int, d: int, k: int,
                 quant: bool) -> int:
    """Slots a tile of "grouped" at this shape: a multiple of
    ``GROUP_ROWS`` that cuts the min(B·nprobe, C) buckets the probes can
    reach into about ``GROUPED_FILL`` CTAs (about 16 on each of an H100's
    132 SMs, so one query's 64 probes fill the card), holding at least
    ``GROUPED_TILE_BYTES`` of payload (128 fp32 slots at D 768, 512 int8:
    a CTA's fixed work, its probes' lists and their merge, against the
    rows it reads) and at most ``GROUPED_TILE_MAX`` slots; then at least k
    (lists of k) and the bucket over as many lists as the shared-memory
    merge takes (:func:`grouped_lists`), but at most
    ``GROUPED_TILE_LARGEST`` (past it the lists hold the tile's entries,
    and merge in device memory); the whole bucket where that is as
    large."""
    reach = min(b * nprobe, c)
    least = -(-GROUPED_TILE_BYTES // (d * (1 if quant else 4)))
    fill = min(max(-(-cap * reach // GROUPED_FILL), least), GROUPED_TILE_MAX)
    tile = max(fill, k, -(-cap // grouped_lists(k)))
    return min(_round_up(tile, GROUP_ROWS), _round_up(cap, GROUP_ROWS),
               GROUPED_TILE_LARGEST)


def merge_bytes(ntiles: int, k: int) -> int:
    """Bytes of shared memory "grouped"'s network merge of ``ntiles`` lists
    of k takes (``csrc/ann_topk_ivf.cu::merge_bytes``): per list its counts
    and their scans, the scans' scratch, and the entries above the
    threshold (up to k - 1 a list) as (value, slot) pairs over a power of
    two, each part on 16 bytes."""
    net = 1 << max(ntiles * (k - 1) - 1, 0).bit_length()
    return _round_up((4 * ntiles + 8 + 1) * 4, 16) + net * 8


def grouped_lists(k: int) -> int:
    """The most tile lists of k the shared-memory merge takes: the largest
    count whose :func:`merge_bytes` fits ``GROUPED_SMEM`` (1 where none
    does)."""
    lo, hi = 1, GROUPED_SMEM
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if merge_bytes(mid, k) <= GROUPED_SMEM else \
            (lo, mid - 1)
    return lo


def shared_merge(ntiles: int, tile: int, k: int) -> bool:
    """Do a bucket's tile lists merge in shared memory
    (``csrc/ann_topk_ivf.cu::shared_merge``)? Where each holds k entries
    and their network fits; else by levels in device memory."""
    return tile >= k and merge_bytes(ntiles, k) <= GROUPED_SMEM


def level_entries(ntiles: int, kt: int, k: int) -> int:
    """Entries of one half of a probe's scratch for the merge by levels
    (``csrc/ann_topk_ivf.cu::level_entries``): the largest level but the
    last, each merging the lists two by two, cut to k."""
    most, cnt, length = 0, ntiles, kt
    while cnt > 2:
        cnt, length = (cnt + 1) // 2, min(2 * length, k)
        most = max(most, cnt * length)
    return most


def grouped_qb(b: int, nprobe: int, c: int) -> int:
    """Probes a group of "grouped" holds at most: the smallest of
    ``GROUPED_QBS`` at or above twice the mean probes a bucket (B·nprobe
    / C), else the largest; a bucket with more probes forms more groups,
    each reading it once."""
    want = 2 * b * nprobe / c
    return next((qb for qb in GROUPED_QBS if qb >= want), GROUPED_QBS[-1])


def grouped_groups(n_probes: int, c: int, qb: int) -> int:
    """The most groups ``n_probes`` probes over C buckets make at ``qb`` a
    group: each probed bucket one, and one more for each ``qb`` probes
    past its first (the grid's group count)."""
    return min(n_probes, min(n_probes, c) + n_probes // qb)


def grouped_smem(qb: int, tile: int, d: int, cap: int, k: int, quant: bool,
                 qglobal: bool = False) -> int:
    """Bytes of dynamic shared memory a CTA of "grouped" takes
    (``csrc/ann_topk_ivf.cu::grouped_scan_bytes``): qb x tile scores, tile
    compacted slots, the warps' threshold buffers and, unless read in
    place, qb queries, each part on 16 bytes; at least
    :func:`merge_bytes` where the bucket spans more than one tile and its
    lists merge in shared memory (:func:`shared_merge`)."""
    scan = (_round_up(qb * tile * 4, 16) + _round_up(tile * 4, 16)
            + _TILE_SMEM
            + (0 if qglobal else _round_up(qb * d * (1 if quant else 4), 16)))
    ntiles = -(-cap // tile)
    in_smem = ntiles > 1 and shared_merge(ntiles, tile, k)
    return max(scan, merge_bytes(ntiles, k) if in_smem else 0)


def grouped_plan(b: int, nprobe: int, c: int, cap: int, d: int, k: int,
                 quant: bool, *, tile: int | None = None,
                 qb: int | None = None) -> dict:
    """A "grouped" launch at this shape: its ``tile`` and ``qb``
    (:func:`grouped_tile`, :func:`grouped_qb` unless given), ``qb`` taken
    down through ``GROUPED_QBS`` and then the query read in place
    (``qglobal``, one probe a group) until the shared memory fits; the
    tile count, the grid's ``groups``, the int32 ``scratch``, the
    ``merge`` ("none" for one tile, "shared" or "levels"), the tile lists'
    entries (min(k, tile) a list; 0 for one tile) and the levels'
    (``levels``, 0 unless they merge in more than one level). Raises
    ValueError, naming the shape and the design, where the tile is not one
    the kernel takes or a given tile's scan overflows shared memory; the
    picked tile always fits."""
    where = (f"b={b} nprobe={nprobe} c={c} cap={cap} d={d} k={k} "
             f"design=grouped")
    tile = grouped_tile(b, nprobe, c, cap, d, k, quant) if tile is None \
        else tile
    if tile < GROUP_ROWS or tile % GROUP_ROWS:
        raise ValueError(f"tile {tile} is not a positive multiple of "
                         f"{GROUP_ROWS} ({where})")
    ntiles = -(-cap // tile)
    want = grouped_qb(b, nprobe, c) if qb is None else qb
    if want not in GROUPED_QBS:
        raise ValueError(f"qb {want} is not one of {GROUPED_QBS} ({where})")
    fits = [x for x in reversed(GROUPED_QBS)
            if x <= want and grouped_smem(x, tile, d, cap, k, quant)
            <= GROUPED_SMEM]
    qb_, qglobal = (fits[0], False) if fits else (1, True)
    smem = grouped_smem(qb_, tile, d, cap, k, quant, qglobal)
    if smem > GROUPED_SMEM:
        raise ValueError(f"shared memory {smem} bytes over {GROUPED_SMEM} "
                         f"({where} tile={tile})")
    p = b * nprobe
    groups = grouped_groups(p, c, qb_)
    kt = min(k, tile)
    merge = "none" if ntiles == 1 else \
        "shared" if shared_merge(ntiles, tile, k) else "levels"
    return {"tile": tile, "qb": qb_, "qglobal": qglobal, "ntiles": ntiles,
            "groups": groups, "scratch": 3 * c + p + 4 * groups + 1,
            "merge": merge, "lists": p * ntiles * kt if ntiles > 1 else 0,
            "levels": 2 * p * level_entries(ntiles, kt, k)
            if merge == "levels" else 0, "smem": smem}


def pick_design(cap: int, k: int, d: int, quant: bool,
                sharded: bool = True) -> str:
    """The design of a CUDA call of kernels 3–5: ``"warp"`` for buckets of
    at most ``WARP_CAP`` slots (any k up to ``K_MAX``: its network sorts
    max(cap, k) <= 64 entries) whose queries fit its shared memory (the
    sharded writer, kernel 5, also stages its finalists there); else
    ``"grouped"``, whatever the cap, D or k."""
    if cap <= WARP_CAP and k <= K_MAX \
            and warp_smem(d, quant, sharded) <= SMEM_MAX:
        return "warp"
    return "grouped"


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
        lib.ann_topk_ivf_grouped_launch.argtypes = [i] + [p] * 9 + \
            [i] * 11 + [p] * 8
        lib.ann_topk_ivf_grouped_launch.restype = i
        lib.ann_topk_ivf_error_string.argtypes = [i]
        lib.ann_topk_ivf_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _u8(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _launch(design: str, wrapper, *args, k: int, chunk: int | None = None,
            tile: int | None = None, qb: int | None = None):
    """Launch ``design``'s kernel for ``wrapper`` (any of the routed scans
    of kernels 3–5) on its checked CUDA inputs, in the wrapper's argument
    order, on the inputs' current stream, into fresh (B, nprobe, k)
    outputs, or (S, B, nprobe, k) stacks for the shard-owned scans, and
    count it; raises with the shape, S and the design if it fails.
    chip_smoke.py also calls it to hold and time "block" and "chunked" (at
    a smaller ``chunk`` than :func:`chunk_slots`'s) on inputs the dispatch
    sends elsewhere, and "grouped" at another ``tile`` and ``qb`` than
    :func:`grouped_plan`'s."""
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
    # the shard-owned scans' bucket_rows and bounds; null for the others
    tail = args[at + 1:] if lead else (None, None)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if design == "grouped":
            plan = grouped_plan(b, nprobe, c, cap, d, k, quant, tile=tile,
                                qb=qb)
            scratch = torch.empty(plan["scratch"], dtype=torch.int32,
                                  device=dev)
            tmp_v = torch.empty(plan["lists"], dtype=torch.float32,
                                device=dev)
            tmp_i = torch.empty(plan["lists"], dtype=torch.int32, device=dev)
            lev_v = torch.empty(plan["levels"], dtype=torch.float32,
                                device=dev)
            lev_i = torch.empty(plan["levels"], dtype=torch.int32,
                                device=dev)
            # a query read in place is read 16 bytes at a time
            q = _aligned(args[2]) if plan["qglobal"] else args[2]
            scales = (args[3], args[5]) if quant else (None, None)
            ptrs = [0 if t is None else t.data_ptr() for t in (
                sel, args[1], q, scales[0], buckets, scales[1],
                _u8(args[at]), *tail)]
            lists = tuple(t.data_ptr() if t.numel() else 0
                          for t in (tmp_v, tmp_i, lev_v, lev_i))
            err = lib.ann_topk_ivf_grouped_launch(
                int(quant), *ptrs, *(lead or (1,)), b, nprobe, c, cap, d, k,
                plan["qb"], plan["tile"], plan["groups"],
                int(plan["qglobal"]), scratch.data_ptr(), *lists,
                vals.data_ptr(), idx.data_ptr(), stream)
        elif design == "chunked":
            chunk = chunk or chunk_slots(cap)
            tmp_v = torch.empty((b, nprobe, k), dtype=torch.float32,
                                device=dev)
            tmp_i = torch.empty((b, nprobe, k), dtype=torch.int32,
                                device=dev)
            # the query is read in place, 16 bytes at a time
            q = _aligned(args[2])
            scales = (args[3], args[5]) if quant else (None, None)
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
    _w.launches_grouped = 0
    _w.launches_block = 0
    _w.launches_chunked = 0
    _w.plain_calls = 0
