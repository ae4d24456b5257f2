"""The kernels' public wrappers and the adapters between the indexes and
the stage-1 kernels, mirroring ``repro.kernels.ops``. The model stack
calls the attention wrappers (``flash_attention_fwd``,
``decode_attention``) as they are.

The reference pads B to a multiple of 8 for the TPU's sublane tiling; the
CUDA kernels take any B, so nothing here pads. Queries arrive as numpy
arrays or tensors and are the only thing moved to the index's device; the
results stay there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ann_topk import NEG, ann_topk
from repro_torch.kernels.ann_topk_ivf import ann_topk_ivf, ann_topk_ivf_quant
from repro_torch.kernels.ann_topk_quant import ann_topk_quant
from repro_torch.kernels.ann_topk_sharded import (
    ann_topk_ivf_quant_sharded, ann_topk_ivf_quant_sharded_parts,
    ann_topk_ivf_sharded, ann_topk_ivf_sharded_parts)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention_fwd

__all__ = ["ann_topk", "ann_topk_quant", "ann_topk_ivf", "ann_topk_ivf_quant",
           "ann_topk_ivf_sharded", "ann_topk_ivf_quant_sharded",
           "flash_attention_fwd", "decode_attention", "ann_topk_batch",
           "ann_topk_quant_batch", "ann_topk_ivf_batch",
           "ann_topk_ivf_quant_batch", "ann_topk_ivf_sharded_batch",
           "ann_topk_ivf_quant_sharded_batch"]


def _on(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype).contiguous()


def ann_topk_batch(emb: torch.Tensor, active: torch.Tensor, q, k: int = 4):
    """VectorIndex backend adapter: (D,) or (B, D) queries -> (sims, rows).

    Mirrors ``repro.kernels.ops.ann_topk_jit``. ``emb`` and ``active`` are
    the index's device-resident mirror; ``q`` (a numpy array or a tensor)
    is the only thing moved to their device, and the (B, k) results stay
    there."""
    q = _on(q, emb.device, emb.dtype)
    single = q.ndim == 1
    if single:
        q = q[None]
    vals, rows = ann_topk(emb, active, q, k)
    if single:
        return vals[0], rows[0]
    return vals, rows


def ann_topk_quant_batch(emb_q: torch.Tensor, scales: torch.Tensor,
                         active: torch.Tensor, qq, q_scales, k: int = 16):
    """Warm-tier QuantIndex backend adapter (coarse phase only). Mirrors
    ``repro.kernels.ops.ann_topk_quant_jit``: the host quantizes the
    queries with the routine the numpy path uses, so both backends score
    identical integers."""
    dev = emb_q.device
    return ann_topk_quant(emb_q, scales, active, _on(qq, dev, torch.int8),
                          _on(q_scales, dev, torch.float32), k)


def _route(centroids: torch.Tensor, live: torch.Tensor, q: torch.Tensor,
           nprobe: int):
    """Centroid scoring + top-``nprobe`` cluster selection. Mirrors
    ``repro.kernels.ops._route``: ``where(live, q @ centroids.T, NEG)``,
    then top-nprobe with ties to the lowest cluster id, which is exactly
    ``ann_topk(centroids, live, q, nprobe)``, so routing runs through the
    port's own kernel (one summation order, the same tie rule) at any
    nprobe up to the centroid count (above 64 on its ``"wide"`` design).
    Returns ``(sel, enabled)``, both (B, nprobe) int32."""
    vals, sel = ann_topk(centroids, live, q, nprobe)
    return sel, (vals > NEG / 2).to(torch.int32)


def _merge_probes(vals: torch.Tensor, slots: torch.Tensor, sel: torch.Tensor,
                  bucket_rows: torch.Tensor, k: int):
    """(B, nprobe, k) per-probe finalists -> (B, kk) global top-k. Mirrors
    ``repro.kernels.ops._merge_probes``: slots map to global rows through
    ``bucket_rows[sel]`` (-1 where ``vals <= NEG / 2``), then the top-kk of
    the flat probe-major finalists (``_top_flat``). Exact ties between
    buckets therefore merge in probe order, the reference's documented
    kernel-backend caveat."""
    b, nprobe, kin = vals.shape
    cap = bucket_rows.shape[1]
    rows = bucket_rows[sel.long()[:, :, None], slots.long().clamp(0, cap - 1)]
    rows = torch.where(vals > NEG / 2, rows, -1)
    flat_v = vals.reshape(b, nprobe * kin)
    flat_r = rows.reshape(b, nprobe * kin)
    return _top_flat(flat_v, flat_r, k)


def _top_flat(flat_v: torch.Tensor, flat_r: torch.Tensor, k: int):
    """The top-min(k, m) of (B, m) finalists, ties to the lowest flat
    position as ``lax.top_k`` gives them (a stable sort; ``torch.topk``'s
    tie order is unspecified)."""
    kk = min(k, flat_v.shape[1])
    pos = torch.sort(-flat_v, dim=1, stable=True).indices[:, :kk]
    return flat_v.gather(1, pos), flat_r.gather(1, pos)


def ann_topk_ivf_batch(centroids: torch.Tensor, live: torch.Tensor,
                       buckets: torch.Tensor, bucket_rows: torch.Tensor,
                       bucket_valid: torch.Tensor, q, nprobe: int,
                       k: int = 4):
    """Clustered VectorIndex backend adapter, mirroring
    ``repro.kernels.ops.ann_topk_ivf_jit``: route the (B, D) query block
    against the centroids, scan only the selected buckets, merge the
    per-probe finalists. Returns ``(vals, rows, sel, enabled)`` — rows are
    global index rows (-1 where masked); sel/enabled feed the host's
    rows-scanned accounting."""
    q = _on(q, buckets.device, torch.float32)
    sel, enabled = _route(centroids, live, q, nprobe)
    vals, slots = ann_topk_ivf(sel, enabled, q, buckets, bucket_valid, k)
    top_v, top_r = _merge_probes(vals, slots, sel, bucket_rows, k)
    return top_v, top_r, sel, enabled


def ann_topk_ivf_quant_batch(centroids: torch.Tensor, live: torch.Tensor,
                             buckets_q: torch.Tensor,
                             bucket_scale: torch.Tensor,
                             bucket_rows: torch.Tensor,
                             bucket_valid: torch.Tensor, q, qq, q_scales,
                             nprobe: int, k: int = 16):
    """Clustered QuantIndex backend adapter (coarse phase only), mirroring
    ``repro.kernels.ops.ann_topk_ivf_quant_jit``: routing runs on the fp32
    query against the fp32 centroids; the bucket scan is int8 × int8 with
    int32 accumulation."""
    dev = buckets_q.device
    q = _on(q, dev, torch.float32)
    sel, enabled = _route(centroids, live, q, nprobe)
    vals, slots = ann_topk_ivf_quant(
        sel, enabled, _on(qq, dev, torch.int8),
        _on(q_scales, dev, torch.float32), buckets_q, bucket_scale,
        bucket_valid, k)
    top_v, top_r = _merge_probes(vals, slots, sel, bucket_rows, k)
    return top_v, top_r, sel, enabled


def _merge_shards(vals: torch.Tensor, rows: torch.Tensor, k: int):
    """(S, B, nprobe, k) shard stacks -> (B, kk) finalists. Mirrors
    ``repro.kernels.ops._merge_shards``: rows already carry GLOBAL index
    ids (-1 where masked), so no translation here; one top-kk over the
    shard-major flat (S·nprobe·k) finalists, exact-score ties across
    shards in shard-major flat order (the reference's kernel-backend
    caveat, as ``_merge_probes``'s between-bucket order)."""
    b = vals.shape[1]
    return _top_flat(vals.transpose(0, 1).reshape(b, -1),
                     rows.transpose(0, 1).reshape(b, -1), k)


def ann_topk_ivf_sharded_batch(centroids: torch.Tensor, live: torch.Tensor,
                               buckets: torch.Tensor,
                               bucket_rows: torch.Tensor,
                               bucket_valid: torch.Tensor,
                               bounds: torch.Tensor, q, nprobe: int,
                               k: int = 4, parts=None):
    """Sharded clustered VectorIndex backend adapter (DESIGN.md §13),
    mirroring ``repro.kernels.ops.ann_topk_ivf_sharded_jit``: routing
    stays GLOBAL (the same ``_route`` as the unsharded adapter, so the
    probed cluster set is shard-count invariant), each probed bucket is
    scanned by its owning shard (``kernels/ann_topk_sharded``), and the
    S·nprobe·k finalists merge once. With ``parts`` (one
    ``ShardPart`` per shard, on its own device; ``buckets`` is then
    unused) each shard scans on its device and the stacks come to the
    centroids' device for the merge. Returns ``(vals, rows, sel,
    enabled)`` like :func:`ann_topk_ivf_batch`."""
    q = _on(q, centroids.device, torch.float32)
    sel, enabled = _route(centroids, live, q, nprobe)
    if parts is not None:
        vals, rows = ann_topk_ivf_sharded_parts(sel, enabled, q, parts,
                                                bounds, k)
    else:
        vals, rows = ann_topk_ivf_sharded(sel, enabled, q, buckets,
                                          bucket_valid, bucket_rows, bounds,
                                          k)
    top_v, top_r = _merge_shards(vals, rows, k)
    return top_v, top_r, sel, enabled


def ann_topk_ivf_quant_sharded_batch(centroids: torch.Tensor,
                                     live: torch.Tensor,
                                     buckets_q: torch.Tensor,
                                     bucket_scale: torch.Tensor,
                                     bucket_rows: torch.Tensor,
                                     bucket_valid: torch.Tensor,
                                     bounds: torch.Tensor, q, qq, q_scales,
                                     nprobe: int, k: int = 16, parts=None):
    """Sharded clustered QuantIndex backend adapter (coarse phase only):
    fp32 global routing, the int8 shard-owned scan (per device with
    ``parts``, as :func:`ann_topk_ivf_sharded_batch`), one cross-shard
    merge; mirrors ``repro.kernels.ops.ann_topk_ivf_quant_sharded_jit``."""
    dev = centroids.device
    q = _on(q, dev, torch.float32)
    sel, enabled = _route(centroids, live, q, nprobe)
    qq, q_scales = _on(qq, dev, torch.int8), _on(q_scales, dev, torch.float32)
    if parts is not None:
        vals, rows = ann_topk_ivf_quant_sharded_parts(sel, enabled, qq,
                                                      q_scales, parts, bounds,
                                                      k)
    else:
        vals, rows = ann_topk_ivf_quant_sharded(
            sel, enabled, qq, q_scales, buckets_q, bucket_scale,
            bucket_valid, bucket_rows, bounds, k)
    top_v, top_r = _merge_shards(vals, rows, k)
    return top_v, top_r, sel, enabled
