"""Adapters between the indexes and the kernels, mirroring
``repro.kernels.ops``.

The reference pads B to a multiple of 8 for the TPU's sublane tiling; the
CUDA kernels take any B, so nothing here pads. Queries arrive as numpy
arrays or tensors and are the only thing moved to the index's device; the
results stay there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ann_topk import K_MAX, NEG, ann_topk
from repro_torch.kernels.ann_topk_ivf import ann_topk_ivf, ann_topk_ivf_quant
from repro_torch.kernels.ann_topk_quant import ann_topk_quant


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
    port's own kernel (one summation order, the same tie rule). Returns
    ``(sel, enabled)``, both (B, nprobe) int32."""
    if nprobe > K_MAX:
        raise ValueError(f"nprobe={nprobe} exceeds the routing kernel's "
                         f"k limit K_MAX={K_MAX}")
    vals, sel = ann_topk(centroids, live, q, nprobe)
    return sel, (vals > NEG / 2).to(torch.int32)


def _merge_probes(vals: torch.Tensor, slots: torch.Tensor, sel: torch.Tensor,
                  bucket_rows: torch.Tensor, k: int):
    """(B, nprobe, k) per-probe finalists -> (B, kk) global top-k. Mirrors
    ``repro.kernels.ops._merge_probes``: slots map to global rows through
    ``bucket_rows[sel]`` (-1 where ``vals <= NEG / 2``), then the top-kk of
    the flat probe-major finalists, ties to the lowest flat position as
    ``lax.top_k`` gives them (a stable sort; ``torch.topk``'s tie order is
    unspecified). Exact ties between buckets therefore merge in probe
    order, the reference's documented kernel-backend caveat."""
    b, nprobe, kin = vals.shape
    cap = bucket_rows.shape[1]
    rows = bucket_rows[sel.long()[:, :, None], slots.long().clamp(0, cap - 1)]
    rows = torch.where(vals > NEG / 2, rows, -1)
    flat_v = vals.reshape(b, nprobe * kin)
    flat_r = rows.reshape(b, nprobe * kin)
    kk = min(k, nprobe * kin)
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
