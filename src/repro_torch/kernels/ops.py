"""Adapters between the index and the kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels.ann_topk import ann_topk


def ann_topk_batch(emb: torch.Tensor, active: torch.Tensor, q, k: int = 4):
    """VectorIndex backend adapter: (D,) or (B, D) queries -> (sims, rows).

    Mirrors ``repro.kernels.ops.ann_topk_jit``. ``emb`` and ``active`` are
    the index's device-resident mirror; ``q`` (a numpy array or a tensor)
    is the only thing moved to their device, and the (B, k) results stay
    there. The reference pads B to a multiple of 8 for the TPU's sublane
    tiling; the CUDA kernel takes any B, so no padding."""
    q = torch.as_tensor(q, device=emb.device).to(emb.dtype)
    single = q.ndim == 1
    if single:
        q = q[None]
    vals, rows = ann_topk(emb, active, q.contiguous(), k)
    if single:
        return vals[0], rows[0]
    return vals, rows
