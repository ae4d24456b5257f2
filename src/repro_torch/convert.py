"""Carry state from the reference package into the port.

The port's main path runs no model, so its state is the stage-1 index:
the embedding matrix, the active mask, the row→se_id map and the
free-list. ``ModelJudge`` parameters join this module with the ROADMAP
slice "Real stage-2 compute".
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.seri import VectorIndex


def vector_index_from_numpy(emb, active, row_se, free, *,
                            backend: str = "kernel",
                            device="cuda") -> VectorIndex:
    """A port ``VectorIndex`` holding the given index state: ``emb``
    (capacity, D) fp32, ``active`` (capacity,), ``row_se`` (capacity,)
    and ``free``, the reference's free-list in its own order (the next
    allocation pops its LAST element), so the next ``add`` picks the same
    row as the reference would. The host arrays are copied; with
    ``backend="kernel"`` the device mirror is uploaded from them."""
    emb = np.asarray(emb, np.float32)
    capacity, dim = emb.shape
    index = VectorIndex(capacity, dim, backend=backend, device=device)
    index.emb[:] = emb
    index.active[:] = np.asarray(active, bool)
    index.row_se[:] = np.asarray(row_se, np.int64)
    index._free = [int(r) for r in free]
    if index.emb_dev is not None:
        index.emb_dev.copy_(torch.from_numpy(index.emb))
        index.active_dev.copy_(torch.from_numpy(index.active))
    return index
