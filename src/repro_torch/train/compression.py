"""Gradient compression for slow inter-node links, the port of the
reference's ``train/compression.py``:

* ``topk_ef`` -- per-tensor top-k magnitude sparsification with error
  feedback: the residual (the dropped mass) is carried into the next
  step, so the compressed descent tracks the dense one.
* ``int8`` -- per-block linear quantisation (absmax scales), 4x over fp32
  on the wire.

Both act on the local gradient before a data-parallel all-reduce. Top-k
keeps ``jax.lax.top_k``'s order (the lower index first among equal
magnitudes); ``int8_quantize`` rounds half to even as ``jnp.round`` does,
so its values are the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.train import tree as tr

# ------------------------------------------------------------- top-k EF


def topk_compress(g: torch.Tensor, frac: float):
    """Keep the top ``frac`` fraction of entries by magnitude. Returns
    ``(values, flat_indices, shape)``."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    idx = torch.sort(torch.abs(flat), descending=True, stable=True).indices[:k]
    return flat[idx], idx, tuple(g.shape)


def topk_decompress(vals, idx, shape, dtype) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    flat = torch.zeros(n, dtype=dtype, device=vals.device)
    flat[idx] = vals.to(dtype)
    return flat.reshape(shape)


def ef_init(params):
    return tr.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def ef_compress_tree(grads, residuals, frac: float):
    """Error-feedback top-k over a gradient tree. Returns ``(compressed
    leaves [(values, indices), ...], new residuals, dense gradients)``."""
    flat_g, treedef = tr.flatten(grads)
    comp, new_r, dense = [], [], []
    for g, r in zip(flat_g, tr.leaves(residuals), strict=True):
        corrected = g.float() + r
        vals, idx, shape = topk_compress(corrected, frac)
        d = topk_decompress(vals, idx, shape, torch.float32)
        comp.append((vals, idx))
        new_r.append(corrected - d)
        dense.append(d.to(g.dtype))
    return comp, tr.unflatten(treedef, new_r), tr.unflatten(treedef, dense)


# ------------------------------------------------------------- int8


@dataclasses.dataclass
class Quantized:
    q: Any       # int8 values (n_blocks, block)
    scale: Any   # fp32 per-block absmax scales (n_blocks,)
    shape: tuple


def int8_quantize(g: torch.Tensor, block: int = 256) -> Quantized:
    flat = g.float().reshape(-1)
    pad = (-flat.numel()) % block
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return Quantized(q=q, scale=scale[:, 0], shape=tuple(g.shape))


def int8_dequantize(z: Quantized, dtype=torch.float32) -> torch.Tensor:
    flat = (z.q.float() * z.scale[:, None]).reshape(-1)
    n = 1
    for d in z.shape:
        n *= d
    return flat[:n].reshape(z.shape).to(dtype)


def wire_bytes_dense(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tr.leaves(tree))


def wire_bytes_int8(tree, block: int = 256) -> int:
    return sum(x.numel() + -(-x.numel() // block) * 4
               for x in tr.leaves(tree))
