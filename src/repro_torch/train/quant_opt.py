"""8-bit AdamW states (block-wise absmax int8 m and v), the port of the
reference's ``train/quant_opt.py``: fp32 m and v cost 8 bytes a parameter,
int8 values and fp32 block scales about 2.06.

State layout per tensor: a :class:`~repro_torch.train.compression.
Quantized` (int8 blocks, fp32 scales). The update dequantises, applies the
exact AdamW math in fp32 and quantises again (bnb-style 8-bit Adam,
block 256).
"""
from __future__ import annotations

import torch

from repro_torch.train import tree as tr
from repro_torch.train.compression import (Quantized, int8_dequantize,
                                           int8_quantize)
from repro_torch.train.optim import AdamWConfig, clip_by_global_norm, lr_at


def init_state8(params, block: int = 256) -> dict:
    def zq(p):
        nblk = -(-p.numel() // block)
        return Quantized(
            q=torch.zeros((nblk, block), dtype=torch.int8, device=p.device),
            scale=torch.zeros((nblk,), dtype=torch.float32, device=p.device),
            shape=tuple(p.shape))

    dev = tr.leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tr.tree_map(zq, params), "v": tr.tree_map(zq, params),
            "block": block}


def state8_bytes(params, block: int = 256) -> int:
    total = 0
    for p in tr.leaves(params):
        nblk = -(-p.numel() // block)
        total += 2 * (nblk * block + nblk * 4)  # m and v
    return total


def adamw8_update(cfg: AdamWConfig, params, grads, state):
    """Returns ``(new_params, new_state, metrics)``: exact AdamW in fp32
    with int8 state storage."""
    block = state["block"]
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    if cfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = torch.zeros((), dtype=torch.float32)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(torch.tensor(b1, device=step.device), step.float())
    bc2 = 1 - torch.pow(torch.tensor(b2, device=step.device), step.float())

    def upd(p, g, mq, vq):
        gf = g.float()
        m32 = int8_dequantize(mq) * b1 + gf * (1 - b1)
        v32 = int8_dequantize(vq) * b2 + torch.square(gf) * (1 - b2)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if cfg.weight_decay and p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        newp = (p.float() - lr * delta).to(p.dtype)
        return newp, int8_quantize(m32, block), int8_quantize(v32, block)

    flat_p, treedef = tr.flatten(params)
    out = [upd(*x) for x in zip(flat_p, tr.leaves(grads),
                                tr.leaves(state["m"]),
                                tr.leaves(state["v"]), strict=True)]
    new_state = {"step": step,
                 "m": tr.unflatten(treedef, [o[1] for o in out]),
                 "v": tr.unflatten(treedef, [o[2] for o in out]),
                 "block": block}
    return (tr.unflatten(treedef, [o[0] for o in out]), new_state,
            {"lr": lr, "grad_norm": gnorm})
