"""Step factories, the port of the reference's ``launch/steps.py``: the
training step (loss, gradients over microbatches, AdamW), and thin
prefill and decode steps. The port has no mesh: every step runs on the
parameters' device.
"""
from __future__ import annotations

import torch

from repro_torch.models.lm import LM
from repro_torch.nn.config import ModelConfig
from repro_torch.train import tree as tr
from repro_torch.train.optim import AdamWConfig, adamw_update


def value_and_grad(lm: LM, params, batch: dict, remat: str = "none"):
    """``(loss, grads)`` of ``lm.loss_and_aux`` at ``params`` (a tree of
    tensors that require no grad), the gradients a tree of the
    parameters' shapes and dtypes; a leaf the loss does not reach (a
    sigmoid router's bias, an unused frontend) gets zeros, as under
    ``jax.grad``."""
    flat, treedef = tr.flatten(params)
    xs = [p.detach().requires_grad_() for p in flat]
    loss, _ = lm.loss_and_aux(tr.unflatten(treedef, xs), batch, remat=remat)
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(xs, grads)]
    return loss.detach(), tr.unflatten(treedef, grads)


def split_mb(batch: dict, microbatches: int) -> list[dict]:
    """The reference's microbatch split: each leaf's batch dim (dim 1 of
    (3, B, S) M-RoPE positions) cut into ``microbatches`` equal runs."""
    def cut(key, t):
        dim = 1 if key == "positions" and t.ndim == 3 else 0
        if t.shape[dim] % microbatches:
            raise ValueError(f"{key}: batch {t.shape[dim]} does not split "
                             f"into {microbatches} microbatches")
        return torch.chunk(t, microbatches, dim=dim)

    parts = {k: cut(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(microbatches)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    remat: str = "dots", microbatches: int = 1,
                    accum_dtype=torch.float32, donate: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with gradient accumulation over ``microbatches``: the
    gradients summed in ``accum_dtype`` and divided by the count, the loss
    the microbatches' mean. ``donate`` updates ``params`` and
    ``opt_state`` in place (``adamw_update(in_place=True)``), as the
    reference's trainer donates them to its jitted step; otherwise the step
    is pure."""
    lm = LM(cfg)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(lm, params, batch, remat)
        else:
            acc = tr.tree_map(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32)
            for mb in split_mb(batch, microbatches):
                l_mb, g = value_and_grad(lm, params, mb, remat)
                for a, x in zip(tr.leaves(acc), tr.leaves(g)):
                    a.add_(x.to(a.dtype))
                del g  # before the next microbatch's backward
                loss = loss.to(l_mb.device) + l_mb.float()
            for a in tr.leaves(acc):
                a.div_(microbatches)
            grads, loss = acc, loss / microbatches
        new_params, new_state, metrics = adamw_update(
            opt_cfg, params, grads, opt_state, in_place=donate)
        return new_params, new_state, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    lm = LM(cfg)

    def prefill_step(params, batch: dict):
        return lm.prefill(params, batch["tokens"],
                          **{k: v for k, v in batch.items()
                             if k != "tokens"})

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    lm = LM(cfg)

    def serve_step(params, tokens, caches, pos):
        return lm.decode(params, tokens, caches, pos)

    return serve_step
