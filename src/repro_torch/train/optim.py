"""Optimizers (pure torch, no torch.optim), the port of the reference's
``train/optim.py``: AdamW with its state in fp32 or bf16, cosine / linear
/ constant learning-rate schedules, global-norm clipping.

Parameters are a tree (``train.tree``: dicts and lists) of tensors. The
update math is fp32 whatever the parameters' and the state's dtypes, as
the reference's; norms and biases (tensors below 2-D) take no weight
decay. :func:`adamw_update` returns new trees and leaves its inputs as
they were, so that a step is a pure function as in the reference; with
``in_place=True`` it writes the new values into the parameters' and
state's own tensors instead, which is what the reference's training
trainer gets from ``jax.jit(..., donate_argnums=(0, 1))``: one copy of the
parameters and the state, not two, at the step's peak.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.train import tree as tr

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # float32 | bfloat16
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | linear | const
    min_lr_frac: float = 0.1


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), in fp32."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        decay = _f32(1.0)
    else:
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
                1 + torch.cos(torch.pi * t))
        else:
            decay = 1.0 - (1 - cfg.min_lr_frac) * t
    return cfg.lr * warm * decay


def init_state(cfg: AdamWConfig, params) -> dict:
    """``{"step": int32 0, "m": zeros, "v": zeros}``, m and v in
    ``cfg.state_dtype`` on each parameter's device."""
    sdt = DTYPES[cfg.state_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device)
    dev = tr.leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tr.tree_map(zeros, params),
            "v": tr.tree_map(zeros, params)}


def state_specs(cfg: AdamWConfig, param_specs):
    """Spec tree of the optimizer state (m and v mirror the parameters'
    shapes and sharding axes, in ``cfg.state_dtype``)."""
    import dataclasses as dc

    from repro_torch.nn.param import ParamSpec, map_specs

    sdt = DTYPES[cfg.state_dtype]
    mk = lambda s: dc.replace(s, dtype=sdt, init="zeros")
    return {"step": ParamSpec((), torch.int32, init="zeros", axes=()),
            "m": map_specs(mk, param_specs),
            "v": map_specs(mk, param_specs)}


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tr.leaves(grads)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to a global norm of at most max_norm, the norm)``;
    each leaf keeps its dtype."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tr.tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def adamw_update(cfg: AdamWConfig, params, grads, state, *,
                 in_place: bool = False):
    """Returns ``(new_params, new_state, metrics)``: one AdamW step,
    clipped to ``cfg.grad_clip``. ``in_place`` writes the results into
    ``params`` and ``state`` (and returns them)."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    # clip_by_global_norm leaf by leaf, so that no clipped copy of every
    # gradient is held at once
    clip = None
    if cfg.grad_clip:
        gnorm = global_norm(grads)
        clip = _clip_scale(gnorm, cfg.grad_clip)
    else:
        gnorm = torch.zeros((), dtype=torch.float32)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(_f32(b1, step.device), step.float())
    bc2 = 1 - torch.pow(_f32(b2, step.device), step.float())

    def upd(p, g, m, v):
        if clip is not None:
            g = (g.float() * clip).to(g.dtype)
        gf = g.float()
        m32 = m.float() * b1 + gf * (1 - b1)
        v32 = v.float() * b2 + torch.square(gf) * (1 - b2)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if cfg.weight_decay and p.ndim >= 2:  # no decay on norms/biases
            delta = delta + cfg.weight_decay * p.float()
        newp = (p.float() - lr * delta).to(p.dtype)
        if in_place:
            p.copy_(newp)
            m.copy_(m32)
            v.copy_(v32)
            return p, m, v
        return newp, m32.to(m.dtype), v32.to(v.dtype)

    flat_p, treedef = tr.flatten(params)
    flat_g = tr.leaves(grads)
    flat_m, flat_v = tr.leaves(state["m"]), tr.leaves(state["v"])
    out = [upd(*x) for x in zip(flat_p, flat_g, flat_m, flat_v, strict=True)]
    new_state = {"step": step,
                 "m": tr.unflatten(treedef, [o[1] for o in out]),
                 "v": tr.unflatten(treedef, [o[2] for o in out])}
    if in_place:
        state["step"].copy_(step)
        new_state = state
    return (tr.unflatten(treedef, [o[0] for o in out]), new_state,
            {"lr": lr, "grad_norm": gnorm})
