"""Mixture-of-Experts channel mixer on one device, mirroring the
reference's ``nn/moe.py`` on its ``use_ep=False`` path (no mesh, or a
model axis of 1): one token group, every expert local.

* Routing in fp32: a softmax router takes the top-k of the probabilities;
  a sigmoid router (DeepSeek-V3) adds ``router_bias`` to the scores before
  the top-k and weights by the raw scores; ``router_scale`` renormalises
  the k weights. Ties go to the lower expert index, as ``jax.lax.top_k``
  breaks them (a stable descending sort).
* Capacity: ``C = max(1, round(T·k/E · capacity_factor))`` slots per
  expert; the dispatch plan is the reference's (a stable argsort of the
  expert choices), so the same (token, choice) pairs overflow and drop
  (zero combine weight) — GShard/Switch semantics.
* The expert FFNs are one batched SwiGLU product over (E, C, D), a plain
  matrix product that the reference also leaves outside Pallas; shared
  experts are a dense ``basic.ffn``.

The Switch-style load-balance ``aux`` loss is computed and returned; the
serving path ignores it, as the reference's prefill and decode do.
Expert parallelism over several GPUs (the reference's ``_moe_shardmap``)
needs a multi-GPU cell and is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.basic import ffn, ffn_specs
from repro_torch.nn.config import MoEConfig
from repro_torch.nn.param import ParamSpec


def moe_specs(cfg: MoEConfig, d_model: int, dtype) -> dict:
    e, f = cfg.n_experts, cfg.d_ff_expert
    out = {
        "router": ParamSpec((d_model, e), torch.float32, scale=0.02),
        "w_gate": ParamSpec((e, d_model, f), dtype),
        "w_up": ParamSpec((e, d_model, f), dtype),
        "w_down": ParamSpec((e, f, d_model), dtype),
    }
    if cfg.router_fn == "sigmoid":
        # deepseek-v3 aux-loss-free balancing bias (updated out-of-band)
        out["router_bias"] = ParamSpec((e,), torch.float32, init="zeros")
    if cfg.n_shared:
        d_sh = cfg.d_ff_shared or cfg.d_ff_expert * cfg.n_shared
        out["shared"] = ffn_specs(d_model, d_sh, dtype, act="swiglu")
    return out


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: values descending, the lower
    index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, cfg: MoEConfig, x: torch.Tensor):
    """x: (G, Tg, D) -> weights (G, Tg, K) fp32, idx (G, Tg, K) int64,
    aux scalar."""
    logits = torch.einsum("gtd,de->gte", x.float(), p["router"])
    if cfg.router_fn == "sigmoid":
        scores = torch.sigmoid(logits)
        _, idx = _top_k(scores + p["router_bias"], cfg.top_k)
        w = torch.gather(scores, -1, idx)
    else:
        w, idx = _top_k(torch.softmax(logits, dim=-1), cfg.top_k)
    if cfg.router_scale:
        w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balance aux loss: E * sum_e f_e * p_e
    probs_mean = torch.mean(torch.softmax(logits, dim=-1), dim=(0, 1))
    counts = torch.bincount(idx.reshape(-1),
                            minlength=cfg.n_experts).float()
    frac = counts / (idx.numel() + 1e-9)
    aux = cfg.n_experts * torch.sum(frac * probs_mean) * cfg.aux_loss_coef
    return w, idx, aux


def _dispatch_indices_1g(top_k: int, n_experts: int, capacity: int,
                         idx: torch.Tensor):
    """Per-group dispatch plan. idx: (Tg, K) expert choices.

    Returns:
      slot_src: (E*C,) source-token index per slot (Tg = dummy/empty)
      tok_slot: (Tg, K) slot id per (token, choice) (E*C = dropped)
    """
    t, k = idx.shape
    e, cap = n_experts, capacity
    dev = idx.device
    flat_e = idx.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    tok_sorted = flat_tok[order]
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=dev) - starts[e_sorted]
    keep = rank < cap
    slot = torch.where(keep, e_sorted * cap + rank, e * cap)
    slot_src = torch.full((e * cap + 1,), t, dtype=torch.long, device=dev)
    slot_src[slot] = torch.where(keep, tok_sorted, t)
    tok_slot = torch.full((t * k,), e * cap, dtype=torch.long, device=dev)
    tok_slot[order] = slot
    return slot_src[:-1], tok_slot.reshape(t, k)


def _expert_ffn(pw, xe: torch.Tensor) -> torch.Tensor:
    """xe: (G, E, C, D) -> through each expert's SwiGLU."""
    h = torch.einsum("gecd,edf->gecf", xe, pw["w_gate"])
    u = torch.einsum("gecd,edf->gecf", xe, pw["w_up"])
    h = F.silu(h.float()).to(xe.dtype) * u
    return torch.einsum("gecf,efd->gecd", h, pw["w_down"])


def _moe_body(pw, cfg: MoEConfig, xg, w, slot_src, tok_slot, cap):
    """Every expert on this device: gather each slot's token, run the
    experts, and combine each token's k outputs by its weights."""
    g, t, d = xg.shape
    span = cfg.n_experts * cap
    x_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    xe = torch.gather(x_pad, 1, slot_src[..., None].expand(g, span, d))
    ye = _expert_ffn(pw, xe.reshape(g, cfg.n_experts, cap, d))
    y_pad = torch.cat([ye.reshape(g, span, d), ye.new_zeros((g, 1, d))],
                      dim=1)
    flat_slot = tok_slot.reshape(g, t * cfg.top_k)
    contrib = torch.gather(y_pad, 1, flat_slot[..., None].expand(
        g, t * cfg.top_k, d)).reshape(g, t, cfg.top_k, d)
    kept = (flat_slot < span).reshape(g, t, cfg.top_k)
    wk = torch.where(kept, w.float(), 0.0).to(xg.dtype)
    return torch.einsum("gtkd,gtk->gtd", contrib, wk)


def moe_plan(p, cfg: MoEConfig, x: torch.Tensor):
    """Routing and dispatch of x (B, S, D) as one group: ``(xg, w, idx,
    aux, slot_src (1, E*C), tok_slot (1, T, K), cap)``. A (token, choice)
    pair dropped for capacity has ``tok_slot == E*C``."""
    b, s, d = x.shape
    xg = x.reshape(1, b * s, d)
    w, idx, aux = _route(p, cfg, xg)
    cap = int(max(1, round(b * s * cfg.top_k / cfg.n_experts
                           * cfg.capacity_factor)))
    slot_src, tok_slot = _dispatch_indices_1g(cfg.top_k, cfg.n_experts,
                                              cap, idx[0])
    return xg, w, idx, aux, slot_src[None], tok_slot[None], cap


def moe_apply(p, cfg: MoEConfig, x: torch.Tensor):
    """x: (B, S, D) -> (out, aux_loss)."""
    xg, w, _, aux, slot_src, tok_slot, cap = moe_plan(p, cfg, x)
    pw = {"w_gate": p["w_gate"], "w_up": p["w_up"], "w_down": p["w_down"]}
    out = _moe_body(pw, cfg, xg, w, slot_src, tok_slot, cap).reshape(x.shape)
    if cfg.n_shared:
        out = out + ffn(p["shared"], x, act="swiglu")
    return out, aux
