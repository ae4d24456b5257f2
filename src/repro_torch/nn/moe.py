"""Mixture-of-Experts channel mixer, mirroring the reference's
``nn/moe.py``: without a mesh one token group, every expert local.

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
On a device mesh (``ctx``) the routing and the experts are ``local_map``
bodies, with the reference's expert parallelism over the model axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.basic import f32, ffn, ffn_specs
from repro_torch.nn.config import MoEConfig
from repro_torch.nn.param import ParamSpec
from repro_torch.nn.sharding import NO_MESH, psum


def moe_specs(cfg: MoEConfig, d_model: int, dtype) -> dict:
    e, f = cfg.n_experts, cfg.d_ff_expert
    out = {
        "router": ParamSpec((d_model, e), torch.float32, scale=0.02,
                            axes=(None, None)),
        "w_gate": ParamSpec((e, d_model, f), dtype,
                            axes=("expert", "fsdp", None)),
        "w_up": ParamSpec((e, d_model, f), dtype,
                          axes=("expert", "fsdp", None)),
        "w_down": ParamSpec((e, f, d_model), dtype,
                            axes=("expert", None, "fsdp")),
    }
    if cfg.router_fn == "sigmoid":
        # deepseek-v3 aux-loss-free balancing bias (updated out-of-band)
        out["router_bias"] = ParamSpec((e,), torch.float32, init="zeros",
                                       axes=(None,))
    if cfg.n_shared:
        d_sh = cfg.d_ff_shared or cfg.d_ff_expert * cfg.n_shared
        out["shared"] = ffn_specs(d_model, d_sh, dtype, act="swiglu")
    return out


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: values descending, the lower
    index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, cfg: MoEConfig, x: torch.Tensor, groups=(),
           n_tok: int | None = None):
    """x: (G, Tg, D) -> weights (G, Tg, K) fp32, idx (G, Tg, K) int64,
    aux scalar. With ``groups`` x is a rank's share of ``n_tok`` tokens
    and the load-balance statistics are summed over those process groups
    first, so that aux is the whole batch's."""
    logits = torch.einsum("gtd,de->gte", f32(x), p["router"])
    if cfg.router_fn == "sigmoid":
        scores = torch.sigmoid(logits)
        _, idx = _top_k(scores + p["router_bias"], cfg.top_k)
        w = torch.gather(scores, -1, idx)
    else:
        w, idx = _top_k(torch.softmax(logits, dim=-1), cfg.top_k)
    if cfg.router_scale:
        w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balance aux loss: E * sum_e f_e * p_e
    probs = torch.softmax(logits, dim=-1)
    counts = _counts(idx.reshape(-1), cfg.n_experts).to(logits.dtype)
    if groups:
        probs_mean = psum(probs.sum(dim=(0, 1)), groups) / n_tok
        counts = psum(counts, groups)
        frac = counts / (n_tok * cfg.top_k + 1e-9)
    else:
        probs_mean = torch.mean(probs, dim=(0, 1))
        frac = counts / (idx.numel() + 1e-9)
    aux = cfg.n_experts * torch.sum(frac * probs_mean) * cfg.aux_loss_coef
    return w, idx, aux


def _counts(flat: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(flat, minlength=n)`` for values below ``n``, with
    a shape that does not depend on the values (the dry run's fake
    tensors hold none)."""
    return torch.zeros(n, dtype=torch.long, device=flat.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.long))


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
    counts = _counts(flat_e, e)
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
    h = F.silu(f32(h)).to(xe.dtype) * u
    return torch.einsum("gecf,efd->gecd", h, pw["w_down"])


def _moe_body(pw, cfg: MoEConfig, xg, w, slot_src, tok_slot, cap,
              e_lo: int = 0, e_local: int | None = None):
    """Experts ``e_lo..e_lo + e_local`` (all by default) on this device:
    gather each of their slots' token, run the experts, and combine each
    token's outputs from them by its weights (a token's other choices add
    nothing here)."""
    g, t, d = xg.shape
    e_local = cfg.n_experts if e_local is None else e_local
    lo, span = e_lo * cap, e_local * cap
    src = slot_src[:, lo:lo + span]
    x_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    xe = torch.gather(x_pad, 1, src[..., None].expand(g, span, d))
    ye = _expert_ffn(pw, xe.reshape(g, e_local, cap, d))
    y_pad = torch.cat([ye.reshape(g, span, d), ye.new_zeros((g, 1, d))],
                      dim=1)
    flat_slot = tok_slot.reshape(g, t * cfg.top_k)
    kept = (flat_slot >= lo) & (flat_slot < lo + span)
    loc_slot = torch.where(kept, flat_slot - lo, span)
    contrib = torch.gather(y_pad, 1, loc_slot[..., None].expand(
        g, t * cfg.top_k, d)).reshape(g, t, cfg.top_k, d)
    wk = torch.where(kept.reshape(g, t, cfg.top_k), f32(w),
                     0.0).to(xg.dtype)
    return torch.einsum("gtkd,gtk->gtd", contrib, wk)


def moe_plan(p, cfg: MoEConfig, x: torch.Tensor):
    """Routing and dispatch of x (B, S, D) as one group: ``(xg, w, idx,
    aux, slot_src (1, E*C), tok_slot (1, T, K), cap)``. A (token, choice)
    pair dropped for capacity has ``tok_slot == E*C``."""
    b, s, d = x.shape
    xg = x.reshape(1, b * s, d)
    w, idx, aux = _route(p, cfg, xg)
    cap = capacity(cfg, xg.shape[1])
    slot_src, tok_slot = _dispatch(cfg, cap, idx)
    return xg, w, idx, aux, slot_src, tok_slot, cap


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Slots per expert for a group of ``tokens`` tokens (a host int)."""
    return int(max(1, round(tokens * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))


def _dispatch(cfg: MoEConfig, cap: int, idx: torch.Tensor):
    """The per-group plans of idx (G, Tg, K), stacked."""
    plans = [_dispatch_indices_1g(cfg.top_k, cfg.n_experts, cap, i)
             for i in idx]
    return (torch.stack([pl[0] for pl in plans]),
            torch.stack([pl[1] for pl in plans]))


def moe_apply(p, cfg: MoEConfig, x: torch.Tensor, ctx=NO_MESH):
    """x: (B, S, D) -> (out, aux_loss).

    On a mesh, as the reference: tokens in dp-many groups (capacity per
    group), routed on each rank's groups (a ``local_map`` body, the
    load-balance statistics summed over dp); the experts split over the
    model axis when their count divides it (``use_ep``, the reference's
    ``_moe_shardmap``: each rank's experts on its groups, the partial
    outputs summed over the model axis), else every expert on every
    rank."""
    pw = {"w_gate": p["w_gate"], "w_up": p["w_up"], "w_down": p["w_down"]}
    if ctx.mesh is None:
        xg, w, _, aux, slot_src, tok_slot, cap = moe_plan(p, cfg, x)
        out = _moe_body(pw, cfg, xg, w, slot_src, tok_slot, cap)
        out = out.reshape(x.shape)
    else:
        out, aux = _moe_mesh(ctx, p, pw, cfg, x)
    if cfg.n_shared:
        out = out + ffn(p["shared"], x, act="swiglu", ctx=ctx)
    return ctx.constrain(out, "dp", None, None), aux


def _moe_mesh(ctx, p, pw, cfg: MoEConfig, x: torch.Tensor):
    from torch.distributed.tensor import Partial, Shard

    b, s, d = x.shape
    dp = ctx.dp_size()
    n_groups = dp if (b * s) % dp == 0 else 1
    xg = ctx.constrain(x.reshape(n_groups, b * s // n_groups, d),
                       "dp", None, None)
    cap = capacity(cfg, xg.shape[1])
    gp = xg.placements
    split = [i for i, pl in enumerate(gp) if isinstance(pl, Shard)]
    names = list(ctx.mesh.mesh_dim_names)
    dp_groups = ctx.groups([names[i] for i in split])
    part = tuple(Partial() if i in split else pl
                 for i, pl in enumerate(ctx.rep()))
    n_tok = xg.shape[0] * xg.shape[1]
    bias = p.get("router_bias")

    def route(xg_l, router, bias_l):
        pr = {"router": router}
        if bias_l is not None:
            pr["router_bias"] = bias_l
        w, idx, stats = _route(pr, cfg, xg_l, dp_groups, n_tok)
        slot_src, tok_slot = _dispatch(cfg, cap, idx)
        return w, slot_src, tok_slot, stats

    bias_pl = ctx.rep() if bias is not None else None
    w, slot_src, tok_slot, aux = ctx.region(
        route, (gp, gp, gp, ctx.rep()), (gp, ctx.rep(), bias_pl),
        (gp, part, bias_pl and part), xg, p["router"], bias)

    tp = ctx.tp_size()
    e = cfg.n_experts
    model = ctx.axes_of("model")
    if tp > 1 and e % tp == 0:          # expert parallelism
        e_local = e // tp
        e_lo = ctx.coord(model[0]) * e_local
        w_pl = ctx.with_dims(ctx.rep(), model, Shard(0))
        w_grad = ctx.with_dims(part, model, Shard(0))
        act_grad = ctx.with_dims(gp, model, Partial())
        tp_groups = ctx.groups(model)
    else:
        e_lo, e_local = 0, e
        w_pl, w_grad, act_grad, tp_groups = ctx.rep(), part, gp, []

    def experts(xg_l, w_l, src_l, slot_l, wg, wu, wd):
        out = _moe_body({"w_gate": wg, "w_up": wu, "w_down": wd}, cfg,
                        xg_l, w_l, src_l, slot_l, cap, e_lo, e_local)
        return psum(out, tp_groups)

    out = ctx.region(experts, gp, (gp, gp, gp, gp, w_pl, w_pl, w_pl),
                     (act_grad, act_grad, None, None, w_grad, w_grad,
                      w_grad),
                     xg, w, slot_src, tok_slot, pw["w_gate"], pw["w_up"],
                     pw["w_down"])
    if 1 < b < n_groups:
        # a row's tokens lie in groups of several ranks (a batch of fewer
        # rows than data ranks): back to x's placements before the rows
        # are whole again, as XLA reshards the reference's reshape
        out = out.redistribute(ctx.mesh, x.placements)
    return out.reshape(b, s, d), aux
