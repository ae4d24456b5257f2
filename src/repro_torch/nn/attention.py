"""Grouped-query attention (full and sliding-window) and DeepSeek's
multi-head latent attention (MLA), mirroring the reference's
``nn/attention.py``, with the two attention kernels as GQA's attention on
every path:

* cache-less (train/prefill): kernel 6 through ``nn/flash.flash_attention``
  (causal, the layer's window) at every length, where the reference takes
  its masked ``_sdpa`` up to 512 tokens and ``nn/flash.sdpa_flash`` above;
  with grad mode on it is differentiable (its backward is the reference's
  ``_flash_bwd``), without it is ``flash_attention_fwd`` itself;
* decode: the new token's K/V are written into the cache in place at
  ``cache_pos`` (``cache_pos % S`` in a sliding-window layer's ring
  buffer), then ``kernels/decode_attention.decode_attention`` attends over
  rows ``0..min(cache_pos, S-1)``. That one bound is the reference's decode
  mask in both layouts: ``kj <= cache_pos`` (full), and the ring's
  ``(kj <= cache_pos % S) | (cache_pos >= S)`` (window).

Cache layout, the reference's: ``{"k": (B, S_cache, KV, Dh), "v": ...}``,
with int8 values plus fp16 per-(token, head) absmax scales (``k_scale``,
``v_scale``) for the quantised KV cache, which decode dequantises before
the kernel. Unlike the reference, which returns a new cache, decode
updates the cache tensors in place (the batcher keeps one cache for its
whole life, so no copy of it is made per step) and returns the same dict.

MLA (:func:`mla_apply`) keeps the reference's two forms. Prefill expands
per-head keys and values from the latent, folds the shared rope key into
a (nope + rope)-wide q/k, pads v to that width with zeros and runs kernel
6 at that head dim (192 for DeepSeek-V2/V3) at every length; the reference
takes this path above 512 tokens and explicit scores below. Decode is the
weight-absorbed form over the latent cache ``{"latent": (B, S, kv_lora),
"k_rope": (B, S, qk_rope)}``, in plain einsums as in the reference (which
has no kernel there either), written in place like the GQA cache.

Cross-attention (an encoder-decoder's decoder layers) is
:func:`gqa_apply` with ``kv_override``, the encoder's K/V from
:func:`cross_kv`, and q without rope (the layer's config has
``rope_kind="none"``), every query row over every encoder row as in the
reference's all-true mask: kernel 6 without the causal mask in a prefill
(Sq decoder tokens, Sk encoder rows), kernel 7 at ``pos = Sk - 1`` over
the cached cross K/V in a decode step.

On a device mesh (``ctx``) the kernels run inside ``local_map`` bodies on
each rank's heads (:func:`attend`) or cache rows (:func:`decode_attend`).
On ``meta`` tensors (the dry run) the kernels' ops return their outputs'
shapes alone.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.nn.basic import (COL, ROW, apply_rope, f32, f32_dtype,
                                  rmsnorm, rmsnorm_specs)
from repro_torch.nn.config import AttnConfig
from repro_torch.nn.flash import flash_attention
from repro_torch.nn.param import ParamSpec
from repro_torch.nn.sharding import NO_MESH, pmax, psum

NEG = -1.0e30   # the reference's masked score


def gqa_specs(cfg: AttnConfig, d_model: int, dtype) -> dict:
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {"wq": ParamSpec((d_model, h * dh), dtype, axes=COL),
           "wk": ParamSpec((d_model, kv * dh), dtype, axes=COL),
           "wv": ParamSpec((d_model, kv * dh), dtype, axes=COL),
           "wo": ParamSpec((h * dh, d_model), dtype, axes=ROW)}
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            out[name] = ParamSpec((n * dh,), torch.float32, init="zeros",
                                  axes=("model",))
    return out


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    return _whole_heads(x, n).reshape(*x.shape[:-1], n, dh)


def _whole_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """A DTensor whose last dim (``n`` heads) is split over mesh dims that
    do not divide the head count (28 heads over 8 ranks) gathered whole
    there first: a head is never cut between ranks. Anything else as it
    is."""
    pl = getattr(x, "placements", None)
    if pl is None:
        return x
    from torch.distributed.tensor import Replicate, Shard

    last = x.ndim - 1
    split = [i for i, p in enumerate(pl) if p == Shard(last)]
    ways = 1
    for i in split:
        ways *= x.device_mesh.size(i)
    if n % ways == 0:
        return x
    return x.redistribute(x.device_mesh, [Replicate() if i in split else p
                                          for i, p in enumerate(pl)])


def project_qkv(p, cfg: AttnConfig, x: torch.Tensor,
                positions: torch.Tensor, ctx=NO_MESH):
    """q (B, S, H, Dh), k and v (B, S, KV, Dh), rope applied: the inputs
    of the layer's attention kernel."""
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = ctx.constrain(q, "dp", None, "model")
    q = _split_heads(q, cfg.n_heads, cfg.head_dim)
    k = _split_heads(k, cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(v, cfg.n_kv_heads, cfg.head_dim)
    if cfg.rope_kind != "none":
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    return q, k, v


def _cross_attention(p, cfg: AttnConfig, x: torch.Tensor,
                     positions: torch.Tensor, kv_override, decode: bool,
                     ctx=NO_MESH):
    """Attention of x's queries over precomputed K/V (B, Sk, KV, Dh), every
    row over all of them (the reference's ``kv_override`` branch)."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, sq, _ = x.shape
    k, v = kv_override
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
    q = _split_heads(ctx.constrain(q, "dp", None, "model"), h, dh)
    if cfg.rope_kind != "none":
        q = apply_rope(cfg, q, positions)
    scale = 1.0 / math.sqrt(dh)
    if decode:
        if sq != 1:
            raise ValueError(f"decode takes one token per row, got {sq}")
        if k.shape[1] < 1:
            raise ValueError("cross-attention over an empty encoder cache")
        return decode_attend(ctx, q, {"k": k, "v": v}, None, None,
                             k.shape[1] - 1, k.shape[1] - 1, scale)
    return attend(ctx, q, k, v, scale, causal=False)


def gqa_apply(p, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
              cache: Optional[dict] = None, cache_pos: Optional[int] = None,
              kv_override=None, ctx=NO_MESH):
    """Returns ``(out, cache)``.

    * train / prefill: ``cache`` None -> causal self-attention over x; the
      returned cache is this call's ``{"k", "v"}``.
    * decode: ``cache`` given, x is (B, 1, D), ``cache_pos`` (a host int)
      the write index; the cache is updated in place and returned.
    * cross-attention: ``kv_override=(k, v)`` precomputed from the
      encoder (:func:`cross_kv`); a decode step when ``cache_pos`` is
      given. Returns ``cache`` as it came.
    """
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, sq, _ = x.shape
    if kv_override is not None:
        out = _cross_attention(p, cfg, x, positions, kv_override,
                               cache_pos is not None, ctx)
        return _out_proj(ctx, out.reshape(b, sq, h * dh), p["wo"]), cache
    scale = 1.0 / math.sqrt(dh)
    q, k, v = project_qkv(p, cfg, x, positions, ctx)
    if cache is None:
        out = attend(ctx, q, k, v, scale, causal=True, window=cfg.window)
        new_cache = {"k": k, "v": v}
    else:
        if sq != 1:
            raise ValueError(f"decode takes one token per row, got {sq}")
        s_cache = cache["k"].shape[1]
        write = cache_pos % s_cache if cfg.window is not None else cache_pos
        out = decode_attend(ctx, q, cache, k, v, write,
                            min(int(cache_pos), s_cache - 1), scale)
        new_cache = cache
    return _out_proj(ctx, out.reshape(b, sq, h * dh), p["wo"]), new_cache


def _out_proj(ctx, out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The heads' output through ``wo``, between the reference's two
    constraints (heads over the model axis, then the row-parallel sum)."""
    out = ctx.constrain(out, "dp", None, "model")
    return ctx.constrain(out @ wo, "dp", None, None)


def attend(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scale: float, causal: bool = True, window=None) -> torch.Tensor:
    """Kernel 6 (``nn/flash.flash_attention``) on q (B, Sq, H, Dh) over
    k/v (B, Sk, KV, Dh) -> (B, Sq, H, Dh). On a mesh it is a ``local_map``
    body over the heads: batch over dp, q's heads over the model axis when
    they divide it, k/v's too when theirs do, else whole on every rank
    with each rank taking the K/V heads its query heads group onto (their
    gradient then a sum over the model axis). The body calls the kernel on
    each rank's local q/k/v."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    if ctx.mesh is None:
        out = flash_attention(q.view(b, sq, kvh, h // kvh, dh), k, v, scale,
                              causal=causal, window=window)
        return out.reshape(b, sq, h, dh)
    from torch.distributed.tensor import Partial, Shard

    tp = ctx.tp_size()
    model = ctx.axes_of("model")
    q_heads = tp > 1 and h % tp == 0
    kv_heads = q_heads and kvh % tp == 0
    bp = ctx.placements(("dp",), (b,))
    q_pl = ctx.with_dims(bp, model, Shard(2)) if q_heads else bp
    kv_pl = ctx.with_dims(bp, model, Shard(2)) if kv_heads else bp
    kv_grad = ctx.with_dims(bp, model, Partial()) \
        if q_heads and not kv_heads else kv_pl
    g = h // kvh
    h0 = ctx.coord(model[0]) * (h // tp) if q_heads else 0

    def body(q_l, k_l, v_l):
        bl, _, hl, _ = q_l.shape
        if not kv_heads:
            lo, hi = h0 // g, (h0 + hl - 1) // g + 1
            k_l, v_l = k_l[:, :, lo:hi], v_l[:, :, lo:hi]
        nk = k_l.shape[2]
        out = flash_attention(q_l.reshape(bl, sq, nk, hl // nk, dh), k_l,
                              v_l, scale, causal=causal, window=window)
        return out.reshape(bl, sq, hl, dh)

    return ctx.region(body, q_pl, (q_pl, kv_pl, kv_pl),
                      (q_pl, kv_grad, kv_grad), q, k, v)


def decode_attend(ctx, q: torch.Tensor, cache: dict, k_new, v_new,
                  write: int, bound: int, scale: float) -> torch.Tensor:
    """One token's GQA attention (q (B, 1, H, Dh)) over a K/V cache (B, S,
    KV, Dh), rows ``0..bound`` valid, after writing ``k_new``/``v_new`` (B,
    1, KV, Dh; None: no write) at row ``write`` (int8 caches quantised):
    kernel 7 on the cache. On a mesh it is a ``local_map`` body on each
    rank's shard of the cache, written in place, with kernel 7 on each
    rank's rows: where the sequence is split (the reference's
    "kv_seq"/"seq" axes) the kernel also returns its rows' log-sum-exp,
    and the ranks that split the sequence merge their outputs by it
    (flash-decoding's combine: the max of the lse, then the sums of the
    rescaled outputs and weights). Returns (B, KV, G, Dh)."""
    names = [n for n in ("k", "v", "k_scale", "v_scale") if n in cache]
    bufs = [cache[n] for n in names]
    if ctx.mesh is None:
        return _decode_local(q, bufs, k_new, v_new, write, bound, scale,
                             0, bufs[0].shape[1], [])
    bp = ctx.placements(("dp",), (q.shape[0],))
    groups, off, total = _seq_split(ctx, bufs[0])

    def body(q_l, k_l, v_l, *bufs_l):
        return _decode_local(q_l, list(bufs_l), k_l, v_l, write, bound,
                             scale, off, total, groups)

    new = (k_new, v_new) if k_new is not None else (None, None)
    new_pl = tuple(bp if t is not None else None for t in new)
    return ctx.region(body, bp, (bp, *new_pl, *(t.placements for t in bufs)),
                      None, q, *new, *bufs)


def _decode_local(q, bufs, k_new, v_new, write: int, bound: int,
                  scale: float, off: int, total: int,
                  groups) -> torch.Tensor:
    """:func:`decode_attend` on local tensors: rows ``off..`` of a cache
    of ``total`` rows in all, the softmax combined over ``groups`` when
    there are any."""
    b, _, h, dh = q.shape
    kvh = bufs[0].shape[2]
    if k_new is not None:
        if bufs[0].dtype == torch.int8:
            k8, ks = _kv_quantize(k_new)
            v8, vs = _kv_quantize(v_new)
            vals = (k8, v8, ks, vs)
        else:
            vals = (k_new, v_new)
        for buf, val in zip(bufs, vals):
            _dyn_write(buf, val, write, off, total)
    if bufs[0].dtype == torch.int8:
        kf = bufs[0].to(q.dtype) * bufs[2].to(q.dtype)[..., None]
        vf = bufs[1].to(q.dtype) * bufs[3].to(q.dtype)[..., None]
    else:
        kf, vf = bufs[0], bufs[1]
    qg = q.view(b, kvh, h // kvh, dh)
    if not groups:
        return decode_attention(qg, kf, vf, bound - off, scale=scale)
    if bound >= off:
        out, lse = decode_attention(qg, kf, vf, bound - off, scale=scale,
                                    return_lse=True)
    else:   # every row of this rank's shard lies past the bound
        out = torch.zeros_like(qg)
        lse = torch.full(qg.shape[:3], NEG, dtype=f32_dtype(q.dtype),
                         device=q.device)
    wt = torch.exp(lse - pmax(lse, groups))
    num = psum(f32(out) * wt[..., None], groups)
    return (num / psum(wt, groups)[..., None]).to(q.dtype)


def _dyn_write(buf: torch.Tensor, val: torch.Tensor, idx: int,
               off: int = 0, total: int | None = None) -> None:
    """``buf[:, idx:idx + len] = val`` in place, along the sequence axis,
    with ``lax.dynamic_update_slice``'s clamp of the start index. ``buf``
    may be the rows ``off..`` of a sequence of ``total`` rows (a rank's
    shard): then only the rows it holds are written."""
    n = val.shape[1]
    total = buf.shape[1] + off if total is None else total
    idx = max(0, min(int(idx), total - n)) - off
    lo, hi = max(idx, 0), min(idx + n, buf.shape[1])
    if lo < hi:
        buf[:, lo:hi] = val[:, lo - idx:hi - idx].to(buf.dtype)


def _kv_quantize(x: torch.Tensor):
    """x (B, S, KV, Dh) -> (int8 values, fp16 absmax scales (B, S, KV))."""
    xf = f32(x)
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def gqa_cache_specs(cfg: AttnConfig, batch: int, s_cache: int, dtype,
                    quant: bool = False) -> dict:
    if cfg.window is not None:
        s_cache = min(s_cache, cfg.window)
    shp = (batch, s_cache, cfg.n_kv_heads, cfg.head_dim)
    axes = cache_axes(batch, 4)
    if quant:
        return {"k": ParamSpec(shp, torch.int8, init="zeros", axes=axes),
                "v": ParamSpec(shp, torch.int8, init="zeros", axes=axes),
                "k_scale": ParamSpec(shp[:-1], torch.float16, init="zeros",
                                     axes=axes[:-1]),
                "v_scale": ParamSpec(shp[:-1], torch.float16, init="zeros",
                                     axes=axes[:-1])}
    return {"k": ParamSpec(shp, dtype, init="zeros", axes=axes),
            "v": ParamSpec(shp, dtype, init="zeros", axes=axes)}


def cache_axes(batch: int, ndim: int) -> tuple:
    """A K/V (or latent) cache's logical axes: batch over dp, the sequence
    over the model axis ("kv_seq"), or at batch 1 over the dp axes
    ("seq", long-context sequence sharding)."""
    return ("dp", "seq" if batch == 1 else "kv_seq") + (None,) * (ndim - 2)


# =================================================================== MLA


def mla_specs(cfg: AttnConfig, d_model: int, dtype) -> dict:
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lq, lkv = cfg.q_lora_rank, cfg.kv_lora_rank
    out = {}
    if lq:
        out["wq_a"] = ParamSpec((d_model, lq), dtype, axes=("fsdp", None))
        out["q_norm"] = rmsnorm_specs(lq)
        out["wq_b"] = ParamSpec((lq, h * (dn + dr)), dtype, axes=COL)
    else:
        out["wq"] = ParamSpec((d_model, h * (dn + dr)), dtype, axes=COL)
    out["wkv_a"] = ParamSpec((d_model, lkv + dr), dtype, axes=("fsdp", None))
    out["kv_norm"] = rmsnorm_specs(lkv)
    # up-projections: per-head K (nope) and V from the latent
    out["w_uk"] = ParamSpec((h, dn, lkv), dtype, axes=("model", None, None))
    out["w_uv"] = ParamSpec((h, lkv, dv), dtype, axes=("model", None, None))
    out["wo"] = ParamSpec((h * dv, d_model), dtype, axes=ROW)
    return out


def _mla_q(p, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
           eps: float, ctx=NO_MESH):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope), rope applied)."""
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    b, s, _ = x.shape
    if cfg.q_lora_rank:
        q = rmsnorm(p["q_norm"], x @ p["wq_a"], eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = _whole_heads(ctx.constrain(q, "dp", None, "model"), h)
    q = q.reshape(b, s, h, dn + dr)
    return q[..., :dn], apply_rope(cfg, q[..., dn:], positions)


def _mla_latent(p, cfg: AttnConfig, x: torch.Tensor,
                positions: torch.Tensor, eps: float, ctx=NO_MESH):
    """(q_nope, q_rope, latent (B, S, kv_lora), k_rope (B, S, rope): the
    rope key every head shares)."""
    lkv = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(p, cfg, x, positions, eps, ctx)
    kv = x @ p["wkv_a"]
    latent = rmsnorm(p["kv_norm"], kv[..., :lkv], eps)
    k_rope = apply_rope(cfg, kv[..., lkv:][:, :, None, :],
                        positions)[:, :, 0, :]
    return q_nope, q_rope, latent, k_rope


def mla_prefill_qkv(p, cfg: AttnConfig, x: torch.Tensor,
                    positions: torch.Tensor, eps: float = 1e-6,
                    ctx=NO_MESH):
    """The inputs of kernel 6 in MLA's prefill: q (B, S, H, 1, nope +
    rope), k and v (B, S, H, nope + rope). Per-head keys and values are
    expanded from the latent; the shared rope key is folded into every
    head's key and V padded with zeros, so that one (q.k, p.v) pipeline
    runs at Dh = nope + rope. Also returns the cache ``{"latent",
    "k_rope"}``."""
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    b, sq, _ = x.shape
    q_nope, q_rope, latent, k_rope = _mla_latent(p, cfg, x, positions, eps,
                                                 ctx)
    k_nope = torch.einsum("bsl,hdl->bshd", latent, p["w_uk"])
    v = torch.einsum("bsl,hlv->bshv", latent, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1).view(b, sq, h, 1, dn + dr)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, sq, h, dr)],
                  dim=-1)
    if dn + dr > dv:
        v = torch.cat([v, v.new_zeros((b, sq, h, dn + dr - dv))], dim=-1)
    return q, k, v, {"latent": latent, "k_rope": k_rope}


def mla_apply(p, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
              cache: Optional[dict] = None, cache_pos: Optional[int] = None,
              eps: float = 1e-6, ctx=NO_MESH):
    """Returns ``(out, cache)``, as :func:`gqa_apply`: prefill (``cache``
    None) returns this call's ``{"latent", "k_rope"}``; decode writes the
    token's latent and rope key at ``cache_pos`` in place and returns the
    same dict. On a mesh the decode is a ``local_map`` body on each rank's
    shard of the latent cache, its softmax combined across the ranks that
    split the sequence, as :func:`decode_attend`'s."""
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    b, sq, _ = x.shape
    scale = 1.0 / math.sqrt(dn + dr)

    if cache is None:
        q, k, v, new_cache = mla_prefill_qkv(p, cfg, x, positions, eps, ctx)
        # the zero padding of v takes a gradient that the slice drops
        out = attend(ctx, q.view(b, sq, h, dn + dr), k, v, scale,
                     causal=True)
        out = out.view(b, sq, h, dn + dr)[..., :dv]
    else:
        if sq != 1:
            raise ValueError(f"decode takes one token per row, got {sq}")
        q_nope, q_rope, latent, k_rope = _mla_latent(p, cfg, x, positions,
                                                     eps, ctx)
        args = (q_nope, q_rope, latent, k_rope, cache["latent"],
                cache["k_rope"], p["w_uk"], p["w_uv"])
        if ctx.mesh is None:
            out = _mla_decode_local(*args, cache_pos, scale, 0,
                                    cache["latent"].shape[1], [])
        else:
            out = _mla_decode_mesh(ctx, args, cache_pos, scale)
        new_cache = cache
    return _out_proj(ctx, out.reshape(b, sq, h * dv), p["wo"]), new_cache


def _seq_split(ctx, cache: torch.Tensor):
    """(process groups of the mesh dims that split a cache DTensor's
    sequence axis (dim 1), this rank's first row, the rows in all)."""
    from torch.distributed.tensor import Shard

    seq = [i for i, pl in enumerate(cache.placements)
           if pl == Shard(1) and ctx.mesh.size(i) > 1]
    names = list(ctx.mesh.mesh_dim_names)
    off, span = 0, cache.shape[1]
    for i in seq:
        span //= ctx.mesh.size(i)
        off += ctx.coord(names[i]) * span
    return ctx.groups([names[i] for i in seq]), off, cache.shape[1]


def _mla_decode_mesh(ctx, args, cache_pos: int, scale: float):
    bp = ctx.placements(("dp",), (args[4].shape[0],))
    groups, off, total = _seq_split(ctx, args[4])

    def body(*local):
        return _mla_decode_local(*local, cache_pos, scale, off, total,
                                 groups)

    in_pl = (bp,) * 4 + (args[4].placements, args[5].placements) \
        + (ctx.rep(),) * 2
    return ctx.region(body, bp, in_pl, None, *args)


def _mla_decode_local(q_nope, q_rope, latent, k_rope, cl, cr, w_uk, w_uv,
                      cache_pos: int, scale: float, off: int, total: int,
                      groups):
    """MLA's absorbed decode on local tensors: the token's latent and rope
    key written at ``cache_pos``, then its heads over rows ``off..`` of a
    latent cache of ``total`` rows, the softmax combined over ``groups``
    when there are any."""
    _dyn_write(cl, latent, cache_pos, off, total)
    _dyn_write(cr, k_rope, cache_pos, off, total)
    # absorbed: q' = q_nope . w_uk scores against the latent directly
    q_abs = torch.einsum("bqhd,hdl->bqhl", q_nope, w_uk)
    scores = (torch.einsum("bqhl,bsl->bhqs", q_abs, cl)
              + torch.einsum("bqhd,bsd->bhqs", q_rope, cr))
    scores = f32(scores)
    scores = scores * scale
    rows = off + torch.arange(cl.shape[1], device=cl.device)
    scores = torch.where(rows <= cache_pos, scores, NEG)
    if groups:
        m = pmax(torch.amax(scores, dim=-1), groups)
        e = torch.exp(scores - m[..., None])
        den = psum(e.sum(-1), groups)
        ctx_lat = psum(torch.einsum("bhqs,bsl->bqhl", e, f32(cl)),
                       groups) / den.permute(0, 2, 1)[..., None]
        ctx_lat = ctx_lat.to(cl.dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(cl.dtype)
        ctx_lat = torch.einsum("bhqs,bsl->bqhl", probs, cl)
    return torch.einsum("bqhl,hlv->bqhv", ctx_lat, w_uv)


def mla_cache_specs(cfg: AttnConfig, batch: int, s_cache: int,
                    dtype) -> dict:
    axes = cache_axes(batch, 3)
    return {"latent": ParamSpec((batch, s_cache, cfg.kv_lora_rank), dtype,
                                init="zeros", axes=axes),
            "k_rope": ParamSpec((batch, s_cache, cfg.qk_rope_dim), dtype,
                                init="zeros", axes=axes)}


# ============================================================ cross-attn


def cross_kv_specs(cfg: AttnConfig, d_model: int, dtype) -> dict:
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    return {"wk": ParamSpec((d_model, kv * dh), dtype, axes=COL),
            "wv": ParamSpec((d_model, kv * dh), dtype, axes=COL)}


def cross_kv(p, cfg: AttnConfig, enc_out: torch.Tensor, ctx=NO_MESH):
    """The encoder output's K and V (B, S_enc, KV, Dh) for a decoder
    layer's cross-attention (``p`` holds its ``wk``, ``wv``)."""
    k = _split_heads(enc_out @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(enc_out @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    return k, v
