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
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.nn.basic import apply_rope, rmsnorm, rmsnorm_specs
from repro_torch.nn.config import AttnConfig
from repro_torch.nn.flash import flash_attention
from repro_torch.nn.param import ParamSpec

NEG = -1.0e30   # the reference's masked score


def gqa_specs(cfg: AttnConfig, d_model: int, dtype) -> dict:
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {"wq": ParamSpec((d_model, h * dh), dtype),
           "wk": ParamSpec((d_model, kv * dh), dtype),
           "wv": ParamSpec((d_model, kv * dh), dtype),
           "wo": ParamSpec((h * dh, d_model), dtype)}
    if cfg.qkv_bias:
        out["bq"] = ParamSpec((h * dh,), torch.float32, init="zeros")
        out["bk"] = ParamSpec((kv * dh,), torch.float32, init="zeros")
        out["bv"] = ParamSpec((kv * dh,), torch.float32, init="zeros")
    return out


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, dh)


def project_qkv(p, cfg: AttnConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """q (B, S, H, Dh), k and v (B, S, KV, Dh), rope applied: the inputs
    of the layer's attention kernel."""
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = _split_heads(q, cfg.n_heads, cfg.head_dim)
    k = _split_heads(k, cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(v, cfg.n_kv_heads, cfg.head_dim)
    if cfg.rope_kind != "none":
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    return q, k, v


def _cross_attention(p, cfg: AttnConfig, x: torch.Tensor,
                     positions: torch.Tensor, kv_override, decode: bool):
    """Attention of x's queries over precomputed K/V (B, Sk, KV, Dh), every
    row over all of them (the reference's ``kv_override`` branch)."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, sq, _ = x.shape
    k, v = kv_override
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
    q = _split_heads(q, h, dh)
    if cfg.rope_kind != "none":
        q = apply_rope(cfg, q, positions)
    scale = 1.0 / math.sqrt(dh)
    if decode:
        if sq != 1:
            raise ValueError(f"decode takes one token per row, got {sq}")
        if k.shape[1] < 1:
            raise ValueError("cross-attention over an empty encoder cache")
        return decode_attention(q.reshape(b, kv, h // kv, dh), k, v,
                                k.shape[1] - 1, scale=scale)
    return flash_attention(q.view(b, sq, kv, h // kv, dh), k, v, scale,
                           causal=False)


def gqa_apply(p, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
              cache: Optional[dict] = None, cache_pos: Optional[int] = None,
              kv_override=None):
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
                               cache_pos is not None)
        return out.reshape(b, sq, h * dh) @ p["wo"], cache
    scale = 1.0 / math.sqrt(dh)
    q, k, v = project_qkv(p, cfg, x, positions)
    if cache is None:
        out = flash_attention(q.view(b, sq, kv, h // kv, dh), k, v, scale,
                              causal=True, window=cfg.window)
        new_cache = {"k": k, "v": v}
    else:
        if sq != 1:
            raise ValueError(f"decode takes one token per row, got {sq}")
        s_cache = cache["k"].shape[1]
        write = cache_pos % s_cache if cfg.window is not None else cache_pos
        if cache["k"].dtype == torch.int8:
            k8, ks = _kv_quantize(k)
            v8, vs = _kv_quantize(v)
            for name, val in (("k", k8), ("v", v8), ("k_scale", ks),
                              ("v_scale", vs)):
                _dyn_write(cache[name], val, write)
            kf = cache["k"].to(k.dtype) * \
                cache["k_scale"].to(k.dtype)[..., None]
            vf = cache["v"].to(v.dtype) * \
                cache["v_scale"].to(v.dtype)[..., None]
        else:
            _dyn_write(cache["k"], k, write)
            _dyn_write(cache["v"], v, write)
            kf, vf = cache["k"], cache["v"]
        out = decode_attention(q.view(b, kv, h // kv, dh), kf, vf,
                               min(int(cache_pos), s_cache - 1), scale=scale)
        new_cache = cache
    y = out.reshape(b, sq, h * dh) @ p["wo"]
    return y, new_cache


def _dyn_write(buf: torch.Tensor, val: torch.Tensor, idx: int) -> None:
    """``buf[:, idx:idx + len] = val`` in place, along the sequence axis,
    with ``lax.dynamic_update_slice``'s clamp of the start index."""
    n = val.shape[1]
    idx = max(0, min(int(idx), buf.shape[1] - n))
    buf[:, idx:idx + n] = val.to(buf.dtype)


def _kv_quantize(x: torch.Tensor):
    """x (B, S, KV, Dh) -> (int8 values, fp16 absmax scales (B, S, KV))."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def gqa_cache_specs(cfg: AttnConfig, batch: int, s_cache: int, dtype,
                    quant: bool = False) -> dict:
    if cfg.window is not None:
        s_cache = min(s_cache, cfg.window)
    shp = (batch, s_cache, cfg.n_kv_heads, cfg.head_dim)
    if quant:
        return {"k": ParamSpec(shp, torch.int8, init="zeros"),
                "v": ParamSpec(shp, torch.int8, init="zeros"),
                "k_scale": ParamSpec(shp[:-1], torch.float16, init="zeros"),
                "v_scale": ParamSpec(shp[:-1], torch.float16, init="zeros")}
    return {"k": ParamSpec(shp, dtype, init="zeros"),
            "v": ParamSpec(shp, dtype, init="zeros")}


# =================================================================== MLA


def mla_specs(cfg: AttnConfig, d_model: int, dtype) -> dict:
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lq, lkv = cfg.q_lora_rank, cfg.kv_lora_rank
    out = {}
    if lq:
        out["wq_a"] = ParamSpec((d_model, lq), dtype)
        out["q_norm"] = rmsnorm_specs(lq)
        out["wq_b"] = ParamSpec((lq, h * (dn + dr)), dtype)
    else:
        out["wq"] = ParamSpec((d_model, h * (dn + dr)), dtype)
    out["wkv_a"] = ParamSpec((d_model, lkv + dr), dtype)
    out["kv_norm"] = rmsnorm_specs(lkv)
    # up-projections: per-head K (nope) and V from the latent
    out["w_uk"] = ParamSpec((h, dn, lkv), dtype)
    out["w_uv"] = ParamSpec((h, lkv, dv), dtype)
    out["wo"] = ParamSpec((h * dv, d_model), dtype)
    return out


def _mla_q(p, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
           eps: float):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope), rope applied)."""
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    b, s, _ = x.shape
    if cfg.q_lora_rank:
        q = rmsnorm(p["q_norm"], x @ p["wq_a"], eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(b, s, h, dn + dr)
    return q[..., :dn], apply_rope(cfg, q[..., dn:], positions)


def _mla_latent(p, cfg: AttnConfig, x: torch.Tensor,
                positions: torch.Tensor, eps: float):
    """(q_nope, q_rope, latent (B, S, kv_lora), k_rope (B, S, rope): the
    rope key every head shares)."""
    lkv = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(p, cfg, x, positions, eps)
    kv = x @ p["wkv_a"]
    latent = rmsnorm(p["kv_norm"], kv[..., :lkv], eps)
    k_rope = apply_rope(cfg, kv[..., lkv:][:, :, None, :],
                        positions)[:, :, 0, :]
    return q_nope, q_rope, latent, k_rope


def mla_prefill_qkv(p, cfg: AttnConfig, x: torch.Tensor,
                    positions: torch.Tensor, eps: float = 1e-6):
    """The inputs of kernel 6 in MLA's prefill: q (B, S, H, 1, nope +
    rope), k and v (B, S, H, nope + rope). Per-head keys and values are
    expanded from the latent; the shared rope key is folded into every
    head's key and V padded with zeros, so that one (q.k, p.v) pipeline
    runs at Dh = nope + rope. Also returns the cache ``{"latent",
    "k_rope"}``."""
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    b, sq, _ = x.shape
    q_nope, q_rope, latent, k_rope = _mla_latent(p, cfg, x, positions, eps)
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
              eps: float = 1e-6):
    """Returns ``(out, cache)``, as :func:`gqa_apply`: prefill (``cache``
    None) returns this call's ``{"latent", "k_rope"}``; decode writes the
    token's latent and rope key at ``cache_pos`` in place and returns the
    same dict."""
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    b, sq, _ = x.shape
    scale = 1.0 / math.sqrt(dn + dr)

    if cache is None:
        q, k, v, new_cache = mla_prefill_qkv(p, cfg, x, positions, eps)
        # the zero padding of v takes a gradient that the slice drops
        out = flash_attention(q, k, v, scale, causal=True)
        out = out.view(b, sq, h, dn + dr)[..., :dv]
    else:
        if sq != 1:
            raise ValueError(f"decode takes one token per row, got {sq}")
        q_nope, q_rope, latent, k_rope = _mla_latent(p, cfg, x, positions,
                                                     eps)
        _dyn_write(cache["latent"], latent, cache_pos)
        _dyn_write(cache["k_rope"], k_rope, cache_pos)
        cl, cr = cache["latent"], cache["k_rope"]
        # absorbed: q' = q_nope . w_uk scores against the latent directly
        q_abs = torch.einsum("bqhd,hdl->bqhl", q_nope, p["w_uk"])
        scores = (torch.einsum("bqhl,bsl->bhqs", q_abs, cl)
                  + torch.einsum("bqhd,bsd->bhqs", q_rope, cr)).float()
        scores = scores * scale
        valid = torch.arange(cl.shape[1], device=x.device) <= cache_pos
        scores = torch.where(valid, scores, NEG)
        probs = torch.softmax(scores, dim=-1).to(cl.dtype)
        ctx_lat = torch.einsum("bhqs,bsl->bqhl", probs, cl)
        out = torch.einsum("bqhl,hlv->bqhv", ctx_lat, p["w_uv"])
        new_cache = cache
    y = out.reshape(b, sq, h * dv) @ p["wo"]
    return y, new_cache


def mla_cache_specs(cfg: AttnConfig, batch: int, s_cache: int,
                    dtype) -> dict:
    return {"latent": ParamSpec((batch, s_cache, cfg.kv_lora_rank), dtype,
                                init="zeros"),
            "k_rope": ParamSpec((batch, s_cache, cfg.qk_rope_dim), dtype,
                                init="zeros")}


# ============================================================ cross-attn


def cross_kv_specs(cfg: AttnConfig, d_model: int, dtype) -> dict:
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    return {"wk": ParamSpec((d_model, kv * dh), dtype),
            "wv": ParamSpec((d_model, kv * dh), dtype)}


def cross_kv(p, cfg: AttnConfig, enc_out: torch.Tensor):
    """The encoder output's K and V (B, S_enc, KV, Dh) for a decoder
    layer's cross-attention (``p`` holds its ``wk``, ``wv``)."""
    k = _split_heads(enc_out @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(enc_out @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    return k, v
