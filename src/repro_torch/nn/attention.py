"""Grouped-query attention (full and sliding-window), mirroring the GQA
part of the reference's ``nn/attention.py``, with the two attention
kernels as its attention on every path:

* cache-less (train/prefill): ``kernels/flash_attention.flash_attention_fwd``
  (causal, the layer's window) at every length, where the reference takes
  its masked ``_sdpa`` up to 512 tokens and ``nn/flash.sdpa_flash`` above;
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

MLA, cross-attention and precomputed-KV attention come with the rest of
the model stack (``models/lm.LM`` raises for such layers).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.nn.basic import apply_rope
from repro_torch.nn.config import AttnConfig
from repro_torch.nn.param import ParamSpec


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


def gqa_apply(p, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
              cache: Optional[dict] = None, cache_pos: Optional[int] = None):
    """Returns ``(out, cache)``.

    * train / prefill: ``cache`` None -> causal self-attention over x; the
      returned cache is this call's ``{"k", "v"}``.
    * decode: ``cache`` given, x is (B, 1, D), ``cache_pos`` (a host int)
      the write index; the cache is updated in place and returned.
    """
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, sq, _ = x.shape
    scale = 1.0 / math.sqrt(dh)
    q, k, v = project_qkv(p, cfg, x, positions)
    if cache is None:
        out = flash_attention_fwd(q.view(b, sq, kv, h // kv, dh), k, v,
                                  scale=scale, causal=True,
                                  window=cfg.window)
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
