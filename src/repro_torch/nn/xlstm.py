"""xLSTM blocks, mirroring the reference's ``nn/xlstm.py``: mLSTM (matrix
memory, chunkwise-parallel prefill) and sLSTM (scalar memory, a strictly
sequential scan) — arXiv:2405.04517.

mLSTM keeps a matrix memory C (B, H, dk, dv), a normaliser n (B, H, dk)
and a stabiliser m (B, H) with exponential input and forget gates. Its
prefill is the reference's chunkwise form (an attention-like term inside
a chunk, a recurrent carry between chunks, the carry's m starting at 0);
the state it returns for decode is the reference's closed form over the
whole sequence. Its decode, and a one-token prefill (m from -1e30), is the
recurrent update. sLSTM steps through time with per-head recurrent
weights. Decode writes every state into the cache in place (the port's
decode contract) and returns the same dict. The reference has no Pallas
kernel here: both are plain tensor ops in both packages.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.nn.config import XLSTMConfig
from repro_torch.nn.param import ParamSpec

# ================================================================= mLSTM


def _mlstm_dims(cfg: XLSTMConfig, d_model: int):
    d_in = int(cfg.proj_factor * d_model)
    return d_in, d_in // cfg.n_heads


def mlstm_specs(cfg: XLSTMConfig, d_model: int, dtype) -> dict:
    h = cfg.n_heads
    d_in, _ = _mlstm_dims(cfg, d_model)
    f32 = torch.float32
    return {
        "w_up": ParamSpec((d_model, 2 * d_in), dtype),
        "w_q": ParamSpec((d_in, d_in), dtype),
        "w_k": ParamSpec((d_in, d_in), dtype),
        "w_v": ParamSpec((d_in, d_in), dtype),
        "w_if": ParamSpec((d_in, 2 * h), f32, scale=0.02),
        "b_if": ParamSpec((2 * h,), f32, init="zeros"),
        "gn_scale": ParamSpec((d_in,), f32, init="ones"),
        "w_down": ParamSpec((d_in, d_model), dtype),
    }


def _headwise_norm(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm per head of x (B, S, H, Dh), in fp32: the population
    variance, as ``jnp.var``."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    b, s, h, dh = x.shape
    return (out.reshape(b, s, h * dh) * scale).reshape(b, s, h, dh)


def mlstm_apply(p, cfg: XLSTMConfig, x: torch.Tensor,
                cache: Optional[dict] = None):
    """x (B, S, D) -> ``(y, cache)``; cache ``{c (B, H, dk, dv), n (B, H,
    dk), m (B, H)}``, returned new by a prefill, updated in place by a
    decode."""
    b, s, d_model = x.shape
    h = cfg.n_heads
    d_in, dh = _mlstm_dims(cfg, d_model)

    xi, z = torch.chunk(x @ p["w_up"], 2, dim=-1)
    q = (xi @ p["w_q"]).reshape(b, s, h, dh)
    k = (xi @ p["w_k"]).reshape(b, s, h, dh)
    v = (xi @ p["w_v"]).reshape(b, s, h, dh)
    k = k / torch.tensor(math.sqrt(dh), dtype=torch.float32).to(k.dtype)
    gates = xi.float() @ p["w_if"] + p["b_if"]             # (B, S, 2H)
    i_pre, f_pre = gates[..., :h], gates[..., h:]          # log-space gates
    logf = F.logsigmoid(f_pre)

    if cache is None and s > 1:
        y = _mlstm_chunked(cfg, q, k, v, i_pre, logf)
        new_cache = _mlstm_final_state(k, v, i_pre, logf)
    else:
        if cache is not None:
            c_prev, n_prev, m_prev = cache["c"], cache["n"], cache["m"]
        else:
            f32 = dict(dtype=torch.float32, device=x.device)
            c_prev = torch.zeros((b, h, dh, dh), **f32)
            n_prev = torch.zeros((b, h, dh), **f32)
            m_prev = torch.full((b, h), -1e30, **f32)
        i1, f1 = i_pre[:, 0], logf[:, 0]                  # (B, H)
        m = torch.maximum(f1 + m_prev, i1)
        fi = torch.exp(f1 + m_prev - m)
        ii = torch.exp(i1 - m)
        kf, vf, qf = k[:, 0].float(), v[:, 0].float(), q[:, 0].float()
        c = fi[..., None, None] * c_prev + ii[..., None, None] * (
            kf[..., :, None] * vf[..., None, :])
        n = fi[..., None] * n_prev + ii[..., None] * kf
        num = torch.einsum("bhd,bhdv->bhv", qf, c)
        den = torch.abs(torch.einsum("bhd,bhd->bh", qf, n))
        yt = num / torch.maximum(den, torch.exp(-m))[..., None]
        y = yt[:, None].to(x.dtype).reshape(b, 1, h, dh)
        new_cache = {"c": c, "n": n, "m": m}
        if cache is not None:
            for name, t in new_cache.items():
                cache[name].copy_(t)
            new_cache = cache

    y = _headwise_norm(y, p["gn_scale"]).to(x.dtype).reshape(b, s, d_in)
    y = y * F.silu(z.float()).to(x.dtype)
    return y @ p["w_down"], new_cache


def _mlstm_chunked(cfg: XLSTMConfig, q, k, v, i_pre, logf) -> torch.Tensor:
    """Chunkwise-parallel mLSTM (the stabilised linear-attention form);
    y (B, S, H, Dh) fp32."""
    b, s, h, dh = q.shape
    cs = min(cfg.chunk, s)
    if s % cs:
        raise ValueError(f"seq {s} must divide chunk {cs}")
    f32 = dict(dtype=torch.float32, device=q.device)
    c_prev = torch.zeros((b, h, dh, dh), **f32)
    n_prev = torch.zeros((b, h, dh), **f32)
    m_prev = torch.zeros((b, h), **f32)
    tri = torch.tril(torch.ones((cs, cs), dtype=torch.bool, device=q.device))
    ys = []
    for lo in range(0, s, cs):
        sl = slice(lo, lo + cs)
        qf, kf, vf = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        ib, fb = i_pre[:, sl], logf[:, sl]
        fcum = torch.cumsum(fb, dim=1)               # (B, cs, H) inclusive
        ftot = fcum[:, -1]                           # (B, H)
        lam = fcum + m_prev[:, None, :]              # carry's log weight at t
        # D[t, t'] = sum_{t' < j <= t} f_j + i_t' for t' <= t, else -inf:
        # exp(-inf - finite) = 0, and the diagonal keeps every row's max
        # finite, so no -inf - (-inf) arises
        dmat = fcum[:, :, None, :] - fcum[:, None, :, :] + ib[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat, -math.inf)
        m_t = torch.maximum(lam, torch.amax(dmat, dim=2))   # (B, t, H)
        w_carry = torch.exp(lam - m_t)
        num_carry = torch.einsum("bthd,bhdv->bthv", qf, c_prev) \
            * w_carry[..., None]
        den_carry = torch.einsum("bthd,bhd->bth", qf, n_prev) * w_carry
        wmat = torch.exp(dmat - m_t[:, :, None, :])         # (B, t, t', H)
        scores = torch.einsum("bthd,bshd->btsh", qf, kf) * wmat
        num = num_carry + torch.einsum("btsh,bshv->bthv", scores, vf)
        den = den_carry + torch.sum(scores, dim=2)
        ys.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_t))[..., None])
        # carry to the chunk's end
        w_log = ib + (ftot[:, None] - fcum)
        m_new = torch.maximum(ftot + m_prev, torch.amax(w_log, dim=1))
        wi = torch.exp(w_log - m_new[:, None])              # (B, t, H)
        decay = torch.exp(ftot + m_prev - m_new)
        c_prev = decay[:, :, None, None] * c_prev + torch.einsum(
            "bthd,bth,bthv->bhdv", kf, wi, vf)
        n_prev = decay[..., None] * n_prev + torch.einsum(
            "bthd,bth->bhd", kf, wi)
        m_prev = m_new
    return torch.cat(ys, dim=1)


def _mlstm_final_state(k, v, i_pre, logf) -> dict:
    """The final ``{c, n, m}`` after a whole prefill, for decode to
    continue from (the reference's closed form over the sequence)."""
    fcum = torch.cumsum(logf, dim=1)
    ftot = fcum[:, -1]                                      # (B, H)
    w_log = i_pre + (ftot[:, None] - fcum)                  # (B, S, H)
    m = torch.amax(w_log, dim=1)                            # (B, H)
    wi = torch.exp(w_log - m[:, None])
    kf, vf = k.float(), v.float()
    c = torch.einsum("bshd,bsh,bshv->bhdv", kf, wi, vf)
    n = torch.einsum("bshd,bsh->bhd", kf, wi)
    return {"c": c, "n": n, "m": m}


def mlstm_cache_specs(cfg: XLSTMConfig, d_model: int, batch: int) -> dict:
    h = cfg.n_heads
    _, dh = _mlstm_dims(cfg, d_model)
    f32 = torch.float32
    return {"c": ParamSpec((batch, h, dh, dh), f32, init="zeros"),
            "n": ParamSpec((batch, h, dh), f32, init="zeros"),
            "m": ParamSpec((batch, h), f32, init="zeros")}


# ================================================================= sLSTM


def slstm_specs(cfg: XLSTMConfig, d_model: int, dtype) -> dict:
    h = cfg.n_heads
    dh = d_model // h
    f32 = torch.float32
    # 4 gates (i, f, z, o): input weights, and recurrent weights
    # block-diagonal per head
    return {
        "w_gates": ParamSpec((d_model, 4 * d_model), dtype),
        "r_gates": ParamSpec((h, dh, 4 * dh), f32),
        "b_gates": ParamSpec((4 * d_model,), f32, init="zeros"),
        "gn_scale": ParamSpec((d_model,), f32, init="ones"),
        "w_down": ParamSpec((d_model, d_model), dtype),
    }


def slstm_apply(p, cfg: XLSTMConfig, x: torch.Tensor,
                cache: Optional[dict] = None):
    """x (B, S, D) -> ``(y, cache)``; cache ``{h, c, n, m}``, each (B, H,
    Dh) fp32: a sequential scan over S from the cache's states (a
    prefill's from h = c = m = 0, n = 1)."""
    b, s, d_model = x.shape
    nh = cfg.n_heads
    dh = d_model // nh

    wx = x.float() @ p["w_gates"].float() + p["b_gates"]
    wx = wx.reshape(b, s, nh, 4 * dh)
    if cache is not None:
        hs, c, n, m = cache["h"], cache["c"], cache["n"], cache["m"]
    else:
        f32 = dict(dtype=torch.float32, device=x.device)
        hs, c, m = (torch.zeros((b, nh, dh), **f32) for _ in range(3))
        n = torch.ones((b, nh, dh), **f32)
    r = p["r_gates"]                                        # (H, Dh, 4Dh)
    ys = []
    for t in range(s):
        g = wx[:, t] + torch.einsum("bhd,hdg->bhg", hs, r)
        i_pre, f_pre, z_pre, o_pre = torch.chunk(g, 4, dim=-1)
        m_t = torch.maximum(f_pre + m, i_pre)
        i_g = torch.exp(i_pre - m_t)
        f_g = torch.exp(f_pre + m - m_t)
        c = f_g * c + i_g * torch.tanh(z_pre)
        n = f_g * n + i_g
        hs = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
        m = m_t
        ys.append(hs)
    y = torch.stack(ys, dim=1)                              # (B, S, H, Dh)
    y = _headwise_norm(y, p["gn_scale"]).to(x.dtype).reshape(b, s, d_model)
    new_cache = {"h": hs, "c": c, "n": n, "m": m}
    if cache is not None:
        for name, t in new_cache.items():
            cache[name].copy_(t)
        new_cache = cache
    return y @ p["w_down"], new_cache


def slstm_cache_specs(cfg: XLSTMConfig, d_model: int, batch: int) -> dict:
    nh = cfg.n_heads
    shape = (batch, nh, d_model // nh)
    f32 = torch.float32
    return {"h": ParamSpec(shape, f32, init="zeros"),
            "c": ParamSpec(shape, f32, init="zeros"),
            "n": ParamSpec(shape, f32, init="ones"),
            "m": ParamSpec(shape, f32, init="zeros")}
