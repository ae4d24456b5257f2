"""Mamba (selective SSM) sequence mixer, Jamba's Mamba-1 style block,
mirroring the reference's ``nn/ssm.py``.

Prefill is time-chunked as in the reference: chunks of ``cfg.chunk``
steps one after another, the carry h (B, d_inner, N) passed between them,
and inside a chunk a log-depth doubling scan over the chunk's time axis
(the reference's ``lax.associative_scan``). Only one chunk's states
(B, Q, d_inner, N) are ever held, never the whole sequence's: at
jamba-1.5-large's width one chunk of 256 steps is 268 MB at B 1. A
prefill longer than ``cfg.chunk`` must be a multiple of it (the
reference's rule).

Decode keeps ``{"conv": (B, d_conv - 1, d_inner), "ssm": (B, d_inner, N)
fp32}`` and takes the O(1) recurrent update; it writes both states into
the cache in place (the port's decode contract) and returns the same
dict. The reference has no Pallas kernel here: the scan is plain tensor
ops in both packages.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.nn.config import MambaConfig
from repro_torch.nn.param import ParamSpec


def _dims(cfg: MambaConfig, d_model: int):
    d_inner = cfg.expand * d_model
    dt_rank = cfg.dt_rank or math.ceil(d_model / 16)
    return d_inner, dt_rank


def mamba_specs(cfg: MambaConfig, d_model: int, dtype) -> dict:
    d_inner, dt_rank = _dims(cfg, d_model)
    n = cfg.d_state
    f32 = torch.float32
    return {
        "w_in": ParamSpec((d_model, 2 * d_inner), dtype),
        "conv_w": ParamSpec((cfg.d_conv, d_inner), f32),
        "conv_b": ParamSpec((d_inner,), f32, init="zeros"),
        "w_x": ParamSpec((d_inner, dt_rank + 2 * n), dtype),
        "w_dt": ParamSpec((dt_rank, d_inner), f32),
        "b_dt": ParamSpec((d_inner,), f32, init="ones"),
        # A stored as log(-A)
        "a_log": ParamSpec((d_inner, n), f32, init="ones"),
        "d_skip": ParamSpec((d_inner,), f32, init="ones"),
        "w_out": ParamSpec((d_inner, d_model), dtype),
    }


def _scan_chunk(h0: torch.Tensor, decay: torch.Tensor, inp: torch.Tensor):
    """h_t = decay_t * h_{t-1} + inp_t over one chunk's time axis (dim 1)
    from the carry h0 (B, d, N): a doubling scan, log2(Q) steps, each
    combining every step with the one ``off`` before it as the
    reference's ``combine`` does. Returns all Q states (B, Q, d, N)."""
    dec, acc = decay, inp
    q = dec.shape[1]
    off = 1
    while off < q:
        acc = torch.cat([acc[:, :off], acc[:, off:] + dec[:, off:]
                         * acc[:, :-off]], dim=1)
        dec = torch.cat([dec[:, :off], dec[:, off:] * dec[:, :-off]], dim=1)
        off *= 2
    return dec * h0[:, None] + acc


def mamba_apply(p, cfg: MambaConfig, x: torch.Tensor,
                cache: Optional[dict] = None):
    """x (B, S, D) -> ``(y, cache)``. Without ``cache`` (prefill) the
    returned cache is this call's final states; with one (decode, S 1)
    the states are updated in place."""
    b, s, d_model = x.shape
    d_inner, dt_rank = _dims(cfg, d_model)
    n = cfg.d_state

    xi, z = torch.chunk(x @ p["w_in"], 2, dim=-1)   # (B, S, d_inner) each

    # causal depthwise conv as a sum of shifted slices (d_conv is 4)
    if cache is None:
        pad = xi.new_zeros((b, cfg.d_conv - 1, d_inner))
        xc_in = torch.cat([pad, xi], dim=1)
    else:
        xc_in = torch.cat([cache["conv"].to(xi.dtype), xi], dim=1)
    new_conv = xc_in[:, -(cfg.d_conv - 1):] if cfg.d_conv > 1 else None
    xc = sum(xc_in[:, i:i + s] * p["conv_w"][i].to(xi.dtype)
             for i in range(cfg.d_conv)) + p["conv_b"].to(xi.dtype)
    xc = F.silu(xc.float()).to(xi.dtype)

    # input-dependent SSM parameters
    dt_in, b_in, c_in = torch.split(xc @ p["w_x"], [dt_rank, n, n], dim=-1)
    dt = dt_in.float() @ p["w_dt"] + p["b_dt"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))   # jax.nn.softplus
    a = -torch.exp(p["a_log"])                       # (d_inner, N)
    b_in, c_in = b_in.float(), c_in.float()
    xcf = xc.float()

    if cache is None and s > 1:
        q = min(cfg.chunk, s)
        if s % q:
            raise ValueError(f"seq {s} must be divisible by chunk {q}")
        h = x.new_zeros((b, d_inner, n), dtype=torch.float32)
        ys = []
        for lo in range(0, s, q):
            dt_c = dt[:, lo:lo + q]
            decay = torch.exp(dt_c[..., None] * a)              # (B,Q,d,N)
            inp = (dt_c * xcf[:, lo:lo + q])[..., None] \
                * b_in[:, lo:lo + q, None, :]
            h_all = _scan_chunk(h, decay, inp)
            ys.append(torch.einsum("bqdn,bqn->bqd", h_all,
                                   c_in[:, lo:lo + q]))
            h = h_all[:, -1]
            del decay, inp, h_all
        y = torch.cat(ys, dim=1)
    else:
        # one step: decode, or a one-token prefill
        h_prev = cache["ssm"] if cache is not None else \
            x.new_zeros((b, d_inner, n), dtype=torch.float32)
        decay = torch.exp(dt[:, 0, :, None] * a)                # (B,d,N)
        inp = (dt[:, 0] * xcf[:, 0])[..., None] * b_in[:, 0, None, :]
        h = decay * h_prev + inp
        y = torch.einsum("bdn,bn->bd", h, c_in[:, 0])[:, None, :]

    y = y + xcf * p["d_skip"]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ p["w_out"]
    if cache is None:
        return out, {"conv": new_conv, "ssm": h}
    cache["conv"].copy_(new_conv)
    cache["ssm"].copy_(h)
    return out, cache


def mamba_cache_specs(cfg: MambaConfig, d_model: int, batch: int,
                      dtype) -> dict:
    """The decode states. The conv state is in ``dtype``, the model's
    activation dtype, where the reference declares it bf16: its
    ``mamba_apply`` returns the state in the activations' dtype, and the
    port writes it back into this buffer in place, so an fp32 model's
    state would round in a bf16 one. Zeros are zeros in either, and every
    published config is bf16 (ROADMAP section 3)."""
    d_inner, _ = _dims(cfg, d_model)
    return {"conv": ParamSpec((batch, cfg.d_conv - 1, d_inner), dtype,
                              init="zeros"),
            "ssm": ParamSpec((batch, d_inner, cfg.d_state), torch.float32,
                             init="zeros")}
