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
from repro_torch.nn.basic import COL, ROW, f32
from repro_torch.nn import runtime
from repro_torch.nn.param import ParamSpec
from repro_torch.nn.sharding import (NO_MESH, batch_map, psum_split,
                                     write_states)


def _dims(cfg: MambaConfig, d_model: int):
    d_inner = cfg.expand * d_model
    dt_rank = cfg.dt_rank or math.ceil(d_model / 16)
    return d_inner, dt_rank


def mamba_specs(cfg: MambaConfig, d_model: int, dtype) -> dict:
    d_inner, dt_rank = _dims(cfg, d_model)
    n = cfg.d_state
    fp32 = torch.float32
    return {
        "w_in": ParamSpec((d_model, 2 * d_inner), dtype, axes=COL),
        "conv_w": ParamSpec((cfg.d_conv, d_inner), fp32, axes=(None, "model")),
        "conv_b": ParamSpec((d_inner,), fp32, init="zeros", axes=("model",)),
        "w_x": ParamSpec((d_inner, dt_rank + 2 * n), dtype,
                         axes=("model", None)),
        "w_dt": ParamSpec((dt_rank, d_inner), fp32, axes=COL),
        "b_dt": ParamSpec((d_inner,), fp32, init="ones", axes=("model",)),
        # A stored as log(-A)
        "a_log": ParamSpec((d_inner, n), fp32, init="ones",
                           axes=("model", None)),
        "d_skip": ParamSpec((d_inner,), fp32, init="ones", axes=("model",)),
        "w_out": ParamSpec((d_inner, d_model), dtype, axes=ROW),
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


_CHANNEL_PARAMS = (("conv_w", 1), ("conv_b", 0), ("w_x", 0), ("w_dt", 1),
                   ("b_dt", 0), ("a_log", 0), ("d_skip", 0))   # d_inner dim


def mamba_apply(p, cfg: MambaConfig, x: torch.Tensor,
                cache: Optional[dict] = None, ctx=NO_MESH):
    """x (B, S, D) -> ``(y, cache)``. Without ``cache`` (prefill) the
    returned cache is this call's final states; with one (decode, S 1)
    the states are updated in place. On a mesh the block runs between the
    reference's two constraints on each rank's batch shard and its
    d_inner / tp channels (:func:`_mamba_mesh`); where the model axis does
    not divide d_inner, on every channel (``batch_map``, replicated over
    the model axis)."""
    xz = ctx.constrain(x @ p["w_in"], "dp", None, "model")
    names = [n for n, _ in _CHANNEL_PARAMS]
    states = (cache["conv"], cache["ssm"]) if cache is not None else ()
    tp = ctx.tp_size()
    if ctx.mesh is not None and tp > 1 and (xz.shape[-1] // 2) % tp == 0:
        y, new_conv, h = _mamba_mesh(ctx, cfg, x.dtype, xz, p, states)
    else:
        def core(xz, *rest):
            return _mamba_core(cfg, x.dtype, *torch.chunk(xz, 2, dim=-1),
                               *rest)

        y, new_conv, h = batch_map(
            ctx, core, (xz, *(p[n] for n in names), *states),
            (0,) + (None,) * len(names) + (0,) * len(states), (0, 0, 0))
    y = ctx.constrain(y, "dp", None, "model")
    out = ctx.constrain(y @ p["w_out"], "dp", None, None)
    return out, write_states(ctx, cache, {"conv": new_conv, "ssm": h})


def _mamba_mesh(ctx, cfg: MambaConfig, dtype, xz, p, states):
    """The block as a ``local_map`` body on this rank's batch shard and
    its channels ``c0..c0 + d_inner / tp`` of x and z (xz gathered whole
    over the model axis, each rank slicing its two ranges, as the
    reference's split of the model-sharded xz moves them): the depthwise
    conv, dt, the scan and the gate are per channel, so the only
    collective is the sum of x_proj's (dt, B, C) over the model axis
    (``psum_split``). The parameters and the decode states are the
    rank's channels as they lie; y leaves sharded over the model axis."""
    from torch.distributed.tensor import Partial, Shard

    model = ctx.axes_of("model")
    d_inner = xz.shape[-1] // 2
    w = d_inner // ctx.tp_size()
    c0 = ctx.coord(model[0]) * w
    groups = ctx.groups(model)
    bp = ctx.placements(("dp",), (xz.shape[0],))
    dp_part = tuple(Partial() if isinstance(pl, Shard) else pl for pl in bp)
    rep = ctx.rep()

    def at(base, dim):
        return ctx.with_dims(base, model, Shard(dim))

    def body(xz_l, *rest):
        xi = xz_l[..., c0:c0 + w]
        z = xz_l[..., d_inner + c0:d_inner + c0 + w]
        return _mamba_core(cfg, dtype, xi, z, *rest,
                           reduce=lambda t: psum_split(t, groups))

    par_pl = tuple(at(rep, d) for _, d in _CHANNEL_PARAMS)
    par_grad = tuple(at(dp_part, d) for _, d in _CHANNEL_PARAMS)
    xz_grad = ctx.with_dims(bp, model, Partial())
    st_pl = tuple(t.placements for t in states)
    out_pl = (at(bp, 2), at(bp, 2), at(bp, 1))
    return ctx.region(body, out_pl, (bp, *par_pl, *st_pl),
                      (xz_grad, *par_grad, *st_pl), xz,
                      *(p[n] for n, _ in _CHANNEL_PARAMS), *states)


def _mamba_core(cfg: MambaConfig, dtype, xi, z, conv_w, conv_b, w_x, w_dt,
                b_dt, a_log, d_skip, conv_state=None, ssm_state=None,
                reduce=lambda t: t):
    """The block between the in- and out-projections on x and z (B, S,
    channels): ``(y (B, S, channels), conv state, ssm state)``; a decode
    (states given) writes them in place. ``reduce`` completes x_proj's
    product when the channels are a shard of d_inner."""
    b, s, _ = xi.shape
    n = cfg.d_state
    d_inner = xi.shape[-1]
    dt_rank = w_dt.shape[0]

    # causal depthwise conv as a sum of shifted slices (d_conv is 4)
    if conv_state is None:
        pad = xi.new_zeros((b, cfg.d_conv - 1, d_inner))
        xc_in = torch.cat([pad, xi], dim=1)
    else:
        xc_in = torch.cat([conv_state.to(xi.dtype), xi], dim=1)
    new_conv = xc_in[:, -(cfg.d_conv - 1):] if cfg.d_conv > 1 else None
    xc = sum(xc_in[:, i:i + s] * conv_w[i].to(xi.dtype)
             for i in range(cfg.d_conv)) + conv_b.to(xi.dtype)
    xc = F.silu(f32(xc)).to(xi.dtype)

    # input-dependent SSM parameters
    dt_in, b_in, c_in = torch.split(reduce(xc @ w_x), [dt_rank, n, n],
                                    dim=-1)
    dt = f32(dt_in) @ w_dt + b_dt
    dt = torch.logaddexp(dt, torch.zeros_like(dt))   # jax.nn.softplus
    a = -torch.exp(a_log)                            # (d_inner, N)
    b_in, c_in = f32(b_in), f32(c_in)
    xcf = f32(xc)

    if ssm_state is None and s > 1:
        q = min(cfg.chunk, s)
        if s % q:
            raise ValueError(f"seq {s} must be divisible by chunk {q}")

        def step(j, h):
            sl = slice(j * q, (j + 1) * q)
            dt_c = dt[:, sl]
            decay = torch.exp(dt_c[..., None] * a)              # (B,Q,d,N)
            inp = (dt_c * xcf[:, sl])[..., None] * b_in[:, sl, None, :]
            h_all = _scan_chunk(h, decay, inp)
            return h_all[:, -1], torch.einsum("bqdn,bqn->bqd", h_all,
                                              c_in[:, sl])

        h, y = runtime.scan(step, xi.new_zeros((b, d_inner, n),
                                               dtype=xcf.dtype),
                            s // q, stack=False)
    else:
        # one step: decode, or a one-token prefill
        h_prev = ssm_state if ssm_state is not None else \
            xi.new_zeros((b, d_inner, n), dtype=xcf.dtype)
        decay = torch.exp(dt[:, 0, :, None] * a)                # (B,d,N)
        inp = (dt[:, 0] * xcf[:, 0])[..., None] * b_in[:, 0, None, :]
        h = decay * h_prev + inp
        y = torch.einsum("bdn,bn->bd", h, c_in[:, 0])[:, None, :]

    y = y + xcf * d_skip
    y = (y * F.silu(f32(z))).to(dtype)
    if ssm_state is not None:
        conv_state.copy_(new_conv)
        ssm_state.copy_(h)
    return y, new_conv, h


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
                              init="zeros", axes=("dp", None, "model")),
            "ssm": ParamSpec((batch, d_inner, cfg.d_state), torch.float32,
                             init="zeros", axes=("dp", "model", None))}
