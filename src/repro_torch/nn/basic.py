"""Norms, embeddings, rotary embeddings and dense FFNs, mirroring the
reference's ``nn/basic.py`` with its sharding constraints (``ctx``, a
``nn.sharding.ShardCtx``; none without a mesh). Tensors keep the
reference's layouts: activations (B, S, D), heads (B, S, H, Dh), weight
matrices (in, out).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.config import AttnConfig
from repro_torch.nn.param import ParamSpec
from repro_torch.nn.sharding import NO_MESH

# the logical axes of a column-parallel (in, out) weight and of the
# row-parallel one after it (Megatron's pair)
COL = ("fsdp", "model")
ROW = ("model", "fsdp")

# ---------------------------------------------------------------- norms


def f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, where the reference computes in fp32, or as it is if
    it is float64: a float64 model (the tests' exact comparisons) keeps
    float64 throughout."""
    return x if x.dtype == torch.float64 else x.float()


def f32_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype :func:`f32` gives a tensor of ``dtype``."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def rmsnorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), torch.float32, init="ones",
                               axes=(None,))}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = f32(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def layernorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), torch.float32, init="ones",
                               axes=(None,)),
            "bias": ParamSpec((d,), torch.float32, init="zeros",
                              axes=(None,))}


def layernorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = f32(x)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------- embedding


def embedding_specs(vocab: int, d: int, dtype) -> dict:
    return {"table": ParamSpec((vocab, d), dtype, scale=0.02,
                               axes=("model", "fsdp"))}


def embed(p, tokens: torch.Tensor, ctx=NO_MESH) -> torch.Tensor:
    out = F.embedding(tokens.long(), p["table"])
    return ctx.constrain(out, "dp", None, None)


def unembed(p, x: torch.Tensor, ctx=NO_MESH) -> torch.Tensor:
    return ctx.constrain(x @ p["table"].T, "dp", None, "model")


# ---------------------------------------------------------------- RoPE


def rope_freqs(cfg: AttnConfig, rot_dim: int, device=None) -> torch.Tensor:
    half = rot_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (cfg.rope_theta ** exps)


def _rotate(x: torch.Tensor, sin: torch.Tensor,
            cos: torch.Tensor) -> torch.Tensor:
    # x: (..., rot_dim); sin/cos: (..., rot_dim/2)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
               rot_dim: int | None = None) -> torch.Tensor:
    """x: (B, S, H, Dh), rope on the first ``rot_dim`` dims; positions:
    (B, S) integers, or (3, B, S) for M-RoPE."""
    rot = rot_dim or x.shape[-1]
    inv = rope_freqs(cfg, rot, x.device)                    # (rot/2,)
    if cfg.rope_kind == "mrope":
        # positions (3, B, S): temporal / height / width streams; the
        # frequency bands are split between the three streams (Qwen2-VL
        # §3). Text-only steps may pass (B, S): all three coincide.
        if positions.ndim == 2:
            positions = positions[None].expand(3, *positions.shape)
        ang = positions[..., None].float() * inv            # (3, B, S, rot/2)
        # stream of band f, filled on the device (no copy up a call)
        band = torch.cat([torch.full((n,), i, dtype=torch.long,
                                     device=x.device)
                          for i, n in enumerate(cfg.mrope_sections)])
        band = band[:rot // 2]
        ang = torch.gather(ang, 0, band.expand(1, *ang.shape[1:-1], -1))[0]
    else:
        ang = positions[..., None].float() * inv            # (B, S, rot/2)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    if rot == x.shape[-1]:
        return _rotate(x, sin, cos)
    return torch.cat([_rotate(x[..., :rot], sin, cos), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------- dense FFN


def ffn_specs(d: int, d_ff: int, dtype, act: str = "swiglu") -> dict:
    if act == "swiglu":
        return {"w_gate": ParamSpec((d, d_ff), dtype, axes=COL),
                "w_up": ParamSpec((d, d_ff), dtype, axes=COL),
                "w_down": ParamSpec((d_ff, d), dtype, axes=ROW)}
    return {"w_up": ParamSpec((d, d_ff), dtype, axes=COL),
            "b_up": ParamSpec((d_ff,), torch.float32, init="zeros",
                              axes=("model",)),
            "w_down": ParamSpec((d_ff, d), dtype, axes=ROW),
            "b_down": ParamSpec((d,), torch.float32, init="zeros",
                                axes=(None,))}


def ffn(p, x: torch.Tensor, act: str = "swiglu",
        ctx=NO_MESH) -> torch.Tensor:
    if act == "swiglu":
        h = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = F.silu(f32(h)).to(x.dtype) * u
        h = ctx.constrain(h, "dp", None, "model")
        return ctx.constrain(h @ p["w_down"], "dp", None, None)
    h = x @ p["w_up"] + p["b_up"].to(x.dtype)
    h = F.gelu(f32(h), approximate="tanh").to(x.dtype)
    h = ctx.constrain(h, "dp", None, "model")
    return ctx.constrain(h @ p["w_down"] + p["b_down"].to(x.dtype),
                         "dp", None, None)
