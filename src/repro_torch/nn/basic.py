"""Norms, embeddings, rotary embeddings and dense FFNs, mirroring the
reference's ``nn/basic.py`` without its sharding constraints (the port is
mesh-free). Tensors keep the reference's layouts: activations (B, S, D),
heads (B, S, H, Dh), weight matrices (in, out).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.config import AttnConfig
from repro_torch.nn.param import ParamSpec

# ---------------------------------------------------------------- norms


def rmsnorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), torch.float32, init="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def layernorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), torch.float32, init="ones"),
            "bias": ParamSpec((d,), torch.float32, init="zeros")}


def layernorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------- embedding


def embedding_specs(vocab: int, d: int, dtype) -> dict:
    return {"table": ParamSpec((vocab, d), dtype, scale=0.02)}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["table"])


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].T


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
        band = torch.cat([torch.full((n,), i, dtype=torch.long)
                          for i, n in enumerate(cfg.mrope_sections)])
        band = band[:rot // 2].to(x.device)                 # stream of band f
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
        return {"w_gate": ParamSpec((d, d_ff), dtype),
                "w_up": ParamSpec((d, d_ff), dtype),
                "w_down": ParamSpec((d_ff, d), dtype)}
    return {"w_up": ParamSpec((d, d_ff), dtype),
            "b_up": ParamSpec((d_ff,), torch.float32, init="zeros"),
            "w_down": ParamSpec((d_ff, d), dtype),
            "b_down": ParamSpec((d,), torch.float32, init="zeros")}


def ffn(p, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    if act == "swiglu":
        h = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = F.silu(h.float()).to(x.dtype) * u
        return h @ p["w_down"]
    h = x @ p["w_up"] + p["b_up"].to(x.dtype)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p["w_down"] + p["b_down"].to(x.dtype)
