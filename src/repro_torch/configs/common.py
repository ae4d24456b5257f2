"""Shared helpers for architecture configs: reduced smoke-config shrinking
and the arch registry.

``input_specs`` (per-workload input stand-ins for a sharded dry run) is
not ported yet: it belongs to the launch and dry-run layer (ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.nn.config import AttnConfig, LayerSpec, ModelConfig


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# --------------------------------------------------------------- shrink


def shrink(cfg: ModelConfig, *, d_model=64, vocab=512, n_repeat=1,
           seq_chunk=8) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small widths, few
    experts, tiny vocab — but the *same* layer pattern and code paths."""

    def sh_attn(a: AttnConfig | None):
        if a is None:
            return None
        heads = max(2, min(4, a.n_heads))
        kv = max(1, min(heads, a.n_kv_heads if a.n_kv_heads <= heads else heads))
        upd = dict(
            n_heads=heads, n_kv_heads=kv, head_dim=16,
            window=min(a.window, 8) if a.window else None,
        )
        if a.kind == "mla":
            upd.update(
                q_lora_rank=16 if a.q_lora_rank else None, kv_lora_rank=16,
                qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
            )
        if a.rope_kind == "mrope":
            upd["mrope_sections"] = (2, 3, 3)
        return dataclasses.replace(a, **upd)

    def sh_layer(l: LayerSpec) -> LayerSpec:
        moe = None
        if l.moe is not None:
            moe = dataclasses.replace(
                l.moe, n_experts=4, top_k=min(2, l.moe.top_k),
                d_ff_expert=32, n_shared=min(1, l.moe.n_shared),
                d_ff_shared=32 if l.moe.n_shared else 0, capacity_factor=2.0,
            )
        return dataclasses.replace(
            l,
            attn=sh_attn(l.attn),
            mamba=dataclasses.replace(
                l.mamba, d_state=4, chunk=seq_chunk
            ) if l.mamba else None,
            xlstm=dataclasses.replace(
                l.xlstm, n_heads=2, chunk=seq_chunk
            ) if l.xlstm else None,
            d_ff=128 if l.d_ff else 0,
            moe=moe,
        )

    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=d_model,
        vocab_size=vocab,
        blocks=tuple(sh_layer(l) for l in cfg.blocks),
        n_repeat=n_repeat,
        prefix=tuple(sh_layer(l) for l in cfg.prefix),
        enc_blocks=tuple(sh_layer(l) for l in cfg.enc_blocks),
        enc_repeat=min(1, cfg.enc_repeat),
    )


# --------------------------------------------------------------- registry

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
