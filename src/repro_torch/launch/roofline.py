"""Analytic model FLOPs from a config: ``6·N_active·tokens`` for training,
``2·N_active·tokens`` for a forward pass. The stage-2 judge prices its
prefill with :func:`model_flops` (``core/judge_pipeline.judge_token_cost``).

The compiled-HLO roofline (collective parser, per-device terms against
fixed hardware constants) is not ported yet: it belongs to the launch and
dry-run layer (ROADMAP).
"""
from __future__ import annotations

from repro_torch.nn.config import LayerSpec, ModelConfig


def _layer_params(l: LayerSpec, d: int, paper_heads: int | None = None) -> tuple[int, int]:
    """(active_params, total_params) of one layer (channel+seq mixers)."""
    act = tot = 0
    if l.kind == "attn":
        a = l.attn
        if a.kind == "mla":
            p = d * (a.kv_lora_rank + a.qk_rope_dim)
            if a.q_lora_rank:
                p += d * a.q_lora_rank + a.q_lora_rank * a.n_heads * (
                    a.qk_nope_dim + a.qk_rope_dim
                )
            else:
                p += d * a.n_heads * (a.qk_nope_dim + a.qk_rope_dim)
            p += a.n_heads * a.qk_nope_dim * a.kv_lora_rank
            p += a.n_heads * a.kv_lora_rank * a.v_head_dim
            p += a.n_heads * a.v_head_dim * d
        else:
            h = paper_heads or a.n_heads
            p = d * h * a.head_dim * 2 + d * a.n_kv_heads * a.head_dim * 2
        act += p
        tot += p
        if l.cross_attn:
            ca = d * a.n_heads * a.head_dim * 2 + d * a.n_kv_heads * a.head_dim * 2
            act += ca
            tot += ca
    elif l.kind == "mamba":
        m = l.mamba
        di = m.expand * d
        dtr = m.dt_rank or -(-d // 16)
        p = d * 2 * di + m.d_conv * di + di * (dtr + 2 * m.d_state) + \
            dtr * di + di * d
        act += p
        tot += p
    elif l.kind == "mlstm":
        xc = l.xlstm
        di = int(xc.proj_factor * d)
        p = d * 2 * di + 3 * di * di + di * d
        act += p
        tot += p
    elif l.kind == "slstm":
        xc = l.xlstm
        dh = d // xc.n_heads
        p = d * 4 * d + xc.n_heads * dh * 4 * dh + d * d
        act += p
        tot += p
    if l.moe is not None:
        mo = l.moe
        routed_one = 3 * d * mo.d_ff_expert
        act += mo.top_k * routed_one
        tot += mo.n_experts * routed_one
        act += d * mo.n_experts  # router
        tot += d * mo.n_experts
        if mo.n_shared:
            sh = 3 * d * (mo.d_ff_shared or mo.d_ff_expert * mo.n_shared)
            act += sh
            tot += sh
    elif l.d_ff:
        n_mats = 3 if l.ffn_act == "swiglu" else 2
        act += n_mats * d * l.d_ff
        tot += n_mats * d * l.d_ff
    return act, tot


def active_params(cfg: ModelConfig, paper_heads: int | None = None) -> tuple[int, int]:
    """(active, total) parameter counts — analytic, from the config."""
    act = tot = 0
    for l in cfg.layer_iter():
        a, t = _layer_params(l, cfg.d_model, paper_heads)
        act += a
        tot += t
    if cfg.enc_dec:
        for _ in range(cfg.enc_repeat):
            for l in cfg.enc_blocks:
                a, t = _layer_params(l, cfg.d_model, paper_heads)
                act += a
                tot += t
    # unembedding projection participates in compute
    act += cfg.d_model * cfg.vocab_size
    tot += cfg.d_model * cfg.vocab_size
    if not cfg.tie_embeddings:
        tot += cfg.d_model * cfg.vocab_size  # input table (gather only)
    return act, tot


def model_flops(cfg: ModelConfig, kind: str, tokens: int,
                paper_heads: int | None = None) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train) or 2·N_active·tokens
    (prefill/decode forward). Attention score/value FLOPs are intentionally
    excluded (the brief's 6·N·D definition); the useful-flops ratio then
    also exposes quadratic-attention overhead at long context."""
    act, _ = active_params(cfg, paper_heads)
    mult = 6.0 if kind == "train" else 2.0
    return mult * act * tokens
