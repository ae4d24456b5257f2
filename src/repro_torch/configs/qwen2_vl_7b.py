"""qwen2-vl-7b [vlm] — arXiv:2409.12191.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064. M-RoPE with
sections (16, 24, 24); dynamic-resolution vision frontend is a STUB —
the caller supplies precomputed patch embeddings + a frontend mask
(``LM.prefill``'s ``frontend_emb``/``frontend_mask``; backbone-only per
the assignment).

TP note: 28 query heads padded to 32 for the 16-way model axis
(see DESIGN.md §6); kv=4 heads are replicated under TP16.
"""
from repro_torch.configs.common import register
from repro_torch.nn.config import AttnConfig, LayerSpec, ModelConfig

NAME = "qwen2-vl-7b"
PAPER_N_HEADS = 28


@register(NAME)
def config() -> ModelConfig:
    attn = AttnConfig(
        n_heads=32,  # padded from 28 for TP16 divisibility
        n_kv_heads=4,
        head_dim=128,
        rope_kind="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        qkv_bias=True,
    )
    return ModelConfig(
        name=NAME,
        family="vlm",
        d_model=3584,
        vocab_size=152064,
        blocks=(LayerSpec(kind="attn", attn=attn, d_ff=18944),),
        n_repeat=28,
        tie_embeddings=False,
        frontend="vision",
    )
