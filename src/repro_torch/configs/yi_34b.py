"""yi-34b [dense] — arXiv:2403.04652. Llama-style GQA.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

TP note: 56 query heads do not divide the 16-way model axis; we pad to 64
heads (the standard Megatron head-padding tradeoff, ~14% attention-FLOP
waste, visible in the MODEL_FLOPS/HLO_FLOPS ratio — see DESIGN.md §6).
"""
from repro_torch.configs.common import register
from repro_torch.nn.config import AttnConfig, LayerSpec, ModelConfig

NAME = "yi-34b"
PAPER_N_HEADS = 56  # faithful head count (used for MODEL_FLOPS accounting)


@register(NAME)
def config() -> ModelConfig:
    attn = AttnConfig(
        n_heads=64,  # padded from 56 for TP16 divisibility
        n_kv_heads=8,
        head_dim=128,
        rope_theta=5_000_000.0,
    )
    return ModelConfig(
        name=NAME,
        family="dense",
        d_model=7168,
        vocab_size=64000,
        blocks=(LayerSpec(kind="attn", attn=attn, d_ff=20480),),
        n_repeat=60,
        tie_embeddings=False,
    )
