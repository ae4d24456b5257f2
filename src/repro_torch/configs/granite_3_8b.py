"""granite-3-8b [dense] — hf:ibm-granite/granite-3.0 family. GQA.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155 (padded to 49280
for 16-way vocab sharding divisibility; labels never reach pad ids).
"""
from repro_torch.configs.common import register
from repro_torch.nn.config import AttnConfig, LayerSpec, ModelConfig

NAME = "granite-3-8b"
PAPER_VOCAB = 49155


@register(NAME)
def config() -> ModelConfig:
    attn = AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                      rope_theta=10_000_000.0)
    return ModelConfig(
        name=NAME,
        family="dense",
        d_model=4096,
        vocab_size=49280,  # padded from 49155 (multiple of 128)
        blocks=(LayerSpec(kind="attn", attn=attn, d_ff=12800),),
        n_repeat=40,
        tie_embeddings=True,
    )
