"""qwen1.5-110b [dense] — hf:Qwen/Qwen1.5 family scaled per assignment.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias.
"""
from repro_torch.configs.common import register
from repro_torch.nn.config import AttnConfig, LayerSpec, ModelConfig

NAME = "qwen1.5-110b"


@register(NAME)
def config() -> ModelConfig:
    attn = AttnConfig(
        n_heads=64, n_kv_heads=8, head_dim=128, qkv_bias=True,
        rope_theta=1_000_000.0,
    )
    return ModelConfig(
        name=NAME,
        family="dense",
        d_model=8192,
        vocab_size=152064,
        blocks=(LayerSpec(kind="attn", attn=attn, d_ff=49152),),
        n_repeat=80,
        tie_embeddings=False,
    )
