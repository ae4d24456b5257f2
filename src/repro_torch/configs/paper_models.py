"""The paper's own models (Cortex §6.1):

* search-r1-7b  — the search agent (Qwen2.5-7B backbone, post-trained).
* qwen3-8b-code — the coding agent.
* qwen3-0.6b    — the embedding model AND the lightweight semantic judge
                  (LSM); the judge runs prefill-only classification
                  (single-token output), which is what makes co-location
                  cheap (paper §4.4).
"""
from repro_torch.configs.common import register
from repro_torch.nn.config import AttnConfig, LayerSpec, ModelConfig


@register("search-r1-7b")
def search_r1_7b() -> ModelConfig:
    attn = AttnConfig(
        n_heads=32,  # padded from 28 for TP16 (Qwen2.5-7B has 28H)
        n_kv_heads=4, head_dim=128, qkv_bias=True, rope_theta=1_000_000.0,
    )
    return ModelConfig(
        name="search-r1-7b",
        family="dense",
        d_model=3584,
        vocab_size=152064,
        blocks=(LayerSpec(kind="attn", attn=attn, d_ff=18944),),
        n_repeat=28,
        tie_embeddings=False,
    )


@register("qwen3-8b-code")
def qwen3_8b_code() -> ModelConfig:
    attn = AttnConfig(
        n_heads=32, n_kv_heads=8, head_dim=128, rope_theta=1_000_000.0
    )
    return ModelConfig(
        name="qwen3-8b-code",
        family="dense",
        d_model=4096,
        vocab_size=151936,
        blocks=(LayerSpec(kind="attn", attn=attn, d_ff=12288),),
        n_repeat=36,
        tie_embeddings=False,
    )


@register("qwen3-0.6b")
def qwen3_0_6b() -> ModelConfig:
    attn = AttnConfig(
        n_heads=16, n_kv_heads=8, head_dim=128, rope_theta=1_000_000.0
    )
    return ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        d_model=1024,
        vocab_size=151936,
        blocks=(LayerSpec(kind="attn", attn=attn, d_ff=3072),),
        n_repeat=28,
        tie_embeddings=True,
    )
