"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887 / 2408.12570.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Mamba : attention = 7 : 1 (one attention layer per 8-layer Jamba block,
at in-block index 4), MoE every second layer. No positional embedding —
Mamba layers carry position (hence attention rope_kind="none").
"""
from repro_torch.configs.common import register
from repro_torch.nn.config import AttnConfig, LayerSpec, MambaConfig, ModelConfig, MoEConfig

NAME = "jamba-1.5-large-398b"


@register(NAME)
def config() -> ModelConfig:
    attn = AttnConfig(
        n_heads=64, n_kv_heads=8, head_dim=128, rope_kind="none"
    )
    mamba = MambaConfig(d_state=16, d_conv=4, expand=2, chunk=256)
    moe = MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576)

    def layer(i: int) -> LayerSpec:
        kind = "attn" if i == 4 else "mamba"
        use_moe = i % 2 == 1
        return LayerSpec(
            kind=kind,
            attn=attn if kind == "attn" else None,
            mamba=mamba if kind == "mamba" else None,
            d_ff=0 if use_moe else 24576,
            moe=moe if use_moe else None,
        )

    return ModelConfig(
        name=NAME,
        family="hybrid",
        d_model=8192,
        vocab_size=65536,
        blocks=tuple(layer(i) for i in range(8)),
        n_repeat=9,  # 9 x 8 = 72 layers
        tie_embeddings=True,
        sub_quadratic=True,  # 7/8 of layers are Mamba -> long_500k eligible
    )
