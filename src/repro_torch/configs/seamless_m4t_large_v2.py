"""seamless-m4t-large-v2 [audio] — arXiv:2308.11596. Encoder-decoder.

24L d_model=1024 16H (GQA kv=16 = MHA) d_ff=8192 vocab=256206 (padded to
256256 for 16-way vocab sharding). The speech frontend (w2v-BERT conformer
feature extractor) is a STUB: precomputed frame
embeddings (B, S, D) are consumed by the text-transformer encoder backbone;
the decoder is the autoregressive text decoder with cross-attention.
"24L" is interpreted as 24 encoder + 24 decoder backbone layers (the real
model's per-stack depth); decode shapes exercise the decoder.
"""
from repro_torch.configs.common import register
from repro_torch.nn.config import AttnConfig, LayerSpec, ModelConfig

NAME = "seamless-m4t-large-v2"
PAPER_VOCAB = 256206


@register(NAME)
def config() -> ModelConfig:
    attn = AttnConfig(n_heads=16, n_kv_heads=16, head_dim=64)
    enc = LayerSpec(kind="attn", attn=attn, d_ff=8192, ffn_act="gelu")
    dec = LayerSpec(
        kind="attn", attn=attn, d_ff=8192, ffn_act="gelu", cross_attn=True
    )
    return ModelConfig(
        name=NAME,
        family="audio",
        d_model=1024,
        vocab_size=256256,  # padded from 256206 (multiple of 128)
        blocks=(dec,),
        n_repeat=24,
        enc_dec=True,
        enc_blocks=(enc,),
        enc_repeat=24,
        tie_embeddings=True,
        frontend="audio",
    )
