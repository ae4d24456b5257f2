"""xlstm-350m [ssm] — arXiv:2405.04517 (xLSTM[7:1]).

24L d_model=1024 4H vocab=50304, d_ff=0 (no separate FFN; the mLSTM block
carries a 2x up-projection internally). Superblock = 7 mLSTM + 1 sLSTM,
repeated 3x. O(1) recurrent state -> long_500k eligible.
"""
from repro_torch.configs.common import register
from repro_torch.nn.config import LayerSpec, ModelConfig, XLSTMConfig

NAME = "xlstm-350m"


@register(NAME)
def config() -> ModelConfig:
    ml = LayerSpec(
        kind="mlstm",
        xlstm=XLSTMConfig(kind="mlstm", n_heads=4, proj_factor=2.0, chunk=128),
    )
    sl = LayerSpec(
        kind="slstm",
        xlstm=XLSTMConfig(kind="slstm", n_heads=4),
    )
    return ModelConfig(
        name=NAME,
        family="ssm",
        d_model=1024,
        vocab_size=50304,
        blocks=(ml,) * 7 + (sl,),
        n_repeat=3,  # 3 x 8 = 24 layers
        tie_embeddings=True,
        sub_quadratic=True,
    )
