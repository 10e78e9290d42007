"""xlstm-125m [ssm]: sLSTM + mLSTM blocks (xLSTM[7:1]-style interleave).
[arXiv:2405.04517; unverified]"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,              # xLSTM blocks carry their own projections
    vocab_size=50_304,
    head_dim=192,
    slstm_every=6,       # sLSTM at layers 1 and 7
    rope_theta=0.0,
    supports_long=True,  # recurrent state is O(1)
)
