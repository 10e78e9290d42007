"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block
applied every 6 SSM layers. [arXiv:2411.15242; hf]"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    head_dim=64,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    rope_theta=10_000.0,
    supports_long=True,   # SSM state is O(1); attention cache is linear
)
