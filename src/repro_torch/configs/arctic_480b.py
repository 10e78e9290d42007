"""arctic-480b [moe]: 128 experts top-2 with a parallel dense residual
FFN (dense-MoE hybrid). [hf:Snowflake/snowflake-arctic-base; hf]"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    rope_theta=10_000.0,
)
