"""dbrx-132b [moe]: 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10_752,
    vocab_size=100_352,
    n_experts=16,
    top_k=4,
    rope_theta=500_000.0,
)
