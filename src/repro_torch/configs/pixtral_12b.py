"""pixtral-12b [vlm]: pixtral-ViT frontend (stub) + mistral-nemo
backbone. input_specs provide precomputed patch+text embeddings.
[hf:mistralai/Pixtral-12B-2409; unverified]"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=131_072,
    head_dim=128,
    frontend="vision_stub",
    rope_theta=1_000_000.0,
)
