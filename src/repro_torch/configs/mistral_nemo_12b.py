"""mistral-nemo-12b [dense]: 128k ctx, head_dim 128 (not d/H).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=131_072,
    head_dim=128,
    rope_theta=1_000_000.0,
)
