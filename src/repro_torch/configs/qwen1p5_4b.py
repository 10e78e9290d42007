"""qwen1.5-4b [dense]: QKV bias, MHA (kv == q heads).
[hf:Qwen/Qwen1.5-0.5B scaled per assignment; hf]"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
