"""whisper-small [audio]: enc-dec; conv frontend is a stub — the
input_specs provide precomputed (batch, 1500, d_model) frame embeddings.
[arXiv:2212.04356; unverified]

Note (DESIGN.md): the real model caps the decoder at 448 positions;
decode_32k is exercised mechanically per the assignment.  long_500k is
skipped (full attention).
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,             # decoder layers
    encoder_layers=12,
    encoder_frames=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    norm="layernorm",
    act="gelu",
    frontend="audio_stub",
    rope_theta=10_000.0,     # deviation: RoPE instead of learned pos-emb
)
