"""Architecture configuration schema for the model zoo."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Literal

__all__ = ["ArchConfig", "reduced"]

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads
    # attention / embedding details
    qkv_bias: bool = False         # qwen1.5
    rope_theta: float = 10_000.0
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["swiglu", "gelu"] = "swiglu"
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False   # arctic: dense FFN + MoE in parallel
    capacity_factor: float = 1.25
    # SSM (mamba2) / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64         # P
    ssm_conv_width: int = 4
    attn_every: int = 0            # hybrid: shared attn after every k SSM layers
    # xLSTM
    slstm_every: int = 0           # sLSTM block every k layers (else mLSTM)
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 0        # fixed encoder length (audio stub)
    # modality frontend stub: token ids vs precomputed embeddings
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    max_seq_len: int = 524_288
    norm_eps: float = 1e-5
    # which shapes are valid for this arch (DESIGN.md §Arch-applicability)
    supports_decode: bool = True
    supports_long: bool = False    # sub-quadratic path for 500k context

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def n_params(self) -> int:
        """Total parameter count (approx; exact for the dense parts)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.frontend != "none":
            emb = self.vocab_size * d  # decoder head only; frontend is a stub
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            attn = d * self.n_heads * hd + d * hd * self.n_kv_heads * 2 \
                + self.n_heads * hd * d
            ffn_mults = 3 if self.act == "swiglu" else 2
            if self.n_experts:
                ffn = self.n_experts * ffn_mults * d * self.d_ff \
                    + d * self.n_experts  # router
                if self.moe_dense_residual:
                    ffn += ffn_mults * d * self.d_ff
            else:
                ffn = ffn_mults * d * self.d_ff
            per_layer = attn + ffn + 2 * d
        elif self.family in ("hybrid", "ssm"):
            if self.ssm_state:  # mamba2 block
                dinner = 2 * d
                nh = dinner // self.ssm_head_dim
                per_layer = d * (2 * dinner + 2 * self.ssm_state + nh) \
                    + dinner * d + 2 * d
            else:  # xlstm
                per_layer = 8 * d * d
        total = emb + self.n_layers * per_layer
        if self.attn_every:  # one shared attention block (zamba2)
            total += 4 * d * self.n_heads * hd + 3 * d * self.d_ff
        if self.is_encoder_decoder:
            attn = 4 * d * d
            ffn = 2 * d * self.d_ff
            total += self.encoder_layers * (attn + ffn + 2 * d)
            total += self.n_layers * (attn + 2 * d)  # decoder cross-attn
        return int(total)

    def active_params(self) -> int:
        """Active (per-token) params — for MoE 6*N_active*D accounting."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        ffn_mults = 3 if self.act == "swiglu" else 2
        inactive = (self.n_experts - self.top_k) * ffn_mults * d * self.d_ff
        return int(self.n_params() - self.n_layers * inactive)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Smoke-test configuration of the same family: tiny but structurally
    identical (same block pattern, same divisibility properties)."""
    small = dict(
        n_layers=min(cfg.n_layers, 4 if not cfg.attn_every else 8),
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=64,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        slstm_every=min(cfg.slstm_every, 3) if cfg.slstm_every else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_frames=min(cfg.encoder_frames, 64),
        max_seq_len=4096,
    )
    small.update(overrides)
    return replace(cfg, name=cfg.name + "-smoke", **small)
