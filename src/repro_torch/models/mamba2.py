"""Mamba2 (SSD) block: chunked state-space duality, on the port's scan kernel.

The port of ``repro/models/mamba2.py``. Prefill splits the chunked SSD
the way the TPU kernel's docstring describes
(``repro/kernels/mamba2_scan.py``): every chunk's intra-chunk term, its
state decay ``exp(cl[:, -1])`` and its state increment are computed at
once with batched products; only the inter-chunk recurrence
``s_{c+1} = decay_c * s_c + inc_c`` is sequential, and it runs through
:func:`repro_torch.kernels.ops.mamba2_chunk_scan` with batch folded into
heads, ``(C, B*H, P*N)``. The states entering each chunk then give the
inter-chunk output term. Decode carries (conv window, SSD state) and
costs O(1) per token.

Layout: heads H = d_inner / P with P = ``ssm_head_dim``; a single B/C
group is shared across heads (n_groups = 1).
"""

from __future__ import annotations

import torch

from ..kernels import ops
from .config import ArchConfig
from .layers import dense_init, rmsnorm, swish

__all__ = [
    "init_mamba2",
    "mamba2_train",
    "mamba2_decode",
    "init_mamba2_cache",
    "mamba2_dims",
]


def mamba2_dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    d_inner = 2 * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    n_state = cfg.ssm_state
    conv_dim = d_inner + 2 * n_state
    return d_inner, n_heads, n_state, conv_dim


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict[str, torch.Tensor]:
    d = cfg.d_model
    d_inner, nh, n, conv_dim = mamba2_dims(cfg)
    d_in_proj = 2 * d_inner + 2 * n + nh  # [z, x, B, C, dt]
    return {
        "in_proj": dense_init(gen, (d, d_in_proj), device=device),
        "conv_w": dense_init(gen, (conv_dim, cfg.ssm_conv_width), device=device) * 0.5,
        "conv_b": torch.zeros(conv_dim, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)),
        "dt_bias": torch.zeros(nh, device=device),
        "D": torch.ones(nh, device=device),
        "norm_w": torch.ones(d_inner, device=device),
        "out_proj": dense_init(gen, (d_inner, d), fan_in=d_inner, device=device),
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    d_inner, nh, n, _ = mamba2_dims(cfg)
    return proj.split([d_inner, d_inner, n, n, nh], dim=-1)  # z, x, B, C, dt


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: torch.Tensor | None = None):
    """Depthwise causal conv. seq: (B, L, C); w: (C, W)."""
    bsz, l, c = seq.shape
    width = w.shape[1]
    if init_state is None:
        init_state = torch.zeros((bsz, width - 1, c), dtype=seq.dtype, device=seq.device)
    padded = torch.cat([init_state, seq], dim=1)
    out = torch.zeros((bsz, l, c), dtype=torch.float32, device=seq.device)
    for i in range(width):
        out = out + padded[:, i : i + l, :].float() * w[:, i]
    out = out + b
    new_state = padded[:, l:, :]  # last (W-1) inputs
    return swish(out).to(seq.dtype), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssd_chunked(x, dt, a_log, b, c, chunk: int):
    """Chunked SSD. x: (B,L,H,P); dt: (B,L,H); a_log = dt*A (B,L,H);
    b, c: (B,L,N), all float32. Returns y (B,L,H,P) and the final state
    (B,H,P,N)."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"sequence length {l} is not a multiple of the chunk {q}")
    nc = l // q
    xc = x.reshape(bsz, nc, q, h, p)
    bc = b.reshape(bsz, nc, q, n)
    cc = c.reshape(bsz, nc, q, n)
    cl = torch.cumsum(a_log.reshape(bsz, nc, q, h), dim=2)          # (B,C,q,H)
    xdt = xc * dt.reshape(bsz, nc, q, h)[..., None]                  # (B,C,q,H,P)
    # Intra-chunk (attention-like) term, every chunk at once.
    tril = torch.ones((q, q), dtype=torch.float32, device=x.device).tril()
    lmat = torch.exp(
        (cl[:, :, :, None, :] - cl[:, :, None, :, :]).clamp(-60.0, 0.0)
    ) * tril[None, None, :, :, None]                                 # (B,C,q,q,H)
    scores = torch.einsum("bcqn,bckn->bcqk", cc, bc)                 # (B,C,q,q)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores[..., None] * lmat, xdt)
    # Each chunk's state decay and increment; the recurrence runs in the kernel.
    rev = torch.exp(cl[:, :, -1:, :] - cl)                           # (B,C,q,H)
    inc = torch.einsum("bcqhp,bcqn->cbhpn", xdt * rev[..., None], bc)
    decay = torch.exp(cl[:, :, -1, :]).transpose(0, 1)               # (C,B,H)
    states, final = ops.mamba2_chunk_scan(
        decay.reshape(nc, bsz * h).contiguous(),
        inc.reshape(nc, bsz * h, p * n).contiguous(),
    )
    states = states.view(nc, bsz, h, p, n)
    # Contribution of the state entering each chunk.
    y_inter = torch.einsum("bcqn,cbhpn->bcqhp", cc, states) * torch.exp(cl)[..., None]
    y = (y_intra + y_inter).reshape(bsz, l, h, p)
    return y, final.view(bsz, h, p, n)


def mamba2_train(p, x: torch.Tensor, cfg: ArchConfig, chunk: int = 128,
                 return_state: bool = False):
    """x: (B, L, D) -> (B, L, D) [+ decode cache when return_state]."""
    bsz, l, d = x.shape
    d_inner, nh, n, conv_dim = mamba2_dims(cfg)
    proj = x @ p["in_proj"].to(x.dtype)
    z, xc, b, c, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xc, b, c], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    xc, b, c = conv_out.split([d_inner, n, n], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])                     # (H,) negative
    a_log = dt * a                                 # log decay per step
    xh = xc.reshape(bsz, l, nh, cfg.ssm_head_dim).float()
    y, final = _ssd_chunked(xh, dt, a_log, b.float(), c.float(), chunk)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(bsz, l, d_inner).to(x.dtype)
    y = rmsnorm(y * swish(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        return out, {"conv": conv_state.float(), "ssm": final}
    return out


def init_mamba2_cache(batch: int, cfg: ArchConfig, device=None,
                      dtype=torch.float32) -> dict[str, torch.Tensor]:
    d_inner, nh, n, conv_dim = mamba2_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, cfg.ssm_head_dim, n), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(p, x: torch.Tensor, cache: dict[str, torch.Tensor], cfg: ArchConfig):
    """One-token step. x: (B, 1, D). Returns (y (B, 1, D), new cache)."""
    bsz = x.shape[0]
    d_inner, nh, n, conv_dim = mamba2_dims(cfg)
    proj = x @ p["in_proj"].to(x.dtype)
    z, xc, b, c, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xc, b, c], dim=-1)
    conv_out, conv_state = _causal_conv(
        conv_in, p["conv_w"], p["conv_b"], cache["conv"].to(conv_in.dtype)
    )
    xc, b, c = conv_out.split([d_inner, n, n], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])[:, 0]          # (B,H)
    a = -torch.exp(p["A_log"])
    decay = torch.exp(dt * a)                                  # (B,H)
    xh = xc[:, 0].reshape(bsz, nh, cfg.ssm_head_dim).float()
    xdt = xh * dt[..., None]                                   # (B,H,P)
    inc = xdt[..., None] * b[:, 0].float()[:, None, None, :]   # (B,H,P,N)
    state = decay[:, :, None, None] * cache["ssm"] + inc
    y = torch.einsum("bn,bhpn->bhp", c[:, 0].float(), state)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = rmsnorm(y * swish(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"conv": conv_state.to(cache["conv"].dtype), "ssm": state}

