"""Plain PyTorch versions of the main-path kernels.

Each function is the ground truth its CUDA kernel is held against, on
the card (``chip_smoke.py``, the ``gpu``-marked tests), and the
function the kernel wrapper runs for a tensor that lies on the CPU.
They repeat the arithmetic of the JAX package's oracles
(``repro/kernels/ref.py``) operation by operation, in float32, so that
the CPU tests can hold them against that package. The backward versions
(``*_bwd_ref``) have no oracle there (the JAX package differentiates
plain ``jnp``): they write the gradient out from its formulas, and the
CPU tests hold them against ``jax.vjp`` of the forward oracles.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "color_deconv_ref",
    "morph_recon_ref",
    "sobel_stats_ref",
    "feature_fused_ref",
    "flash_attention_ref",
    "flash_attention_fwd_ref",
    "flash_attention_bwd_ref",
    "decode_attention_ref",
    "mamba2_chunk_scan_ref",
    "mamba2_chunk_scan_bwd_ref",
    "DECONV_MATRIX",
    "GRAY_WEIGHTS",
]

#: ITU-R BT.601 luminance weights (matches app.segmentation.to_gray).
GRAY_WEIGHTS = (0.299, 0.587, 0.114)

# Ruifrok & Johnston H&E(+residual); rows = stain OD vectors.
_STAINS = np.array(
    [
        [0.650, 0.704, 0.286],
        [0.072, 0.990, 0.105],
        [0.268, 0.570, 0.776],
    ],
    dtype=np.float32,
)
DECONV_MATRIX = np.linalg.inv(_STAINS.T).astype(np.float32)

# The matrix as Python floats: a float32 tensor times a Python scalar
# computes in float32, exactly as the float32 numpy scalar does in jnp.
_M = tuple(tuple(float(x) for x in row) for row in DECONV_MATRIX)


def _od(x: torch.Tensor) -> torch.Tensor:
    return -torch.log10((x.float() + 1.0) / 256.0)


def color_deconv_ref(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """(H,W)x3 uint8/float planes -> 3 stain-density planes."""
    odr, odg, odb = _od(r), _od(g), _od(b)
    m = _M
    hema = m[0][0] * odr + m[0][1] * odg + m[0][2] * odb
    eosin = m[1][0] * odr + m[1][1] * odg + m[1][2] * odb
    resid = m[2][0] * odr + m[2][1] * odg + m[2][2] * odb
    return hema, eosin, resid


def dilate8(a: torch.Tensor) -> torch.Tensor:
    """3x3 max of a float plane, -inf beyond the edges (reduce_window's
    init in the oracle)."""
    return F.max_pool2d(a[None, None], 3, stride=1, padding=1)[0, 0]


def morph_recon_ref(marker: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Grayscale morphological reconstruction (8-conn geodesic fixpoint),
    one Jacobi sweep at a time; each sweep reads one flag on the host."""
    mask = mask.float()
    r = torch.minimum(marker.float(), mask)
    while True:
        nxt = torch.minimum(dilate8(r), mask)
        if torch.equal(nxt, r):
            return r
        r = nxt


def sobel_stats_ref(gray: torch.Tensor):
    """Sobel |grad| (edge-replicated) + moment sums (sum, sumsq, max)."""
    g = gray.float()
    h, w = g.shape
    p = F.pad(g[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    sl = lambda dy, dx: p[dy : dy + h, dx : dx + w]  # noqa: E731
    gx = (
        -1 * sl(0, 0) + 1 * sl(0, 2)
        - 2 * sl(1, 0) + 2 * sl(1, 2)
        - 1 * sl(2, 0) + 1 * sl(2, 2)
    )
    gy = (
        -1 * sl(0, 0) - 2 * sl(0, 1) - 1 * sl(0, 2)
        + 1 * sl(2, 0) + 2 * sl(2, 1) + 1 * sl(2, 2)
    )
    mag = torch.sqrt(gx * gx + gy * gy)
    stats = torch.stack([mag.sum(), (mag * mag).sum(), mag.max()])
    return mag, stats


def gray_ref(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    wr, wg, wb = GRAY_WEIGHTS
    return wr * r.float() + wg * g.float() + wb * b.float()


def feature_fused_ref(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """Composed version of the fused feature kernel: ``(hema, eosin,
    mag, stats)`` with ``stats = [h_sum, h_sumsq, h_max, g_sum,
    g_sumsq, g_max]``."""
    hema, eosin, _ = color_deconv_ref(r, g, b)
    mag, gstats = sobel_stats_ref(gray_ref(r, g, b))
    hstats = torch.stack([hema.sum(), (hema * hema).sum(), hema.max()])
    return hema, eosin, mag, torch.cat([hstats, gstats])


def _kv_heads(x: torch.Tensor, group: int, dim: int) -> torch.Tensor:
    """KV heads repeated so that q head ``h`` meets kv head ``h // group``."""
    return x if group == 1 else x.repeat_interleave(group, dim=dim)


def _flash_logits(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled float32 scores (B, H, S, S), -inf above the diagonal when causal."""
    group = q.shape[1] // k.shape[1]
    s, d = q.shape[2], q.shape[3]
    kf = _kv_heads(k, group, 1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (1.0 / np.sqrt(d))
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    return logits


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref`'s output and the float32 log-sum-exp of
    each row's scaled scores (B, H, S), which the backward takes."""
    group = q.shape[1] // k.shape[1]
    logits = _flash_logits(q, k, causal)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, _kv_heads(v, group, 1).float()).to(q.dtype)
    return out, torch.logsumexp(logits, dim=-1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """(B, H, S, D) attention with optional causal mask; float32 softmax.
    k/v may carry fewer heads (B, Hkv, S, D): q head ``h`` reads kv head
    ``h // (H // Hkv)``. Output in q's dtype."""
    return flash_attention_fwd_ref(q, k, v, causal)[0]


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True):
    """Gradients (dq, dk, dv) of ``out`` = attention(q, k, v), in float32
    from the formulas, each returned in its input's type. P is recomputed
    from q, k and the forward's row log-sum-exp ``lse``; with Dvec =
    rowsum(dout * out): dV = P^T dO, dP = dO V^T, dS = P (dP - Dvec),
    dQ = dS K scale, dK = dS^T Q scale. dk and dv sum over the query
    heads sharing a KV head."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    scale = 1.0 / np.sqrt(d)
    p = torch.exp(_flash_logits(q, k, causal) - lse.float()[..., None])
    dof = dout.float()
    dvec = (dof * out.float()).sum(-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, _kv_heads(v, group, 1).float())
    ds = p * (dp - dvec[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _kv_heads(k, group, 1).float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dk = dk.view(b, hkv, group, s, d).sum(2)
    dv = dv.view(b, hkv, group, s, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, return_lse: bool = False):
    """Single-token attention against a KV cache.

    q: (B, Hq, D); k/v: (B, Hkv, S, D); lengths: (B,) valid cache length
    (positions ``< lengths`` attend). GQA: query head i reads kv head
    ``i // (Hq // Hkv)``. Output in q's dtype. With ``return_lse`` ->
    (out, lse), lse (B, Hq) float32 the natural-log log-sum-exp of each
    row's scaled scores, and where a row has no key (a length of 0) out
    0 and lse -inf, as the kernel gives them.
    """
    group = q.shape[1] // k.shape[1]
    s, d = k.shape[2], q.shape[2]
    kf = _kv_heads(k, group, 1).float()
    vf = _kv_heads(v, group, 1).float()
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kf) * (1.0 / np.sqrt(d))
    pos = torch.arange(s, device=q.device)
    valid = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    logits = logits.masked_fill(~valid, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", p, vf).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits, dim=-1)
    return torch.where(torch.isneginf(lse)[..., None], torch.zeros_like(out), out), lse


def mamba2_chunk_scan_ref(decay: torch.Tensor, inc: torch.Tensor):
    """Inter-chunk SSD state recurrence.

    decay: (C, H) float32 per-chunk state decay; inc: (C, H, F) per-chunk
    state increment (F = P*N flattened). Returns the states *entering*
    each chunk (C, H, F) and the final state (H, F), in inc's dtype:

        s_0 = 0;  s_{c+1} = decay_c * s_c + inc_c   (float32 carry)
    """
    c, h, f = inc.shape
    s = torch.zeros((h, f), dtype=torch.float32, device=inc.device)
    states = torch.empty_like(inc)
    for i in range(c):
        states[i] = s.to(inc.dtype)
        s = decay[i].float()[:, None] * s + inc[i].float()
    return states, s.to(inc.dtype)


def mamba2_chunk_scan_bwd_ref(decay: torch.Tensor, states: torch.Tensor,
                              g_states: torch.Tensor | None, g_final: torch.Tensor | None):
    """Gradients of :func:`mamba2_chunk_scan_ref` from the states it
    returned and the gradients of its outputs (None: zeros): the adjoint
    recurrence run backwards with a float32 carry,

        lam_C = g_final;  g_inc[c] = lam_{c+1};
        g_decay[c, h] = sum_f lam_{c+1}[h, f] states[c, h, f];
        lam_c = decay_c * lam_{c+1} + g_states[c].

    Returns (g_decay (C, H) float32, g_inc (C, H, F) in the states' type)."""
    c, h, f = states.shape
    lam = (torch.zeros((h, f), dtype=torch.float32, device=states.device)
           if g_final is None else g_final.float())
    g_inc = torch.empty_like(states)
    g_decay = torch.empty((c, h), dtype=torch.float32, device=states.device)
    for i in reversed(range(c)):
        g_inc[i] = lam.to(states.dtype)
        g_decay[i] = (lam * states[i].float()).sum(-1)
        lam = decay[i].float()[:, None] * lam
        if g_states is not None:
            lam = lam + g_states[i].float()
    return g_decay, g_inc
