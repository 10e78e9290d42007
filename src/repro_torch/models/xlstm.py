"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM
(scalar memory, sequential), the port of ``repro/models/xlstm.py``.

mLSTM is a gated linear-attention cell: with input gate ``i_t = exp(ĩ)``
and forget gate ``f_t = sigma(f̃)`` the parallel form is

    h_t = o_t * (Sum_j exp(cl_t - cl_j + ĩ_j - m_t) (q_t.k_j) v_j) / n_t

computed here in chunks of 128 with an inter-chunk (C, n, m) running
state: a Python loop over chunks, each chunk's terms batched products.
sLSTM keeps per-unit scalar cells with recurrent weights and runs
sequentially: a Python loop over time steps where the reference scans
(the input's pre-activations for every step are one product before the
loop). Gates, cells and states stay in float32, as in the reference;
the cells' ``m`` starts at -1e30 (mLSTM) and -30 (sLSTM). Both decode in
O(1) per token. No attention kernel is involved.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import dense_init, rmsnorm, swish

__all__ = [
    "init_mlstm", "mlstm_train", "mlstm_decode", "init_mlstm_cache",
    "init_slstm", "slstm_train", "slstm_decode", "init_slstm_cache",
]

_CHUNK = 128


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return {
        "w_up": dense_init(gen, (d, 2 * d), device=device),  # [cell input u, gate z]
        "wq": dense_init(gen, (d, h, dh), device=device),
        "wk": dense_init(gen, (d, h, dh), device=device),
        "wv": dense_init(gen, (d, h, dh), device=device),
        "w_if": dense_init(gen, (d, 2 * h), device=device).mul_(0.1),  # input/forget pre-acts
        "b_if": torch.cat([torch.zeros(h, device=device), torch.full((h,), 3.0, device=device)]),
        "norm_w": torch.ones(d, device=device),
        "w_down": dense_init(gen, (d, d), device=device),
    }


def _mlstm_gates(p, u: torch.Tensor):
    """u: (B,L,D) -> log input gate ĩ, log forget gate (B,L,H), float32."""
    pre = u.float() @ p["w_if"].float() + p["b_if"]
    h = pre.shape[-1] // 2
    return pre[..., :h], F.logsigmoid(pre[..., h:])


def _heads(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u (B, L, D) through w (D, H, Dh) -> (B, L, H, Dh) in u's type."""
    d, h, dh = w.shape
    return (u @ w.to(u.dtype).reshape(d, h * dh)).unflatten(-1, (h, dh))


def _mlstm_chunked(q, k, v, log_i, log_f, chunk: int = _CHUNK):
    """q/k/v: (B,L,H,Dh); gates: (B,L,H). Stabilised chunked mLSTM.

    Returns h (B,L,H,Dh) float32 and the final (C, n, m) state."""
    bsz, l, h, dh = q.shape
    qn = q / math.sqrt(dh)
    qch = min(chunk, l)
    if l % qch:
        raise ValueError(f"sequence length {l} is not a multiple of the chunk {qch}")
    nc = l // qch
    resh = lambda a: a.reshape(bsz, nc, qch, *a.shape[2:])  # noqa: E731
    qc, kc, vc, lic, lfc = map(resh, (qn, k, v, log_i, log_f))
    future = ~torch.ones((qch, qch), dtype=torch.bool, device=q.device).tril()
    c_st = torch.zeros((bsz, h, dh, dh), device=q.device)
    n_st = torch.zeros((bsz, h, dh), device=q.device)
    m_st = torch.full((bsz, h), -1e30, device=q.device)
    outs = []
    for i in range(nc):
        qb, kb, vb = qc[:, i].float(), kc[:, i].float(), vc[:, i].float()
        lib, lfb = lic[:, i], lfc[:, i]
        cl = lfb.cumsum(1)                                          # (B,q,H)
        # log weights of intra-chunk source j at target t.
        logw = cl[:, :, None, :] - cl[:, None, :, :] + lib[:, None, :, :]
        logw = logw.masked_fill(future[None, :, :, None], -math.inf)
        # state contribution carries log decay cl_t (+ running m).
        m_new = torch.maximum(logw.amax(dim=2), cl + m_st[:, None, :])  # (B,q,H)
        w = torch.exp(logw - m_new[:, :, None, :])                  # (B,q,q,H)
        sw = torch.einsum("bqhd,bkhd->bqkh", qb, kb) * w
        num_intra = torch.einsum("bqkh,bkhd->bqhd", sw, vb)
        den_intra = sw.sum(dim=2)
        s_scale = torch.exp(cl + m_st[:, None, :] - m_new)          # (B,q,H)
        num_state = torch.einsum("bqhd,bhde->bqhe", qb, c_st) * s_scale[..., None]
        den_state = torch.einsum("bqhd,bhd->bqh", qb, n_st) * s_scale
        num = num_intra + num_state
        den = den_intra + den_state
        outs.append(num / torch.maximum(den.abs()[..., None], torch.exp(-m_new)[..., None]))
        # Update the inter-chunk state.
        rev = cl[:, -1:, :] - cl + lib                              # (B,q,H)
        m_chunk = torch.maximum(m_st + cl[:, -1], rev.amax(dim=1))  # (B,H)
        dec = torch.exp(m_st + cl[:, -1] - m_chunk)
        wsrc = torch.exp(rev - m_chunk[:, None, :])                 # (B,q,H)
        c_st = dec[:, :, None, None] * c_st + torch.einsum("bqhd,bqhe,bqh->bhde", kb, vb, wsrc)
        n_st = dec[:, :, None] * n_st + torch.einsum("bqhd,bqh->bhd", kb, wsrc)
        m_st = m_chunk
    return torch.stack(outs, dim=1).reshape(bsz, l, h, dh), (c_st, n_st, m_st)


def mlstm_train(p, x: torch.Tensor, cfg: ArchConfig, return_state: bool = False):
    """x: (B, L, D) -> (B, L, D) [+ decode cache when return_state]."""
    bsz, l, d = x.shape
    u, z = (x @ p["w_up"].to(x.dtype)).chunk(2, dim=-1)
    q, k, v = (_heads(u, p[name]) for name in ("wq", "wk", "wv"))
    log_i, log_f = _mlstm_gates(p, u)
    hout, (c_f, n_f, m_f) = _mlstm_chunked(q, k, v, log_i, log_f)
    y = hout.reshape(bsz, l, d).to(x.dtype) * swish(z)
    y = rmsnorm(y, p["norm_w"], cfg.norm_eps)
    out = y @ p["w_down"].to(x.dtype)
    if return_state:
        return out, {"C": c_f, "n": n_f, "m": m_f}
    return out


def init_mlstm_cache(batch: int, cfg: ArchConfig, device=None) -> dict:
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    return {
        "C": torch.zeros((batch, h, dh, dh), device=device),
        "n": torch.zeros((batch, h, dh), device=device),
        "m": torch.full((batch, h), -1e30, device=device),
    }


def mlstm_decode(p, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One-token step. x: (B, 1, D). Returns (y (B, 1, D), new cache)."""
    bsz, _, d = x.shape
    dh = d // cfg.n_heads
    u, z = (x @ p["w_up"].to(x.dtype)).chunk(2, dim=-1)
    q = _heads(u[:, 0], p["wq"]).float() / math.sqrt(dh)           # (B,H,Dh)
    k = _heads(u[:, 0], p["wk"]).float()
    v = _heads(u[:, 0], p["wv"]).float()
    log_i, log_f = _mlstm_gates(p, u)
    li, lf = log_i[:, 0], log_f[:, 0]                               # (B,H)
    m_new = torch.maximum(cache["m"] + lf, li)
    dec = torch.exp(cache["m"] + lf - m_new)
    src = torch.exp(li - m_new)
    c_new = dec[..., None, None] * cache["C"] + src[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = dec[..., None] * cache["n"] + src[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, c_new)
    den = torch.einsum("bhd,bhd->bh", q, n_new)
    h = num / torch.maximum(den.abs()[..., None], torch.exp(-m_new)[..., None])
    y = h.reshape(bsz, 1, d).to(x.dtype) * swish(z)
    y = rmsnorm(y, p["norm_w"], cfg.norm_eps)
    out = y @ p["w_down"].to(x.dtype)
    return out, {"C": c_new, "n": n_new, "m": m_new}


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    d = cfg.d_model
    return {
        # pre-activations for (z, i, f, o) from input and recurrent h
        "w_x": dense_init(gen, (d, 4 * d), device=device),
        "w_h": dense_init(gen, (d, 4 * d), device=device).mul_(0.5),
        "b": torch.cat([torch.zeros(2 * d, device=device), torch.full((d,), 3.0, device=device),
                        torch.zeros(d, device=device)]),
        "norm_w": torch.ones(d, device=device),
        "w_down": dense_init(gen, (d, d), device=device),
    }


def _slstm_inputs(p, x: torch.Tensor) -> torch.Tensor:
    """The input's share of the pre-activations, ``x @ w_x + b``, float32."""
    return x.float() @ p["w_x"].float() + p["b"]


def _slstm_cell(p, pre_x, state):
    """pre_x: (B, 4D) one step's ``x @ w_x + b``; state = (c, n, m, h)."""
    c, n, m, h = state
    pre = pre_x + h @ p["w_h"].float()
    zt, li, lf, ot = pre.chunk(4, dim=-1)
    zt, lf, ot = torch.tanh(zt), F.logsigmoid(lf), torch.sigmoid(ot)
    m_new = torch.maximum(lf + m, li)
    c_new = torch.exp(lf + m - m_new) * c + torch.exp(li - m_new) * zt
    n_new = torch.exp(lf + m - m_new) * n + torch.exp(li - m_new)
    h_new = ot * c_new / n_new.clamp_min(1e-6)
    return c_new, n_new, m_new, h_new


def init_slstm_cache(batch: int, cfg: ArchConfig, device=None) -> dict:
    d = cfg.d_model
    z = lambda: torch.zeros((batch, d), device=device)  # noqa: E731
    return {"c": z(), "n": z(), "m": torch.full((batch, d), -30.0, device=device), "h": z()}


def _slstm_out(p, h: torch.Tensor, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    y = rmsnorm(h.to(x.dtype), p["norm_w"], cfg.norm_eps)
    return y @ p["w_down"].to(x.dtype)


def slstm_train(p, x: torch.Tensor, cfg: ArchConfig, return_state: bool = False):
    """x: (B, L, D) -> (B, L, D) [+ decode cache when return_state]."""
    bsz, l, d = x.shape
    pre_x = _slstm_inputs(p, x)
    c = init_slstm_cache(bsz, cfg, x.device)
    state = (c["c"], c["n"], c["m"], c["h"])
    hs = []
    for t in range(l):
        state = _slstm_cell(p, pre_x[:, t], state)
        hs.append(state[3])
    out = _slstm_out(p, torch.stack(hs, dim=1), x, cfg)
    if return_state:
        return out, dict(zip("cnmh", state))
    return out


def slstm_decode(p, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One-token step. x: (B, 1, D). Returns (y (B, 1, D), new cache)."""
    state = _slstm_cell(p, _slstm_inputs(p, x[:, 0]),
                        (cache["c"], cache["n"], cache["m"], cache["h"]))
    return _slstm_out(p, state[3][:, None, :], x, cfg), dict(zip("cnmh", state))
