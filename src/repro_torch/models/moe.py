"""Mixture-of-Experts with capacity dispatch (the port of ``repro/models/moe.py``).

Top-k routing in float32 with per-expert capacity. Each (token, slot)
pair's rank within its expert comes from a cumulative one-hot sum in
token order; pairs ranked past the capacity are dropped (Switch-style).
The kept pairs are written into ``(E, C, D)`` expert buffers, the
experts run as batched products over ``(E, C, ·)``, and the outputs are
gathered back and combined with the renormalised gate values.

The reference scatters with ``.at[ids, slot].add(...)``, sending each
dropped pair's zeros to slot ``C - 1``. Kept pairs are unique by
construction, so writing them with a plain ``index_put_`` (no
accumulate) gives the same buffer and stays deterministic on the card;
dropped pairs are written to one spare slot past the capacity, which the
experts never read, so the write needs no host sync to select them.

On a mesh (``launch/spmd.py``) the experts split over the model axis
(``p.tp``): each rank routes every token with the whole router, runs its
own experts on the pairs routed to them, and the combined outputs are
summed over the ranks. Where the data axes split the batch (``p.dp``),
the capacity, the ranks within each expert and the balance loss are the
whole batch's: each rank's ranks start after the pairs of the ranks
before it.

Arctic's dense-MoE hybrid (``moe_dense_residual``) adds a parallel
dense FFN to every MoE block; that lives in ``transformer.py``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import dense_init, gelu, swish, tp_enter, tp_exit

__all__ = ["init_moe", "apply_moe", "moe_capacity", "route"]


def moe_capacity(n_tokens: int, cfg: ArchConfig) -> int:
    cap = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(cap, cfg.top_k)


def init_moe(gen: torch.Generator, cfg: ArchConfig, device=None,
             store: Callable[[str, torch.Tensor], torch.Tensor] | None = None) -> dict:
    """The router and the stacked experts. ``store(name, tensor)``, when
    given, is applied to each tensor as soon as it is drawn (an expert
    tensor of arctic-480b is 17.8 GB in float32)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    keep = store or (lambda name, t: t)
    return {
        "router": keep("router", dense_init(gen, (d, e), device=device)),
        "w_up": keep("w_up", dense_init(gen, (e, d, f), device=device)),
        "w_gate": keep("w_gate", dense_init(gen, (e, d, f), device=device)),
        "w_down": keep("w_down", dense_init(gen, (e, f, d), fan_in=f, device=device)),
    }


def route(p, xt: torch.Tensor, cfg: ArchConfig):
    """The router on tokens ``xt`` (n, D). Returns the renormalised
    float32 gates (n, k), the expert of each (token, slot) pair flattened
    to (n*k,), each pair's rank within its expert (n*k,), which pairs fit
    the capacity (n*k,), the capacity, and the Switch balance loss."""
    n = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    dp = getattr(p, "dp", None)  # the data ranks that split the batch, if any
    n_all = n * (dp.size if dp else 1)
    cap = moe_capacity(n_all, cfg)
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)   # (n, e)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)             # (n, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # Load-balancing auxiliary loss (Switch): e * sum(f_i * p_i).
    onehot_top1 = F.one_hot(expert_ids[:, 0], e).float()
    if dp:
        aux = e * ((dp.sum(onehot_top1.sum(0)) / n_all) * (dp.sum(probs.sum(0)) / n_all)).sum()
    else:
        aux = e * (onehot_top1.mean(0) * probs.mean(0)).sum()
    # Rank of each (token, slot) within its expert, in token order.
    flat_ids = expert_ids.reshape(-1)
    onehot = F.one_hot(flat_ids, e).to(torch.int32)                  # (n*k, e)
    ranks = onehot.cumsum(0, dtype=torch.int32) - onehot             # before me
    if dp:  # after the pairs of the data ranks before this one
        counts = dp.gather(onehot.sum(0, dtype=torch.int32)[None])   # (dp, e)
        ranks = ranks + counts[: dp.rank].sum(0, dtype=torch.int32)
    rank_in_e = ranks.gather(1, flat_ids[:, None])[:, 0].long()
    return gate_vals, flat_ids, rank_in_e, rank_in_e < cap, cap, aux


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D) in x's type, float32 aux loss)."""
    b, s, d = x.shape
    n, k = b * s, cfg.top_k
    xt = x.reshape(n, d)
    gate_vals, flat_ids, rank_in_e, keep, cap, aux = route(p, xt, cfg)
    # This rank's experts: all of them, or on a mesh that splits them
    # (``p.tp``) its block of them.
    e = p["w_up"].shape[0]
    if getattr(p, "tp", None) is not None:
        flat_ids = flat_ids - p.tp.rank * e
        keep = keep & (flat_ids >= 0) & (flat_ids < e)
        flat_ids = flat_ids.clamp(0, e - 1)
        xt, gate_vals = tp_enter(p, xt), tp_enter(p, gate_vals)

    # Kept pairs into their slots; dropped pairs into the spare slot ``cap``.
    buf = x.new_zeros((e, cap + 1, d))
    src = xt.repeat_interleave(k, dim=0)                             # (n*k, d)
    buf.index_put_((flat_ids, torch.where(keep, rank_in_e, cap)), src)
    buf = buf[:, :cap]

    # Expert computation: batched SwiGLU/GeLU over (E, C, ...).
    up = torch.bmm(buf, p["w_up"].to(x.dtype))
    if cfg.act == "swiglu":
        h = swish(torch.bmm(buf, p["w_gate"].to(x.dtype))) * up
    else:
        h = gelu(up)
    out_buf = torch.bmm(h, p["w_down"].to(x.dtype))                  # (e, cap, d)

    # Gather back and combine with the gate values, in x's type.
    gathered = out_buf[flat_ids, torch.where(keep, rank_in_e, cap - 1)]
    gathered = torch.where(keep[:, None], gathered, torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))
    y = (gathered.view(n, k, d) * gate_vals[..., None].to(x.dtype)).sum(dim=1)
    return tp_exit(p, y.view(b, s, d)), aux
