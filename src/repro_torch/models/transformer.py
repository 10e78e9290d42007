"""Block assembly and whole-model forward / prefill / decode.

The port of ``repro/models/transformer.py`` for the ``dense`` and
``hybrid`` (zamba2) families. The layer stack is a Python loop over
per-layer parameter modules: there is no layer-stacked scan and no FSDP
weight gathering (sharding comes in a later slice). zamba2's shared
attention block runs after every ``attn_every`` Mamba2 layers except
the last segment, and keeps one KV cache per application.

Caches are plain dicts of tensors: ``{"kv": [{"k", "v"} per layer]}``
for ``dense``; ``{"mamba": [{"conv", "ssm"} per layer], "shared_kv":
[{"k", "v"} per shared-block application]}`` for ``hybrid``. A decode
step writes the new K/V rows into the caches in place (the reference
returns new arrays) and returns the same dict.

Training (``train_forward``) rematerialises each layer of the stack with
``torch.utils.checkpoint`` where the reference's ``_scan_blocks`` wraps
its scan body in ``jax.checkpoint``: a layer keeps only its input, and
its forward runs again in the backward pass. zamba2's shared attention
block is not rematerialised, as in the reference.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .attention import attention_decode, attention_train, init_attention, init_kv_cache
from .config import ArchConfig
from .layers import COMPUTE_DTYPE, apply_norm, dense_init, embed_init, init_norm
from .mamba2 import init_mamba2, init_mamba2_cache, mamba2_decode, mamba2_train
from .mlp import apply_mlp, init_mlp
from .plan import AttentionPlan, ShardingPlan, plan_attention

__all__ = ["init_model_params", "train_forward", "decode_step", "init_caches",
           "prefill", "zamba_segments", "compute_dtype", "PORTED_FAMILIES"]

#: Families this slice ports; the others name the ROADMAP item that will.
PORTED_FAMILIES = ("dense", "hybrid")


def _unported(fam: str) -> NotImplementedError:
    return NotImplementedError(
        f"family {fam!r} is not ported yet (ROADMAP.md, open items, queue 1, "
        f"item 5: moe, ssm, audio and vlm follow dense and hybrid)"
    )


def _attention_plan(cfg: ArchConfig, plan: ShardingPlan | None) -> AttentionPlan:
    return plan.attention if plan and plan.attention else plan_attention(cfg, 1)


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------


def _init_dense_block(gen, cfg: ArchConfig, plan: AttentionPlan, device) -> dict:
    if cfg.n_experts:
        raise _unported("moe")
    return {
        "ln1": init_norm(cfg.norm, cfg.d_model, device),
        "attn": init_attention(gen, cfg, plan, device),
        "ln2": init_norm(cfg.norm, cfg.d_model, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, device),
    }


def _dense_block(p, x, cfg: ArchConfig, *, causal=True):
    """-> (x, k, v): the block's output and its attention K (after RoPE)
    and V, which prefill keeps as the decode cache."""
    h = apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    a, k, v = attention_train(p["attn"], h, cfg, causal=causal, return_kv=True)
    x = x + a
    h = apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, cfg.act), k, v


def _dense_block_decode(p, x, cache, lengths, cfg: ArchConfig):
    h = apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    a, cache = attention_decode(p["attn"], h, cache, lengths, cfg)
    x = x + a
    h = apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, cfg.act), cache


def _init_mamba_block(gen, cfg: ArchConfig, device) -> dict:
    return {"ln": init_norm(cfg.norm, cfg.d_model, device),
            "mamba": init_mamba2(gen, cfg, device)}


def _mamba_block(p, x, cfg: ArchConfig):
    """-> (x, cache): the block's output and its decode cache."""
    h = apply_norm(cfg.norm, p["ln"], x, cfg.norm_eps)
    y, cache = mamba2_train(p["mamba"], h, cfg, return_state=True)
    return x + y, cache


def _mamba_block_decode(p, x, cache, cfg: ArchConfig):
    h = apply_norm(cfg.norm, p["ln"], x, cfg.norm_eps)
    y, cache = mamba2_decode(p["mamba"], h, cache, cfg)
    return x + y, cache


def zamba_segments(cfg: ArchConfig) -> list[int]:
    """Mamba-layer segment lengths between shared-attention applications."""
    k = cfg.attn_every
    segs, left = [], cfg.n_layers
    while left > 0:
        segs.append(min(k, left))
        left -= k
    return segs


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def init_model_params(gen: torch.Generator, cfg: ArchConfig,
                      plan: ShardingPlan | None = None, device=None) -> dict:
    """The parameter tree (nested dicts and lists of float32 tensors,
    the reference's pytree with ``blocks`` unstacked per layer)."""
    fam = cfg.family
    if fam not in PORTED_FAMILIES:
        raise _unported(fam)
    aplan = _attention_plan(cfg, plan)
    d = cfg.d_model
    p: dict = {
        "embed": embed_init(gen, cfg.vocab_size, d, device),
        "final_norm": init_norm(cfg.norm, d, device),
    }
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (d, cfg.vocab_size), device=device)
    if fam == "dense":
        p["blocks"] = [_init_dense_block(gen, cfg, aplan, device)
                       for _ in range(cfg.n_layers)]
    else:  # zamba2: mamba stack + one shared attention block
        p["blocks"] = [_init_mamba_block(gen, cfg, device) for _ in range(cfg.n_layers)]
        p["shared"] = _init_dense_block(gen, cfg, aplan, device)
    return p


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def compute_dtype(p) -> torch.dtype:
    """The activation dtype: a trainable model's ``act_dtype``; else the
    embedding's storage dtype, bfloat16 as built (``model.float()`` runs
    the whole model in float32)."""
    return getattr(p, "act_dtype", None) or p["embed"].dtype


def _embed_in(p, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    if cfg.frontend != "none":
        raise _unported(cfg.family)
    return p["embed"][tokens].to(compute_dtype(p))


def _lm_head(p, cfg: ArchConfig, x) -> torch.Tensor:
    x = apply_norm(cfg.norm, p["final_norm"], x, cfg.norm_eps)
    w = p["embed"].T if cfg.tie_embeddings else p["head"]
    return (x @ w.to(x.dtype)).float()


def _layer(fn, remat: bool, *args):
    """One layer of the stack, rematerialised when asked and autograd
    records (the reference's ``jax.checkpoint`` of its scan body)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _forward(p, tokens: torch.Tensor, cfg: ArchConfig, max_len: int | None,
             remat: bool = False):
    """The layer stack over a whole sequence. With ``max_len``, also
    the decode caches of the prompt, padded to ``max_len`` positions.
    With ``remat``, each layer of the stack keeps only its input for the
    backward pass and runs again there; zamba2's shared block keeps its
    activations."""
    fam = cfg.family
    if fam not in PORTED_FAMILIES:
        raise _unported(fam)
    x = _embed_in(p, cfg, tokens)
    seq = tokens.shape[1]

    def kv_cache(k, v):
        if max_len is None:
            return None
        if seq > max_len:
            raise ValueError(f"prompt of {seq} tokens exceeds max_len {max_len}")
        shape = (k.shape[0], k.shape[1], max_len, k.shape[3])
        cache = {"k": k.new_zeros(shape), "v": v.new_zeros(shape)}
        cache["k"][:, :, :seq] = k
        cache["v"][:, :, :seq] = v
        return cache

    if fam == "dense":
        kv = []
        for blk in p["blocks"]:
            x, k, v = _layer(_dense_block, remat, blk, x, cfg)
            kv.append(kv_cache(k, v))
        return x, {"kv": kv}
    mamba, shared_kv = [], []
    blocks, segs, off = p["blocks"], zamba_segments(cfg), 0
    for si, seg in enumerate(segs):
        for blk in blocks[off : off + seg]:
            x, cache = _layer(_mamba_block, remat, blk, x, cfg)
            mamba.append(None if max_len is None else cache)
        off += seg
        if si < len(segs) - 1:
            x, k, v = _dense_block(p["shared"], x, cfg)
            shared_kv.append(kv_cache(k, v))
    return x, {"mamba": mamba, "shared_kv": shared_kv}


def train_forward(p, inputs: dict, cfg: ArchConfig, remat: bool = True):
    """-> (logits (B,S,V) float32, aux scalar), the stack rematerialised
    per layer when ``remat``. The ported families have no auxiliary loss
    (the reference's ``aux`` is the MoE balance loss), so ``aux`` is 0."""
    x, _ = _forward(p, inputs["tokens"], cfg, None, remat)
    return _lm_head(p, cfg, x), torch.zeros((), device=x.device)


# --------------------------------------------------------------------------
# Caches / decode / prefill
# --------------------------------------------------------------------------


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                plan: ShardingPlan | None = None, device=None,
                dtype: torch.dtype = COMPUTE_DTYPE) -> dict:
    """Empty caches; ``dtype`` is the KV caches' (the activation dtype)."""
    aplan = _attention_plan(cfg, plan)
    fam = cfg.family
    if fam == "dense":
        return {"kv": [init_kv_cache(batch, max_len, aplan, device, dtype)
                       for _ in range(cfg.n_layers)]}
    if fam == "hybrid":
        n_shared = max(len(zamba_segments(cfg)) - 1, 1)
        return {
            "mamba": [init_mamba2_cache(batch, cfg, device) for _ in range(cfg.n_layers)],
            "shared_kv": [init_kv_cache(batch, max_len, aplan, device, dtype)
                          for _ in range(n_shared)],
        }
    raise _unported(fam)


def decode_step(p, caches: dict, tokens: torch.Tensor, lengths: torch.Tensor,
                cfg: ArchConfig):
    """One token for every sequence. tokens: (B,) int; lengths: (B,)
    int32 tokens already in the caches. Returns (logits (B, V) float32,
    caches), the caches updated in place."""
    x = _embed_in(p, cfg, tokens)[:, None, :]  # (B,1,D)
    fam = cfg.family
    if fam == "dense":
        kv = caches["kv"]
        for i, blk in enumerate(p["blocks"]):
            x, kv[i] = _dense_block_decode(blk, x, kv[i], lengths, cfg)
    elif fam == "hybrid":
        mamba, shared_kv = caches["mamba"], caches["shared_kv"]
        segs, off = zamba_segments(cfg), 0
        for si, seg in enumerate(segs):
            for i in range(off, off + seg):
                x, mamba[i] = _mamba_block_decode(p["blocks"][i], x, mamba[i], cfg)
            off += seg
            if si < len(segs) - 1:
                x, shared_kv[si] = _dense_block_decode(p["shared"], x, shared_kv[si],
                                                       lengths, cfg)
    else:
        raise _unported(fam)
    return _lm_head(p, cfg, x)[:, 0, :], caches


def prefill(p, inputs: dict, cfg: ArchConfig, max_len: int):
    """Process a full prompt, returning (last logits (B, V) float32,
    primed caches). Attention K/V are projected once per block and kept
    (the reference projects them a second time for the cache)."""
    x, caches = _forward(p, inputs["tokens"], cfg, max_len)
    return _lm_head(p, cfg, x[:, -1:, :])[:, 0, :], caches
