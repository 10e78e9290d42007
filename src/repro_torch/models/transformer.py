"""Block assembly and whole-model forward / prefill / decode for every family.

The port of ``repro/models/transformer.py``. The layer stacks are Python
loops over per-layer parameter modules: there is no layer-stacked scan.
On a mesh (a model with ``spmd``, ``launch/spmd.py``) each layer reads
its parameters through its rank's view, made inside the rematerialised
layer (the reference's per-layer FSDP gather); the embedding, the head
and the loss are vocab-parallel, and prefill and decode return the
logits joined over the vocabulary.

* ``dense``, ``moe`` and ``vlm`` run one stack of attention blocks; a
  MoE block's FFN is :func:`.moe.apply_moe` (plus arctic's parallel
  dense residual MLP), and vlm's input is precomputed patch and text
  embeddings (``inputs["embeds"]``, the reference's frontend stub), its
  decode token ids.
* ``hybrid`` (zamba2): Mamba2 layers, with a shared attention block after
  every ``attn_every`` layers except the last segment, one KV cache per
  application.
* ``ssm`` (xLSTM): mLSTM blocks with an sLSTM block where
  ``i % slstm_every == 1``.
* ``audio`` (whisper): a non-causal encoder stack over frame embeddings
  (``inputs["embeds"]``), then decoder blocks with cross-attention to the
  encoder output (``ln_x``, ``xattn``); decode recomputes the cross K/V
  from the cached encoder output each step, as the reference does.

Caches are plain dicts of tensors: ``{"kv": [{"k", "v"} per layer]}``
(``dense``/``moe``/``vlm``; ``audio`` adds ``"enc"``, the encoder
output); ``{"mamba": [...], "shared_kv": [...]}`` (``hybrid``);
``{"xl": [{"C", "n", "m"} or {"c", "n", "m", "h"} per layer]}``
(``ssm``). A decode step updates the caches in place (the reference
returns new arrays) and returns the same dict.

Training (``train_forward``) rematerialises each layer of the attention
and Mamba2 stacks with ``torch.utils.checkpoint`` where the reference's
``_scan_blocks`` wraps its scan body in ``jax.checkpoint``: a layer keeps
only its input, and its forward runs again in the backward pass.
zamba2's shared block and the xLSTM blocks are not rematerialised, as in
the reference. ``aux`` is the sum over layers of the MoE balance loss
(0 for the other families).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from . import xlstm as X
from .attention import (attention_decode, attention_train, cross_kv, init_attention,
                        init_kv_cache)
from .config import ArchConfig
from .layers import COMPUTE_DTYPE, apply_norm, dense_init, embed_init, init_norm
from .mamba2 import init_mamba2, init_mamba2_cache, mamba2_decode, mamba2_train
from .mlp import apply_mlp, init_mlp
from .moe import apply_moe, init_moe
from .plan import AttentionPlan, ShardingPlan, plan_attention

__all__ = ["init_model_params", "train_forward", "unread_in_training", "decode_step",
           "init_caches", "prefill", "zamba_segments", "compute_dtype", "token_nll",
           "PORTED_FAMILIES"]

#: Every family of the reference's model zoo.
PORTED_FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
#: Families that run one stack of attention blocks.
_ATTENTION_STACK = ("dense", "moe", "vlm")

Store = Callable[[str, torch.Tensor], torch.Tensor]


def _attention_plan(cfg: ArchConfig, plan: ShardingPlan | None) -> AttentionPlan:
    return plan.attention if plan and plan.attention else plan_attention(cfg, 1)


def _unknown(fam: str) -> ValueError:
    return ValueError(f"unknown family {fam!r}")


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------


def _init_dense_block(gen, cfg: ArchConfig, plan: AttentionPlan, device,
                      store: Store) -> dict:
    """An attention block, its tensors passed through ``store`` once: each
    part as it is drawn, each MoE tensor on its own."""
    p = _stored({
        "ln1": init_norm(cfg.norm, cfg.d_model, device),
        "attn": init_attention(gen, cfg, plan, device),
        "ln2": init_norm(cfg.norm, cfg.d_model, device),
    }, store)
    if cfg.n_experts:
        p["moe"] = init_moe(gen, cfg, device, store)
    if not cfg.n_experts or cfg.moe_dense_residual:  # arctic keeps a dense residual
        p["mlp"] = _stored(init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, device), store)
    return p


def _ffn(p, h, cfg: ArchConfig):
    """-> (y, aux): the MoE (plus arctic's dense residual) or the MLP."""
    if "moe" in p:
        y, aux = apply_moe(p["moe"], h, cfg)
        if "mlp" in p:  # arctic dense residual
            y = y + apply_mlp(p["mlp"], h, cfg.act)
        return y, aux
    return apply_mlp(p["mlp"], h, cfg.act), torch.zeros((), device=h.device)


def _dense_block(p, x, cfg: ArchConfig, *, causal=True):
    """-> (x, k, v, aux): the block's output, its attention K (after
    RoPE) and V, which prefill keeps as the decode cache, and its MoE
    balance loss."""
    h = apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    a, k, v = attention_train(p["attn"], h, cfg, causal=causal, return_kv=True)
    x = x + a
    y, aux = _ffn(p, apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps), cfg)
    return x + y, k, v, aux


def _dense_block_decode(p, x, cache, lengths, cfg: ArchConfig):
    h = apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    a, cache = attention_decode(p["attn"], h, cache, lengths, cfg)
    x = x + a
    y, _ = _ffn(p, apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps), cfg)
    return x + y, cache


def _encoder_block(p, x, cfg: ArchConfig):
    """whisper's encoder block: non-causal self-attention."""
    return _dense_block(p, x, cfg, causal=False)[0]


def _cross(p, x, enc, cfg: ArchConfig):
    """The decoder block's cross-attention residual over the encoder output."""
    hx = apply_norm(cfg.norm, p["ln_x"], x, cfg.norm_eps)
    return x + attention_train(p["xattn"], hx, cfg, kv_override=cross_kv(p["xattn"], enc))


def _decoder_block(p, x, enc, cfg: ArchConfig):
    """-> (x, k, v, aux): whisper's decoder block, causal self-attention
    (its K/V are the decode cache), then cross-attention."""
    x, k, v, aux = _dense_block(p, x, cfg)
    return _cross(p, x, enc, cfg), k, v, aux


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


def _is_slstm(cfg: ArchConfig, i: int) -> bool:
    return bool(cfg.slstm_every) and i % cfg.slstm_every == 1


def _xl_block(p, x, cfg: ArchConfig):
    """-> (x, cache): an mLSTM or sLSTM block (tagged ``kind_slstm``)."""
    h = apply_norm(cfg.norm, p["ln"], x, cfg.norm_eps)
    cell = X.slstm_train if "kind_slstm" in p else X.mlstm_train
    y, cache = cell(p["cell"], h, cfg, return_state=True)
    return x + y, cache


def _xl_block_decode(p, x, cache, cfg: ArchConfig):
    h = apply_norm(cfg.norm, p["ln"], x, cfg.norm_eps)
    cell = X.slstm_decode if "kind_slstm" in p else X.mlstm_decode
    y, cache = cell(p["cell"], h, cache, cfg)
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


def _stored(tree, store: Store):
    """``tree`` with ``store(name, tensor)`` applied to every leaf."""
    return {k: _stored(v, store) if isinstance(v, dict) else store(k, v)
            for k, v in tree.items()}


def init_model_params(gen: torch.Generator, cfg: ArchConfig,
                      plan: ShardingPlan | None = None, device=None,
                      store: Store | None = None) -> dict:
    """The parameter tree (nested dicts and lists of tensors, the
    reference's pytree with the layer stacks unstacked per layer). With
    ``store``, each tensor is passed through ``store(name, tensor)`` once,
    as soon as its block is drawn (each MoE tensor as soon as it is
    drawn), so that only one block's float32 draw lives at a time."""
    fam = cfg.family
    if fam not in PORTED_FAMILIES:
        raise _unknown(fam)
    store = store or (lambda name, t: t)
    aplan = _attention_plan(cfg, plan)
    d = cfg.d_model
    keep = lambda tree: _stored(tree, store)  # noqa: E731
    dense = lambda: _init_dense_block(gen, cfg, aplan, device, store)  # noqa: E731
    p: dict = keep({
        "embed": embed_init(gen, cfg.vocab_size, d, device),
        "final_norm": init_norm(cfg.norm, d, device),
    })
    if not cfg.tie_embeddings:
        p["head"] = store("head", dense_init(gen, (d, cfg.vocab_size), device=device))
    if fam in _ATTENTION_STACK:
        p["blocks"] = [dense() for _ in range(cfg.n_layers)]
    elif fam == "hybrid":  # zamba2: mamba stack + one shared attention block
        p["blocks"] = [keep(_init_mamba_block(gen, cfg, device)) for _ in range(cfg.n_layers)]
        p["shared"] = dense()
    elif fam == "ssm":  # xlstm: interleaved mLSTM/sLSTM
        p["xl_blocks"] = [
            keep({"kind_slstm": torch.zeros((), device=device),  # tag leaf, as the reference
                  "ln": init_norm(cfg.norm, d, device),
                  "cell": X.init_slstm(gen, cfg, device)}) if _is_slstm(cfg, i)
            else keep({"ln": init_norm(cfg.norm, d, device),
                       "cell": X.init_mlstm(gen, cfg, device)})
            for i in range(cfg.n_layers)]
    else:  # audio: whisper encoder-decoder
        p["enc_blocks"] = [dense() for _ in range(cfg.encoder_layers)]
        p["enc_norm"] = keep(init_norm(cfg.norm, d, device))
        p["blocks"] = [{**dense(), **keep({"ln_x": init_norm(cfg.norm, d, device),
                                           "xattn": init_attention(gen, cfg, aplan, device)})}
                       for _ in range(cfg.n_layers)]
    return p


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def compute_dtype(p) -> torch.dtype:
    """The activation dtype: a trainable model's ``act_dtype``; else the
    embedding's storage dtype, bfloat16 as built (``model.float()`` runs
    the whole model in float32)."""
    return getattr(p, "act_dtype", None) or p["embed"].dtype


def _view(p, blk):
    """``blk`` as the layer reads it: on a mesh, this rank's view."""
    sp = getattr(p, "spmd", None)
    return blk if sp is None else sp.view(blk)


def _embed_in(p, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids -> embeddings in the activation dtype."""
    sp = getattr(p, "spmd", None)
    if sp is not None:
        return sp.embed(tokens, compute_dtype(p))
    return p["embed"][tokens].to(compute_dtype(p))


def _inputs_in(p, cfg: ArchConfig, inputs: dict) -> torch.Tensor:
    """The first stack's input: embedded tokens, or the frontend stub's
    precomputed embeddings (``inputs["embeds"]``: vlm's patches and text,
    whisper's frames)."""
    if cfg.frontend == "none":
        return _embed_in(p, cfg, inputs["tokens"])
    return inputs["embeds"].to(compute_dtype(p))


def _lm_head(p, cfg: ArchConfig, x) -> torch.Tensor:
    """Float32 logits; on a mesh, this rank's block of the vocabulary."""
    sp = getattr(p, "spmd", None)
    q = _view(p, p)
    x = apply_norm(cfg.norm, q["final_norm"], x, cfg.norm_eps)
    w = q["embed"].T if cfg.tie_embeddings else q["head"]
    if sp is not None and sp.vocab is not None:
        x = sp.vocab.enter(x)
    return (x @ w.to(x.dtype)).float()


def _full_logits(p, logits: torch.Tensor) -> torch.Tensor:
    sp = getattr(p, "spmd", None)
    return logits if sp is None else sp.full_logits(logits)


def token_nll(p, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[label] per position (vocab-parallel on a mesh)."""
    sp = getattr(p, "spmd", None)
    if sp is not None:
        return sp.vocab_nll(logits, labels)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0]


def _layer(fn, remat: bool, p, blk, *args):
    """One layer of the stack, rematerialised when asked and autograd
    records (the reference's ``jax.checkpoint`` of its scan body). On a
    mesh the layer reads ``blk`` through a view made inside the
    rematerialised function, so the backward pass gathers again."""
    sp = getattr(p, "spmd", None)
    run = fn if sp is None else (lambda b, *a: fn(sp.view(b), *a))
    if remat and torch.is_grad_enabled():
        return checkpoint(run, blk, *args, use_reentrant=False)
    return run(blk, *args)


def _forward(p, inputs: dict, cfg: ArchConfig, max_len: int | None, remat: bool = False):
    """The layer stacks over a whole sequence -> (x, caches, aux). With
    ``max_len``, the caches are the prompt's decode caches, K/V padded to
    ``max_len`` positions. With ``remat``, each layer of the attention and
    Mamba2 stacks keeps only its input for the backward pass and runs
    again there."""
    fam = cfg.family
    if fam not in PORTED_FAMILIES:
        raise _unknown(fam)
    x = _inputs_in(p, cfg, inputs)
    aux = torch.zeros((), device=x.device)

    def kv_cache(k, v):
        if max_len is None:
            return None
        seq = k.shape[2]
        if seq > max_len:
            raise ValueError(f"prompt of {seq} tokens exceeds max_len {max_len}")
        shape = (k.shape[0], k.shape[1], max_len, k.shape[3])
        cache = {"k": k.new_zeros(shape), "v": v.new_zeros(shape)}
        cache["k"][:, :, :seq] = k
        cache["v"][:, :, :seq] = v
        return cache

    if fam in _ATTENTION_STACK:
        kv = []
        for blk in p["blocks"]:
            x, k, v, a = _layer(_dense_block, remat, p, blk, x, cfg)
            kv.append(kv_cache(k, v))
            aux = aux + a
        return x, {"kv": kv}, aux
    if fam == "audio":
        enc = x
        for blk in p["enc_blocks"]:
            enc = _layer(_encoder_block, remat, p, blk, enc, cfg)
        enc = apply_norm(cfg.norm, _view(p, p)["enc_norm"], enc, cfg.norm_eps)
        x, kv = _embed_in(p, cfg, inputs["tokens"]), []
        for blk in p["blocks"]:
            x, k, v, a = _layer(_decoder_block, remat, p, blk, x, enc, cfg)
            kv.append(kv_cache(k, v))
            aux = aux + a
        return x, {"kv": kv, "enc": enc}, aux
    if fam == "ssm":
        xl = []
        for blk in p["xl_blocks"]:
            x, cache = _xl_block(_view(p, blk), x, cfg)
            xl.append(None if max_len is None else cache)
        return x, {"xl": xl}, aux
    mamba, shared_kv = [], []
    blocks, segs, off = p["blocks"], zamba_segments(cfg), 0
    for si, seg in enumerate(segs):
        for blk in blocks[off : off + seg]:
            x, cache = _layer(_mamba_block, remat, p, blk, x, cfg)
            mamba.append(None if max_len is None else cache)
        off += seg
        if si < len(segs) - 1:
            x, k, v, a = _dense_block(_view(p, p["shared"]), x, cfg)
            shared_kv.append(kv_cache(k, v))
            aux = aux + a
    return x, {"mamba": mamba, "shared_kv": shared_kv}, aux


def train_forward(p, inputs: dict, cfg: ArchConfig, remat: bool = True):
    """-> (logits (B,S,V) float32, aux scalar), the stacks rematerialised
    per layer when ``remat``; on a mesh the logits are this rank's block
    of the vocabulary (:func:`token_nll` reads them). ``aux`` sums the MoE balance loss over the
    layers (0 without experts), as the reference's scan carry does."""
    x, _, aux = _forward(p, inputs, cfg, None, remat)
    return _lm_head(p, cfg, x), aux


def unread_in_training(cfg: ArchConfig) -> frozenset[str]:
    """Names of the leaves that :func:`train_forward` never reads, whose
    gradient is 0 as the reference's: xLSTM's ``kind_slstm`` tag, and a
    vlm's token embedding when the head is its own (training reads
    ``inputs["embeds"]``; only decode embeds tokens)."""
    unread = {"kind_slstm"}
    if cfg.family == "vlm" and not cfg.tie_embeddings:
        unread.add("embed")
    return frozenset(unread)


# --------------------------------------------------------------------------
# Caches / decode / prefill
# --------------------------------------------------------------------------


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                plan: ShardingPlan | None = None, device=None,
                dtype: torch.dtype = COMPUTE_DTYPE) -> dict:
    """Empty caches; ``dtype`` is the KV caches' and the encoder output's
    (the activation dtype)."""
    aplan = _attention_plan(cfg, plan)
    fam = cfg.family
    kv = lambda n: [init_kv_cache(batch, max_len, aplan, device, dtype)  # noqa: E731
                    for _ in range(n)]
    if fam in _ATTENTION_STACK:
        return {"kv": kv(cfg.n_layers)}
    if fam == "hybrid":
        return {
            "mamba": [init_mamba2_cache(batch, cfg, device) for _ in range(cfg.n_layers)],
            "shared_kv": kv(max(len(zamba_segments(cfg)) - 1, 1)),
        }
    if fam == "ssm":
        return {"xl": [X.init_slstm_cache(batch, cfg, device) if _is_slstm(cfg, i)
                       else X.init_mlstm_cache(batch, cfg, device)
                       for i in range(cfg.n_layers)]}
    if fam == "audio":
        return {"kv": kv(cfg.n_layers),
                "enc": torch.zeros((batch, cfg.encoder_frames, cfg.d_model), dtype=dtype,
                                   device=device)}
    raise _unknown(fam)


def decode_step(p, caches: dict, tokens: torch.Tensor, lengths: torch.Tensor,
                cfg: ArchConfig):
    """One token for every sequence. tokens: (B,) int; lengths: (B,)
    int32 tokens already in the caches. Returns (logits (B, V) float32,
    caches), the caches updated in place. Every family decodes token ids
    (vlm's image is in its cache)."""
    x = _embed_in(p, cfg, tokens)[:, None, :]  # (B,1,D)
    fam = cfg.family
    if fam in _ATTENTION_STACK or fam == "audio":
        kv = caches["kv"]
        for i, blk in enumerate(p["blocks"]):
            blk = _view(p, blk)
            x, kv[i] = _dense_block_decode(blk, x, kv[i], lengths, cfg)
            if fam == "audio":
                x = _cross(blk, x, caches["enc"], cfg)
    elif fam == "hybrid":
        mamba, shared_kv = caches["mamba"], caches["shared_kv"]
        segs, off = zamba_segments(cfg), 0
        for si, seg in enumerate(segs):
            for i in range(off, off + seg):
                x, mamba[i] = _mamba_block_decode(_view(p, p["blocks"][i]), x, mamba[i], cfg)
            off += seg
            if si < len(segs) - 1:
                x, shared_kv[si] = _dense_block_decode(_view(p, p["shared"]), x,
                                                       shared_kv[si], lengths, cfg)
    elif fam == "ssm":
        xl = caches["xl"]
        for i, blk in enumerate(p["xl_blocks"]):
            x, xl[i] = _xl_block_decode(_view(p, blk), x, xl[i], cfg)
    else:
        raise _unknown(fam)
    return _full_logits(p, _lm_head(p, cfg, x)[:, 0, :]), caches


def prefill(p, inputs: dict, cfg: ArchConfig, max_len: int):
    """Process a full prompt, returning (last logits (B, V) float32,
    primed caches). Attention K/V are projected once per block and kept
    (the reference projects them a second time for the cache). As in the
    reference, the KV caches are bfloat16 (the activation dtype) whatever
    ``attention_options`` says."""
    x, caches, _ = _forward(p, inputs, cfg, max_len)
    return _full_logits(p, _lm_head(p, cfg, x[:, -1:, :])[:, 0, :]), caches
