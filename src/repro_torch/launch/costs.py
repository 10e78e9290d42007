"""Analytic FLOP / HBM-byte accounting per (arch, shape) cell.

The port's copy of ``repro/launch/costs.py``, line for line but for
``hlo_cost_analysis``, which reads a compiled XLA program's
``cost_analysis()``: PyTorch compiles no such program, so the port has
no counterpart and the copy leaves it out. The analytic model below
reads only the configuration and the shape, and the port's dry run
(``launch/dryrun.py``) uses it as the reference's does.

Why this exists: ``compiled.cost_analysis()`` on the XLA CPU backend
counts each ``while`` body **once**, so scan-over-layers programs
under-report FLOPs by ~L x (verified in tests/test_costs.py by
comparing an unrolled small config against this model).  The roofline
table therefore uses this analytic model — exact einsum accounting of
the code in ``repro/models`` — and records the raw HLO numbers
alongside for transparency.

Conventions:

* matmul (m, k) x (k, n) = 2*m*k*n FLOPs;
* the jnp chunked-attention path computes the full S x S score matrix
  with a causal *mask* (no block skipping), and that is what we count —
  the causal-skip saving shows up as an optimization, not an assumption;
* training = fwd + 2x bwd + 1x remat recompute of the layer stack
  (the scan is rematerialized per layer);
* HBM bytes = parameter traffic + activation traffic + attention KV
  re-reads (the kv operand streams once per q-block in the scan) +
  decode-cache traffic, at the numerically-correct dtype widths.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..configs import ShapeSpec
from ..models.config import ArchConfig
from ..models.plan import AttentionPlan, plan_attention

__all__ = ["CellCost", "cell_cost"]

BF16 = 2
F32 = 4


# Activation-traffic fudge: reads+writes of the residual stream per
# block (norms, projections in/out, residual adds).
ACT_RW_PER_BLOCK = 12


@dataclass(frozen=True)
class CellCost:
    flops: float            # global FLOPs for one step
    bytes: float            # global HBM bytes for one step
    flops_by: dict
    bytes_by: dict


def _attn_flops(plan: AttentionPlan, b: int, sq: int, sk: int, d: int) -> dict:
    hd, q_eff, slots = plan.head_dim, plan.q_eff, plan.slots
    proj = 2 * b * sq * d * (q_eff * hd) + 2 * b * sq * d * (2 * slots * hd)
    out = 2 * b * sq * (q_eff * hd) * d
    scores = 2 * b * q_eff * sq * sk * hd
    pv = 2 * b * q_eff * sq * sk * hd
    softmax = 6 * b * q_eff * sq * sk
    return {
        "attn_proj": proj + out,
        "attn_core": scores + pv + softmax,
    }


def _mlp_flops(cfg: ArchConfig, b: int, s: int) -> float:
    mults = 3 if cfg.act == "swiglu" else 2
    return 2 * b * s * cfg.d_model * cfg.d_ff * mults


def _moe_flops(cfg: ArchConfig, b: int, s: int) -> float:
    n = b * s
    router = 2 * n * cfg.d_model * cfg.n_experts
    routed = n * cfg.top_k * cfg.capacity_factor  # dispatched token slots
    mults = 3 if cfg.act == "swiglu" else 2
    expert = 2 * routed * cfg.d_model * cfg.d_ff * mults
    return router + expert


def _mamba_flops(cfg: ArchConfig, b: int, s: int, chunk: int = 128) -> float:
    d = cfg.d_model
    d_inner = 2 * d
    p = cfg.ssm_head_dim
    h = d_inner // p
    n = cfg.ssm_state
    d_in_proj = 2 * d_inner + 2 * n + h
    conv_dim = d_inner + 2 * n
    proj = 2 * b * s * d * d_in_proj + 2 * b * s * d_inner * d
    conv = 2 * b * s * conv_dim * cfg.ssm_conv_width
    q = min(chunk, s)
    nc = s // q
    intra = nc * (2 * b * q * q * n + 3 * b * q * q * h + 2 * b * q * q * h * p)
    inter = nc * (2 * 2 * b * q * h * p * n + b * h * p * n)
    return proj + conv + intra + inter


def _mlstm_flops(cfg: ArchConfig, b: int, s: int, chunk: int = 128) -> float:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    q = min(chunk, s)
    nc = s // q
    proj = 2 * b * s * d * (2 * d) + 3 * 2 * b * s * d * d + 2 * b * s * d * d
    intra = nc * (2 * 2 * b * q * q * h * dh + 4 * b * q * q * h)
    state = nc * (2 * 2 * b * q * h * dh * dh)
    return proj + intra + state


def _slstm_flops(cfg: ArchConfig, b: int, s: int) -> float:
    d = cfg.d_model
    per_step = 2 * b * d * (4 * d) * 2  # w_x and recurrent w_h
    return s * per_step + 2 * b * s * d * d  # + down proj


def _layer_flops(cfg: ArchConfig, plan: AttentionPlan, b: int, sq: int,
                 sk: int) -> dict:
    """Forward FLOPs of one block at (b, sq) attending to sk keys."""
    fam = cfg.family
    if fam in ("dense", "moe", "vlm", "audio"):
        d = _attn_flops(plan, b, sq, sk, cfg.d_model)
        if cfg.n_experts:
            d["ffn"] = _moe_flops(cfg, b, sq)
            if cfg.moe_dense_residual:
                d["ffn"] += _mlp_flops(cfg, b, sq)
        else:
            d["ffn"] = _mlp_flops(cfg, b, sq)
        return d
    raise ValueError(fam)


def _fwd_flops(cfg: ArchConfig, plan: AttentionPlan, b: int, s: int,
               decode: bool = False, cache_len: int = 0) -> dict:
    """Forward FLOPs of the whole network on (b, s) tokens."""
    fam = cfg.family
    sk = cache_len if decode else s
    out: dict[str, float] = {}
    if fam in ("dense", "moe", "vlm"):
        per = _layer_flops(cfg, plan, b, s, sk)
        for k, v in per.items():
            out[k] = v * cfg.n_layers
    elif fam == "hybrid":
        if decode:
            d = cfg.d_model
            d_inner, pdim, n = 2 * d, cfg.ssm_head_dim, cfg.ssm_state
            h = d_inner // pdim
            per = (
                2 * b * s * d * (2 * d_inner + 2 * n + h)
                + 2 * b * s * d_inner * d
                + 2 * 2 * b * s * h * pdim * n
            )
            out["mamba"] = per * cfg.n_layers
        else:
            out["mamba"] = _mamba_flops(cfg, b, s) * cfg.n_layers
        n_shared = max(-(-cfg.n_layers // cfg.attn_every) - 1, 1)
        att = _attn_flops(plan, b, s, sk, cfg.d_model)
        out["attn_proj"] = att["attn_proj"] * n_shared
        out["attn_core"] = att["attn_core"] * n_shared
        out["ffn"] = _mlp_flops(cfg, b, s) * n_shared
    elif fam == "ssm":
        n_s = sum(
            1 for i in range(cfg.n_layers)
            if cfg.slstm_every and i % cfg.slstm_every == 1
        )
        n_m = cfg.n_layers - n_s
        if decode:
            d = cfg.d_model
            h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
            out["mlstm"] = n_m * b * s * (
                2 * d * 2 * d + 3 * 2 * d * d + 2 * d * d
                + 4 * h * dh * dh
            )
            out["slstm"] = n_s * b * s * (2 * d * 4 * d * 2 + 2 * d * d)
        else:
            out["mlstm"] = _mlstm_flops(cfg, b, s) * n_m
            out["slstm"] = _slstm_flops(cfg, b, s) * n_s
    elif fam == "audio":
        enc_b = b
        enc = _layer_flops(cfg, plan, enc_b, cfg.encoder_frames,
                           cfg.encoder_frames)
        dec_self = _attn_flops(plan, b, s, sk, cfg.d_model)
        dec_cross = _attn_flops(plan, b, s, cfg.encoder_frames, cfg.d_model)
        if not decode:
            out["encoder"] = sum(enc.values()) * cfg.encoder_layers
        out["attn_proj"] = (
            dec_self["attn_proj"] + dec_cross["attn_proj"]
        ) * cfg.n_layers
        out["attn_core"] = (
            dec_self["attn_core"] + dec_cross["attn_core"]
        ) * cfg.n_layers
        out["ffn"] = _mlp_flops(cfg, b, s) * cfg.n_layers
    else:
        raise ValueError(fam)
    out["head"] = 2 * b * s * cfg.d_model * cfg.vocab_size
    return out


def _param_bytes(cfg: ArchConfig) -> float:
    return cfg.n_params() * F32  # master weights are f32 in this framework


def cell_cost(cfg: ArchConfig, shape: ShapeSpec, tp: int = 16,
              causal_skip: bool = False, kv_quant: bool = False) -> CellCost:
    plan = plan_attention(cfg, tp)
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    pbytes = _param_bytes(cfg)
    fb: dict[str, float] = {}
    bb: dict[str, float] = {}

    if shape.kind == "train":
        fwd = _fwd_flops(cfg, plan, b, s)
        if causal_skip and "attn_core" in fwd and cfg.family != "audio":
            fwd["attn_core"] /= 2.0  # triangular kv-block loop
        f_layers = sum(v for k, v in fwd.items() if k != "head")
        # fwd + remat recompute + backward(2x), head has no remat.
        for k, v in fwd.items():
            fb[k] = v * (3 if k == "head" else 4)
        fb["optimizer"] = 20.0 * cfg.n_params()
        tokens = b * s
        bb["params"] = pbytes * 3 + cfg.n_params() * (BF16 * 2)  # adam + casts
        bb["activations"] = (
            ACT_RW_PER_BLOCK * cfg.n_layers * tokens * d * BF16 * 2
        )
        if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            nq = max(s // 512, 1)
            n_att = (
                cfg.n_layers
                if cfg.family != "hybrid"
                else max(-(-cfg.n_layers // cfg.attn_every) - 1, 1)
            )
            bb["attn_kv_stream"] = (
                3 * n_att * b * plan.slots * s * plan.head_dim * BF16 * nq
            )
        bb["logits"] = tokens * cfg.vocab_size * F32 * 2
        del f_layers
    elif shape.kind == "prefill":
        fwd = _fwd_flops(cfg, plan, b, s)
        if causal_skip and "attn_core" in fwd and cfg.family != "audio":
            fwd["attn_core"] /= 2.0
        fb.update(fwd)
        fb["head"] = 2 * b * d * cfg.vocab_size  # last position only
        tokens = b * s
        bb["params"] = cfg.n_params() * BF16
        bb["activations"] = (
            ACT_RW_PER_BLOCK / 2 * cfg.n_layers * tokens * d * BF16
        )
        bb["cache_write"] = _cache_bytes(cfg, plan, b, s)
        bb["logits"] = b * cfg.vocab_size * F32
        if cfg.family in ("dense", "moe", "vlm", "audio"):
            nq = max(s // 512, 1)
            bb["attn_kv_stream"] = (
                3 * cfg.n_layers * b * plan.slots * s * plan.head_dim * BF16 * nq
            )
    else:  # decode / long-decode: one token per sequence
        fwd = _fwd_flops(cfg, plan, b, 1, decode=True, cache_len=s)
        fb.update(fwd)
        bb["params"] = cfg.n_params() * BF16
        cache_b = _cache_bytes(cfg, plan, b, s)
        if kv_quant:  # int8 rows + f32 scale per head row
            cache_b *= (plan.head_dim + 4) / (plan.head_dim * BF16)
        bb["cache_rw"] = cache_b
        bb["logits"] = b * cfg.vocab_size * F32
    return CellCost(
        flops=float(sum(fb.values())),
        bytes=float(sum(bb.values())),
        flops_by={k: float(v) for k, v in fb.items()},
        bytes_by={k: float(v) for k, v in bb.items()},
    )


def _cache_bytes(cfg: ArchConfig, plan: AttentionPlan, b: int, smax: int) -> float:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm", "audio"):
        return 2 * cfg.n_layers * b * plan.slots * smax * plan.head_dim * BF16
    if fam == "hybrid":
        n_shared = max(-(-cfg.n_layers // cfg.attn_every) - 1, 1)
        kv = 2 * n_shared * b * plan.slots * smax * plan.head_dim * BF16
        d_inner = 2 * cfg.d_model
        h = d_inner // cfg.ssm_head_dim
        ssm = cfg.n_layers * b * h * cfg.ssm_head_dim * cfg.ssm_state * F32
        return kv + ssm
    if fam == "ssm":
        h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
        return cfg.n_layers * b * h * dh * dh * F32
    raise ValueError(fam)
