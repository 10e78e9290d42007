"""Plain reference of the hybrid (Zamba2) configurations: the forward
pass in float32 over a whole sequence, in plain ``torch`` operations,
with no kernel, no cache and no batching, and the seeded weights that
both it and the program are given.

The architecture is the port's ``hybrid`` family (``repro_torch``'s
``models/transformer.py``, ``mamba2.py``, ``attention.py``), which the
configuration file's ``departures`` hold against the Zamba2 report
(arXiv:2411.15242):

* ``n_layers`` Mamba2 blocks, each ``x + mamba2(rmsnorm(x))``; after
  every ``attn_every`` of them, except after the last group, one shared
  attention block (the same weights at each application):
  ``x + attn(rmsnorm(x))``, then ``x + swiglu_mlp(rmsnorm(x))``;
* Mamba2 (SSD): ``in_proj`` to ``[z, x, B, C, dt]`` (one B/C group, heads
  of ``ssm_head_dim``, inner width ``ssm_expand * d_model``), a causal
  depthwise convolution of width ``ssm_conv_width`` with bias over
  ``[x, B, C]`` and SiLU, ``dt = softplus(dt + dt_bias)``, ``A =
  -exp(A_log)``; ``y_t = sum_{s<=t} (C_t . B_s) exp(sum_{s<r<=t} dt_r A)
  dt_s x_s + D x_t``, written here in its materialised full-sequence
  form (the decay matrix times ``C B^T``, per head), which is exact and
  parallel over the sequence; then ``rmsnorm(y * silu(z))`` and
  ``out_proj``;
* attention: RoPE (rotate-half, ``rope_theta``) on q and k at positions
  ``0..T-1``, causal softmax of ``q k^T / sqrt(head_dim)``;
* a final rmsnorm and an untied output head.

Matrices are held in bfloat16, as the configuration serves them, and
upcast here; norms, the convolution, ``A_log``, ``dt_bias`` and ``D``
in float32. The products run in float32 with TF32 off. ``weights="fp8"``
rounds each bfloat16 matrix to float8 e4m3 with one scale a tensor (the
control: the precision below the configuration's).

It imports only torch, numpy and math, and takes nothing that the
program made: the weights are made here from the seed
(:func:`make_weights`, which the driver also calls to give the program
the same ones), the tokens are the harness's prompt and the tokens the
program served, which the reference only reads to be judged on.

One stage is also checked by itself, from the program's own state: a
decode step's attention (:func:`decode_attention`), plain softmax
attention in float32 of the program's query over the program's cache
rows, as many as the harness counts for the step. The whole pass above
checks what this skips: the projections and the cache's writes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["decode_attention", "make_weights", "param_spec", "run_sample"]

#: The matrices, held in bfloat16 (the port's ``BF16_WEIGHTS``).
BF16 = frozenset({"in_proj", "out_proj", "wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down",
                  "embed", "head"})
#: Mamba2's published initial ranges: dt log-uniform in [1e-3, 1e-1]
#: (``dt_bias`` its inverse softplus), ``A`` uniform in [1, 16].
DT_RANGE, A_RANGE = (1e-3, 1e-1), (1.0, 16.0)


def _dims(cfg: dict) -> dict:
    d = int(cfg["d_model"])
    di = int(cfg["ssm_expand"]) * d
    n, p = int(cfg["ssm_state"]), int(cfg["ssm_head_dim"])
    return {"d": d, "di": di, "n": n, "p": p, "h": di // p, "conv": di + 2 * n,
            "w": int(cfg["ssm_conv_width"]), "hq": int(cfg["n_heads"]),
            "hkv": int(cfg["n_kv_heads"]), "hd": int(cfg["head_dim"]), "ff": int(cfg["d_ff"]),
            "v": int(cfg["vocab_size"])}


def param_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], tuple]]:
    """``(name, shape, init)`` of every weight, named as the port's state
    dict names it. ``init`` is ``("normal", std)``, ``("norm",)`` (1 +
    0.1 N(0, 1)), ``("one",)``, ``("a_log",)`` or ``("dt_bias",)``."""
    k = _dims(cfg)
    d, di, hq, hkv, hd = k["d"], k["di"], k["hq"], k["hkv"], k["hd"]
    g = hq // hkv
    out = [("embed", (k["v"], d), ("normal", 0.02)), ("final_norm.w", (d,), ("norm",)),
           ("head", (d, k["v"]), ("normal", d ** -0.5))]
    for i in range(int(cfg["n_layers"])):
        b = f"blocks.{i}."
        out += [(b + "ln.w", (d,), ("norm",)),
                (b + "mamba.in_proj", (d, 2 * di + 2 * k["n"] + k["h"]), ("normal", d ** -0.5)),
                (b + "mamba.conv_w", (k["conv"], k["w"]), ("normal", k["w"] ** -0.5)),
                (b + "mamba.conv_b", (k["conv"],), ("normal", 0.1)),
                (b + "mamba.A_log", (k["h"],), ("a_log",)),
                (b + "mamba.dt_bias", (k["h"],), ("dt_bias",)),
                (b + "mamba.D", (k["h"],), ("norm",)),
                (b + "mamba.norm_w", (di,), ("norm",)),
                (b + "mamba.out_proj", (di, d), ("normal", di ** -0.5))]
    out += [("shared.ln1.w", (d,), ("norm",)), ("shared.ln2.w", (d,), ("norm",)),
            ("shared.attn.wq", (d, hkv, g, hd), ("normal", d ** -0.5)),
            ("shared.attn.wk", (d, hkv, hd), ("normal", d ** -0.5)),
            ("shared.attn.wv", (d, hkv, hd), ("normal", d ** -0.5)),
            ("shared.attn.wo", (hkv, g, hd, d), ("normal", (hq * hd) ** -0.5)),
            ("shared.attn.head_mask", (hkv, g), ("one",)),
            ("shared.mlp.w_up", (d, k["ff"]), ("normal", d ** -0.5)),
            ("shared.mlp.w_gate", (d, k["ff"]), ("normal", d ** -0.5)),
            ("shared.mlp.w_down", (k["ff"], d), ("normal", k["ff"] ** -0.5))]
    return out


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every weight, on ``device``, from ``seed``: one draw of standard
    normals and one of uniforms for the whole model on a generator of
    ``device``, cut into the tensors in :func:`param_spec`'s order and
    held in the type the configuration serves them in."""
    dev = torch.device(device)
    spec = param_spec(cfg)
    gen = torch.Generator(dev).manual_seed(int(seed) % 2**64)
    n_normal = sum(math.prod(s) for _, s, init in spec if init[0] in ("normal", "norm"))
    n_unif = sum(math.prod(s) for _, s, init in spec if init[0] in ("a_log", "dt_bias"))
    normal = torch.randn(n_normal, generator=gen, device=dev)
    unif = torch.rand(n_unif, generator=gen, device=dev)
    out, i, j = {}, 0, 0
    lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
    for name, shape, init in spec:
        size = math.prod(shape)
        if init[0] in ("normal", "norm"):
            t = normal[i:i + size].view(shape)
            i += size
            t = t * init[1] if init[0] == "normal" else 1.0 + 0.1 * t
        elif init[0] == "one":
            t = torch.ones(shape, device=dev)
        else:
            u = unif[j:j + size].view(shape)
            j += size
            if init[0] == "a_log":
                t = torch.log(A_RANGE[0] + (A_RANGE[1] - A_RANGE[0]) * u)
            else:  # dt_bias: softplus(dt_bias) = dt
                dt = torch.exp(lo + (hi - lo) * u)
                t = dt + torch.log(-torch.expm1(-dt))
        leaf = name.rsplit(".", 1)[-1]
        out[name] = t.to(torch.bfloat16 if leaf in BF16 else torch.float32).contiguous()
    return out


def _fp8(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one scale for the tensor."""
    scale = w.abs().amax().clamp_min(1e-30) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _mamba2(w, pre: str, x: torch.Tensor, k: dict, eps: float) -> torch.Tensor:
    """One Mamba2 mixer over the whole sequence x (T, d)."""
    t_len = x.shape[0]
    proj = x @ w[pre + "in_proj"]
    z, xs, b, c, dt = proj.split([k["di"], k["di"], k["n"], k["n"], k["h"]], dim=-1)
    conv_in = torch.cat([xs, b, c], dim=-1)                                  # (T, conv)
    padded = torch.cat([conv_in.new_zeros(k["w"] - 1, k["conv"]), conv_in])
    cw = w[pre + "conv_w"]
    conv = sum(padded[i:i + t_len] * cw[:, i] for i in range(k["w"])) + w[pre + "conv_b"]
    xs, b, c = _silu(conv).split([k["di"], k["n"], k["n"]], dim=-1)
    dt = torch.nn.functional.softplus(dt + w[pre + "dt_bias"])               # (T, H)
    a = -torch.exp(w[pre + "A_log"])                                        # (H,)
    seg = torch.cumsum((dt * a).double(), dim=0)                           # (T, H)
    diff = (seg[:, None, :] - seg[None, :, :]).permute(2, 0, 1)             # (H, t, s)
    causal = torch.ones(t_len, t_len, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(diff.masked_fill(~causal, -math.inf)).float()         # exp(sum_{s<r<=t} dt A)
    scores = decay * (c @ b.T)[None]                                        # (H, t, s)
    xh = xs.view(t_len, k["h"], k["p"])
    xdt = (xh * dt[..., None]).permute(1, 0, 2)                             # (H, s, P)
    y = (scores @ xdt).permute(1, 0, 2) + xh * w[pre + "D"][None, :, None]  # (T, H, P)
    y = _rmsnorm(y.reshape(t_len, k["di"]) * _silu(z), w[pre + "norm_w"], eps)
    return y @ w[pre + "out_proj"]


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (heads, T, hd) rotated at positions 0..T-1 (rotate-half)."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _shared(w, x: torch.Tensor, k: dict, cfg: dict, eps: float) -> torch.Tensor:
    """The shared attention block (its residuals included) over x (T, d)."""
    t_len, hq, hkv, hd = x.shape[0], k["hq"], k["hkv"], k["hd"]
    h = _rmsnorm(x, w["shared.ln1.w"], eps)
    q = (h @ w["shared.attn.wq"].reshape(k["d"], -1)).view(t_len, hq, hd).transpose(0, 1)
    kk = (h @ w["shared.attn.wk"].reshape(k["d"], -1)).view(t_len, hkv, hd).transpose(0, 1)
    v = (h @ w["shared.attn.wv"].reshape(k["d"], -1)).view(t_len, hkv, hd).transpose(0, 1)
    theta = float(cfg["rope_theta"])
    q, kk = _rope(q, theta), _rope(kk, theta)
    kk, v = kk.repeat_interleave(hq // hkv, 0), v.repeat_interleave(hq // hkv, 0)
    s = q @ kk.transpose(1, 2) / math.sqrt(hd)
    causal = torch.ones(t_len, t_len, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1) @ v      # (Hq, T, hd)
    att = att * w["shared.attn.head_mask"].reshape(hq)[:, None, None]
    x = x + att.transpose(0, 1).reshape(t_len, hq * hd) @ w["shared.attn.wo"].reshape(-1, k["d"])
    h = _rmsnorm(x, w["shared.ln2.w"], eps)
    mlp = _silu(h @ w["shared.mlp.w_gate"]) * (h @ w["shared.mlp.w_up"])
    return x + mlp @ w["shared.mlp.w_down"]


def forward_logits(w: dict, cfg: dict, tokens: torch.Tensor, rows: list[int]) -> torch.Tensor:
    """Float32 logits ``(len(rows), vocab)`` at positions ``rows`` of the
    sequence ``tokens`` (T,), every weight in ``w`` already float32."""
    k, eps = _dims(cfg), float(cfg["norm_eps"])
    x = w["embed"][tokens]
    every, n = int(cfg["attn_every"]), int(cfg["n_layers"])
    for i in range(n):
        pre = f"blocks.{i}."
        x = x + _mamba2(w, pre + "mamba.", _rmsnorm(x, w[pre + "ln.w"], eps), k, eps)
        if (i + 1) % every == 0 and i + 1 < n:
            x = _shared(w, x, k, cfg, eps)
    return _rmsnorm(x[rows], w["final_norm.w"], eps) @ w["head"]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One decode step's attention, float32: ``q`` ``(calls, Hq, hd)``
    against every row of ``k``, ``v`` ``(calls, Hkv, positions, hd)``;
    query head ``h`` reads key head ``h // (Hq // Hkv)``."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    s = torch.einsum("chd,chsd->chs", q.float(), kf) / math.sqrt(q.shape[-1])
    return torch.einsum("chs,chsd->chd", torch.softmax(s, dim=-1), vf)


def run_sample(inputs: dict, device, weights: str = "as_configured") -> np.ndarray:
    """The reference's logits ``(rows, vocab)`` float32 on the host for
    one compared request: ``inputs`` holds the configuration's numbers
    (``config``), the weights' ``seed``, the whole sequence (``tokens``:
    the prompt, then the tokens the program served) and the positions
    compared (``rows``). ``weights="fp8"`` is the control. For a stage
    sample (``stage``: ``decode_attention``) the attention output
    ``(calls, Hq, hd)`` of its ``q``, ``k``, ``v``; with ``"fp8"`` each
    of them rounded to float8 first."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            if inputs.get("stage") == "decode_attention":
                qkv = [inputs[n].to(device).float() for n in ("q", "k", "v")]
                if weights == "fp8":
                    qkv = [_fp8(t) for t in qkv]
                return decode_attention(*qkv).cpu().numpy()
            cfg = inputs["config"]
            made = make_weights(cfg, inputs["seed"], device)
            w = {}
            for name, t in made.items():
                leaf = name.rsplit(".", 1)[-1]
                w[name] = _fp8(t.float()) if weights == "fp8" and leaf in BF16 else t.float()
            del made
            tokens = torch.as_tensor(np.asarray(inputs["tokens"]), dtype=torch.long, device=device)
            return forward_logits(w, cfg, tokens, list(inputs["rows"])).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
