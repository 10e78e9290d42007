"""Model FLOPs of a forward pass, counted from a configuration's
numbers (its file under ``bench/configs/``), never from the program: 2
for each multiply-add of each weight a position passes through, the
output head where a position's logits are needed, and the attention's
products over the positions it attends to.

For the hybrid family (Mamba2 layers with a shared attention block
after every ``attn_every`` of them):

* each Mamba2 layer: 2 x its parameters a position (its projections,
  its depthwise convolution, its norms and per-head scalars); the SSD
  state's own arithmetic, ~4 x heads x head dim x state a position,
  2% of the layer's at zamba2-1.2b's widths, is not counted;
* each application of the shared block: 2 x its parameters a position,
  and 4 x context x head dim x heads (``q k^T`` and ``p v``), the
  context of position ``p`` being ``p + 1`` positions;
* the head: 2 x d_model x vocab at each position whose logits are read.
"""

from __future__ import annotations

__all__ = ["hybrid_forward_flops", "hybrid_params"]


def hybrid_params(cfg: dict) -> dict[str, int]:
    """Parameters of one Mamba2 layer, of the shared block, of the head;
    and the shared block's applications in one forward pass."""
    d = int(cfg["d_model"])
    di = int(cfg["ssm_expand"]) * d
    n, p, w = int(cfg["ssm_state"]), int(cfg["ssm_head_dim"]), int(cfg["ssm_conv_width"])
    h, conv = di // p, di + 2 * n
    hq, hkv, hd, ff = (int(cfg[k]) for k in ("n_heads", "n_kv_heads", "head_dim", "d_ff"))
    layers, every = int(cfg["n_layers"]), int(cfg["attn_every"])
    return {
        "mamba_layer": d + d * (2 * di + 2 * n + h) + conv * (w + 1) + 3 * h + di + di * d,
        "shared": 2 * d + d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff,
        "head": d + d * int(cfg["vocab_size"]),
        "layers": layers,
        "applications": -(-layers // every) - 1,
    }


def hybrid_forward_flops(cfg: dict, start: int, stop: int, head_rows: int) -> float:
    """FLOPs of one sequence's positions ``start .. stop - 1`` (each
    attending to every earlier position and itself), with the head at
    ``head_rows`` of them."""
    k = hybrid_params(cfg)
    count = stop - start
    contexts = (stop * (stop + 1) - start * (start + 1)) // 2   # sum of p + 1
    per_position = 2 * (k["layers"] * k["mamba_layer"] + k["applications"] * k["shared"])
    attention = 4 * k["applications"] * int(cfg["head_dim"]) * int(cfg["n_heads"]) * contexts
    return float(per_position * count + attention + 2 * k["head"] * head_rows)
