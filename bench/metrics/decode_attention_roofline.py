"""Percent of its roofline that ``decode_tc_kernel`` (the bfloat16
decode attention) reached in the traced window. Each launch is one
application of the shared block in one decode step of a batch, over
the positions valid at that step (the prompt, the tokens decoded
before, and the step's own): K and V of those positions read once in
bfloat16, the queries read and the outputs written once, the lengths
read once, against ``4 x positions x head_dim`` operations a query
head; at 3.35 TB/s and 989 TFLOP/s (the bytes bound it). The launches
are matched to the steps in the order they started: a trace with
another number of launches reads nothing."""

from benchkit.peaks import BF16_FLOPS, roofline_share_per_launch
from kinds.serve import window_batches


def read(run):
    if run.device is None:
        return None
    own = run.own
    m = own.model
    hq, hkv, hd = int(m["n_heads"]), int(m["n_kv_heads"]), int(m["head_dim"])
    apps = -(-int(m["n_layers"]) // int(m["attn_every"])) - 1
    sizes = []
    for b in window_batches(run, run.device.start, run.device.end):
        rows = len(b.rids)
        for step in range(1, b.decode_steps + 1):
            valid = own.prompt_len + step
            nbytes = 2.0 * rows * (2 * hkv * valid * hd + 2 * hq * hd) + 4.0 * rows
            sizes += [(nbytes, 4.0 * rows * hq * valid * hd)] * apps
    return roofline_share_per_launch(run, "decode_tc_kernel", sizes, BF16_FLOPS)
