"""Percent of the card's bfloat16 peak (989 TFLOP/s dense) that the
traced window's model FLOPs reach: each batch admitted and completed
inside the traced window, its prefill over the prompt (the head at the
last position) and its decode steps (one position each, the head at
each), counted from the configuration's numbers
(``benchkit.flops.hybrid_forward_flops``), over the traced window's
seconds. The whole step's share: it bounds every kernel's roofline."""

from benchkit.flops import hybrid_forward_flops
from benchkit.peaks import BF16_FLOPS
from kinds.serve import window_batches


def read(run):
    if run.device is None:
        return None
    own = run.own
    batches = window_batches(run, run.device.start, run.device.end)
    if not batches:
        return None
    plen = own.prompt_len
    flops = 0.0
    for b in batches:
        per_seq = hybrid_forward_flops(own.model, 0, plen, 1) + sum(
            hybrid_forward_flops(own.model, plen - 1 + s, plen + s, 1)
            for s in range(1, b.decode_steps + 1))
        flops += len(b.rids) * per_seq
    return 100.0 * flops / run.device.window_s / BF16_FLOPS
