"""Seconds a batch of the window spends from its admission (the prefill
call) to the host's receipt of its first tokens, averaged over the
window's batches: the steadier mean beside ``ttft_p80_s``."""

from kinds.serve import window_batches


def read(run):
    batches = window_batches(run)
    return sum(b.t_first - b.t_admit for b in batches) / len(batches) if batches else None
