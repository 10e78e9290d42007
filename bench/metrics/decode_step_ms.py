"""Milliseconds of a decode step: the host's receipt of a batch's first
tokens to the receipt of its last, summed over the window's batches,
over the decode steps they took (each step's call, the device's work
and the loop's own host time between steps)."""

from kinds.serve import window_batches


def read(run):
    batches = window_batches(run)
    steps = sum(b.decode_steps for b in batches)
    return 1e3 * sum(b.t_done - b.t_first for b in batches) / steps if steps else None
