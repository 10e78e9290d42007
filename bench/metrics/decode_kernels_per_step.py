"""Kernel launches a decode step: the device trace's kernels that start
while a batch of the traced window decodes (the host's receipt of its
first tokens to that of its last, on the wall clock), over the decode
steps of those batches. Copies and memsets are not kernels."""

from bisect import bisect_left

from kinds.serve import window_batches


def read(run):
    if run.device is None:
        return None
    batches = window_batches(run, run.device.start, run.device.end)
    steps = sum(b.decode_steps for b in batches)
    starts = sorted(e.start for e in run.device.events if e.kind == "kernel")
    n = sum(bisect_left(starts, run.wall(b.t_done)) - bisect_left(starts, run.wall(b.t_first))
            for b in batches)
    return n / steps if steps and n else None
