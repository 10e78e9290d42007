"""``torch.cuda.max_memory_allocated()`` in GiB, from the window's
opening (reset there, the lanes' memory slots full) until the
driver's ``PEAK_TILES``-th tile completed in the window: a fixed
amount of work, so that a faster program does not read larger
for holding more finished tiles."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
