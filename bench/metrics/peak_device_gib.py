"""``torch.cuda.max_memory_allocated()`` in GiB, from the window's
opening (reset there), over the span of work that the cell's driver
states: the WSI driver reads it until its ``PEAK_TILES``-th tile
completed in the window (the lanes' memory slots full), a fixed amount
of work, so that a faster program does not read larger for holding more
finished tiles; a model driver reads the whole window, since a static
batch's memory is flat."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
