"""Seconds from the process's start to the window's opening: imports,
the card's start, the traffic, the weights, the kernels' load (and
build, on a checkout's first run) and the warm-up (tiles, or a batch)."""


def read(run):
    return run.setup_s
