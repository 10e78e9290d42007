"""Seconds from the process's start to the window's opening: imports,
the card's start, the traffic, the kernels' load (and build, on a
checkout's first run) and the warm-up tiles."""


def read(run):
    return run.setup_s
