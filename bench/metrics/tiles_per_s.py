"""Tiles whose last stage completed inside the window, over the window's seconds."""


def read(run):
    return len(run.done()) / run.seconds
