"""Seconds per tile that the window's tiles' ops sat ready in the
worker's queue: the program's ``wait:op`` spans (an op's push on the
``ReadyScheduler`` to a lane taking it) of the tiles completed in the
window, summed, over their number."""

from benchkit.spans import per_tile, tile_spans


def read(run):
    spans = tile_spans(run, "wait:op")
    return per_tile(run, sum(s["dur"] for s in spans)) if spans else None
