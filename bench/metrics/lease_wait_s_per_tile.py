"""Seconds per tile that the window's tiles' stages waited for a lease
once ready: the program's ``wait:lease`` spans (a stage instance's entry
into the Manager's pending queue to its lease) of every stage but a
tile's first, whose wait runs from the bag's start, over the tiles
completed in the window."""

from kinds.wsi_record import per_tile, tile_spans


def read(run):
    first = next(iter(run.own.stage_ops), None)
    spans = [s for s in tile_spans(run, "wait:lease") if s["args"].get("stage") != first]
    return per_tile(run, sum(s["dur"] for s in spans)) if spans else None
