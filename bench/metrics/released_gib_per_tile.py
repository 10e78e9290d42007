"""GiB a tile that the program drops once the tile finished: the
``bytes`` of the ``release`` spans (a worker dropping a finished tile's
outputs, the port's ``core/release.py``) of the tiles completed in the
window, over their number. A program without the span reads nothing."""

from benchkit.spans import per_tile, tile_spans


def read(run):
    spans = tile_spans(run, "release")
    return per_tile(run, sum(s["args"]["bytes"] for s in spans) / 2**30) if spans else None
