"""Blocking device-to-host reads per tile: the program's ``sync`` spans
(one per read through ``host_sync``: the sweeps' tests, counts,
downloads, uploads, ``bincount`` and the synchronize ending each op) of
the tiles completed in the window, over their number."""

from kinds.wsi_record import per_tile, tile_spans


def read(run):
    spans = tile_spans(run, "sync")
    return per_tile(run, len(spans)) if spans else None
