"""``cudaMalloc`` calls of the caching allocator per tile: the rise of
``torch.cuda.memory_stats()["num_device_alloc"]`` across each op, which
the op's ``lane:between`` span carries as ``args.allocs``, summed over
the tiles completed in the window, over their number."""

from benchkit.spans import per_tile, tile_spans


def read(run):
    spans = [s for s in tile_spans(run, "lane:between") if "allocs" in s["args"]]
    return per_tile(run, sum(s["args"]["allocs"] for s in spans)) if spans else None
