"""Milliseconds per tile of the interpreter's collections, which hold
every thread: the program's ``gc`` spans clipped to the window, over the
tiles completed in it."""

from kinds.wsi_record import per_tile


def read(run):
    spans = [s for s in run.spans if s["name"] == "gc"]
    if not spans:
        return None
    lo, hi = run.wall_open, run.wall_open + run.seconds
    secs = sum(max(0.0, min(s["ts"] + s["dur"], hi) - max(s["ts"], lo)) for s in spans)
    return per_tile(run, 1e3 * secs)
