"""Seconds per tile in the segmentation stage's ops: the program's
``op:<name>`` spans (host clock around each op, which synchronises the
card before it returns) that began inside the window, over the tiles
completed in it."""


def read(run):
    done = len(run.done())
    secs = run.own.stage_span_seconds(run, "segmentation")
    return secs / done if done and secs > 0 else None
