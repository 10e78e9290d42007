"""Seconds per tile in the features stage's ops, as
``segmentation_s_per_tile`` reads the segmentation stage's."""


def read(run):
    done = len(run.done())
    secs = run.own.stage_span_seconds(run, "features")
    return secs / done if done and secs > 0 else None
