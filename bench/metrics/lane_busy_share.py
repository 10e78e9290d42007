"""Percent of the window the worker's lanes spent in ops: the rise of
``WorkerRuntime.stats()["lane_busy"]`` (summed over lanes) over the
window, divided by its length."""


def read(run):
    return 100.0 * run.counter_delta("lane_busy") / run.seconds
