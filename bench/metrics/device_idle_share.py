"""Percent of the traced window in which no kernel, copy or memset ran
on the card: one minus the union of their intervals over the window."""

from benchkit.trace import union_seconds


def read(run):
    if run.device is None or not run.device.events:
        return None
    return 100.0 * (1.0 - union_seconds(run.device.clipped()) / run.device.window_s)
