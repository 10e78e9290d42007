"""Percent of the ops' host time in which the card was busy: the union
of kernel, copy and memset intervals inside each ``op:<name>`` span of
the tiles completed in the window, over those spans' length, both
clipped to the traced window. A ``gpu`` op synchronises before it
returns, so the device intervals inside its span are its own."""

from kinds.wsi_record import device_s_by_op, op_seconds


def read(run):
    if run.device is None or not run.device.events:
        return None
    span_s = op_seconds(run)
    return 100.0 * sum(device_s_by_op(run).values()) / span_s if span_s > 0 else None
