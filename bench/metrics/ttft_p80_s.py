"""80th percentile (nearest rank), over every request completed inside
the window, of its time to first token: its batch's admission (the
prefill call) to the host's receipt of its first token."""

from benchkit.record import nearest_rank


def read(run):
    times = [run.own.first[t.key] - t.start for t in run.done() if t.start is not None]
    return nearest_rank(times, 80.0) if times else None
