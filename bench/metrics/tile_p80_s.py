"""80th percentile (nearest rank), over every tile completed inside the
window, of its turnaround: the lease of its first stage to the
completion of its last, its features then on the host."""

from benchkit.record import nearest_rank


def read(run):
    times = [t.done - t.start for t in run.done() if t.start is not None]
    return nearest_rank(times, 80.0) if times else None
