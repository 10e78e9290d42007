"""The WSI cells' own record (``Run.own``) and what their readers of
the program's spans share: a tile is one unit of the traffic (an
``Item`` keyed by its place in the bag, ``start`` the lease of its
first stage), and a tile's spans carry it as ``args.chunk``, or the
uid of its op instance (``args.uid``, mapped by ``op_chunks``)."""

from __future__ import annotations

from dataclasses import dataclass, field

from benchkit.spans import Busy

__all__ = ["WsiRecord", "device_s_by_op", "op_intervals", "op_seconds", "per_tile",
           "tile_spans"]


@dataclass
class WsiRecord:
    tile_shape: tuple[int, int]
    stage_ops: dict[str, list[str]]                        # stage name -> its op names
    op_chunks: dict[int, int] = field(default_factory=dict)  # op instance uid -> its tile

    def stage_span_seconds(self, run, stage: str) -> float:
        """Seconds of the ``op:*`` spans of ``stage``'s ops on the tiles
        completed inside the window (found by the op's uid, not by the
        span's wall-clock start, which a step of the host's clock moves)."""
        names = {f"op:{op}" for op in self.stage_ops[stage]}
        done = {t.key for t in run.done()}
        return sum(s["dur"] for s in run.spans if s["name"] in names
                   and self.op_chunks.get(s["args"].get("uid")) in done)


def tile_spans(run, name: str) -> list[dict]:
    """The spans ``name`` of the tiles completed in the window (by their
    ``args.chunk``)."""
    done = {t.key for t in run.done()}
    return [s for s in run.spans if s["name"] == name and s["args"].get("chunk") in done]


def per_tile(run, total: float) -> float | None:
    """``total`` over the tiles completed in the window."""
    n = len(run.done())
    return total / n if n else None


def op_intervals(run) -> list[tuple[str, float, float]]:
    """Each ``op:<name>`` span of the tiles completed in the window (by
    its op's uid), clipped to the traced window."""
    done = {t.key for t in run.done()}
    lo, hi = run.device.start, run.device.end
    out = []
    for s in run.spans:
        if s["name"].startswith("op:") and run.own.op_chunks.get(s["args"].get("uid")) in done:
            a, b = max(s["ts"], lo), min(s["ts"] + s["dur"], hi)
            if b > a:
                out.append((s["name"], a, b))
    return out


def op_seconds(run) -> float:
    """The length of :func:`op_intervals`."""
    return sum(b - a for _, a, b in op_intervals(run))


def device_s_by_op(run) -> dict[str, float]:
    """Device seconds inside :func:`op_intervals`, by ``op:<name>``."""
    busy, out = Busy(run.device), {}
    for name, a, b in op_intervals(run):
        out[name] = out.get(name, 0.0) + busy.within(a, b)
    return out


