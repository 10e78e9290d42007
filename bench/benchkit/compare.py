"""What decides ``correct``, shared by every kind: the numbers of each
compared sample, the worst of each over the samples, and whether each
is within its limit (``bench/limits/<cell>.json``). The numbers
themselves come from the configuration's comparison
(``bench/compare/<compare>.py``, named in its file). A sample gives the
numbers of what it holds: a cell may compare samples of more than one
stage, each with numbers of its own."""

from __future__ import annotations

__all__ = ["judge", "within", "worst"]


def worst(per_sample: list[dict[str, float]]) -> dict[str, float]:
    """Each number's worst over the samples that give it."""
    keys = sorted({k for d in per_sample for k in d})
    return {k: max(d[k] for d in per_sample if k in d) for k in keys}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """True where every number is within its limit (and every limit
    has a number)."""
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())


def within(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """True where every number that one sample gives is within its
    limit."""
    return all(v <= limits[k] for k, v in numbers.items() if k in limits)
