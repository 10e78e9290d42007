"""What the language-model serving cells' driver and readers share: the
traffic's prompts made from the seed, and the cells' own record
(``Run.own``).

A request is one unit of the traffic (an ``Item`` keyed by its id,
``start`` its batch's admission, ``done`` the host's receipt of its
last token). A batch is what the port's batcher admits at once: its
prompts are prefilled in one call, then decoded one token a step until
each request has ``max_new`` tokens.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["Batch", "ServeRecord", "make_prompts", "rng_for", "window_batches"]


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator of its own for ``(seed, *stream)``; any whole seed,
    negative or beyond 64 bits, maps to one entropy value."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


def make_prompts(spec: dict, seed: int, vocab: int) -> np.ndarray:
    """The traffic's prompts, ``(requests, prompt_len)`` int32: each
    request's ids drawn uniformly over the vocabulary, one request after
    the other, from ``numpy.random.default_rng(seed)``, as the port's
    ``serve_requests(seed=seed)`` draws its prompts (``seed`` a
    non-negative whole number). The driver holds every prompt the
    program prefills to these."""
    rs = np.random.default_rng(int(seed))
    n, length = int(spec["requests"]), int(spec["prompt_len"])
    out = np.empty((n, length), np.int32)
    for i in range(n):
        out[i] = rs.integers(0, vocab, length).astype(np.int32)
    return out


@dataclass
class Batch:
    """One admitted batch, on the driver's clock (``time.monotonic``):
    the prefill call, the host's receipt of its first tokens and of its
    last, and the decode steps it took."""

    index: int
    rids: list[int]
    t_admit: float
    t_first: float = 0.0
    t_done: float = 0.0
    decode_steps: int = 0


@dataclass
class ServeRecord:
    model: dict                      # the configuration's numbers (bench/configs/<name>.json)
    prompt_len: int
    batch_size: int
    ssd_chunk: int                   # the program's SSD chunk of a prefill (the configuration's)
    batches: list[Batch] = field(default_factory=list)
    first: dict[int, float] = field(default_factory=dict)   # request -> receipt of its first token
    tokens: dict[int, int] = field(default_factory=dict)    # request -> tokens the host received


def window_batches(run, lo: float | None = None, hi: float | None = None) -> list[Batch]:
    """The batches admitted after the window opened and complete when it
    closed (on the driver's clock), or, with ``lo`` and ``hi``, inside
    that wall-clock interval (the traced window)."""
    out = []
    for b in run.own.batches:
        a, d = (b.t_admit, b.t_done) if lo is None else (run.wall(b.t_admit), run.wall(b.t_done))
        start, end = (run.t_open, run.t_close) if lo is None else (lo, hi)
        if b.t_done and start <= a and d <= end:
            out.append(b)
    return out
