"""The comparison of the language-model serving cells: one request's
served answer against the plain reference's logits over the same
prompt and the same served tokens (teacher-forced). ``want`` is the
reference's logits at the position of each served token's choice
(``(max_new, vocab)``: the prompt's last position, then each decode
step's); ``got`` the program's logits at the compared steps
(``steps``, ``logits``) and every token it served (``served``).

* ``logits``: at each compared step, the largest absolute error over
  the vocabulary divided by the largest absolute reference logit
  there; the worst step. Logits are compared, not tokens: with random
  weights the largest logit changes on rounding.
* ``token_gap``: at every served token's position, how far the
  reference's logit of that token lies below the reference's best
  there, divided by the largest absolute reference logit there; the
  worst position. A greedy token that is not the reference's best by
  more than rounding, or one altered after its choice, shows here.

A stage sample (the driver's copy of one decode step's
``decode_attention`` calls for one request; ``want`` the reference's
attention over the same query and cache rows) gives one number:

* ``attention``: at each call, the largest absolute error over the
  heads' outputs divided by the largest absolute reference output
  there; the worst call. An attention over fewer or other positions
  than the step's shows here, where a logit does not show it (with
  near-uniform attention over a thousand positions, one position
  moves the output by about its thousandth, and a logit by less than
  bfloat16's rounding).

A value that is not finite, or a shape that differs, reads as
infinity. The harness takes the worst over the requests compared.
"""

from __future__ import annotations

import numpy as np

__all__ = ["compare"]


def compare(got: dict, want: np.ndarray) -> dict[str, float]:
    """The numbers of one request, or of one stage sample."""
    w = np.asarray(want, np.float64)
    if "attention" in got:
        g = np.asarray(got["attention"], np.float64)
        if g.shape != w.shape or not np.isfinite(g).all():
            return {"attention": float("inf")}
        calls = len(w)
        scale = np.maximum(np.abs(w).reshape(calls, -1).max(-1), np.finfo(np.float64).tiny)
        return {"attention": float((np.abs(g - w).reshape(calls, -1).max(-1) / scale).max())}
    g = np.asarray(got["logits"], np.float64)
    served = np.asarray(got["served"], np.int64)
    steps = np.asarray(got["steps"], np.int64)
    scale = np.maximum(np.abs(w).max(axis=-1), np.finfo(np.float64).tiny)
    out = {"logits": float("inf"), "token_gap": float("inf")}
    if g.shape == (len(steps), w.shape[-1]) and steps.max() < len(w) and np.isfinite(g).all():
        out["logits"] = float((np.abs(g - w[steps]).max(axis=-1) / scale[steps]).max())
    if served.shape == (len(w),) and served.min() >= 0 and served.max() < w.shape[-1]:
        best = w.max(axis=-1)
        out["token_gap"] = float(((best - w[np.arange(len(w)), served]) / scale).max())
    return out
