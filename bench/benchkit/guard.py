"""The run's guard against JAX: the top-level names of the modules
loaded in this process, compared whole (``repro_torch`` is the port,
``repro`` the JAX package)."""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden_modules"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)
