"""Step builders of the port (serving only so far)."""

from .step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
