"""Flagship application: whole-slide-image nucleus segmentation +
feature computation (paper §II), expressed as a hierarchical workflow
over the middleware with CPU (numpy) and accelerator (PyTorch, the card
by default) function variants."""

from .pipeline import build_workflow, register_variants, run_tile
from .tiles import synth_tile

__all__ = ["build_workflow", "register_variants", "run_tile", "synth_tile"]
