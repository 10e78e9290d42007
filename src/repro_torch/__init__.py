"""PyTorch/CUDA port of the hierarchical-pipeline middleware.

A second package beside :mod:`repro` (the JAX reference). It imports
``torch`` and numpy and never ``jax`` or anything from ``repro``: the
framework-neutral runtime modules it needs (Manager/Worker, variants,
staging tiers, telemetry, the bus contract) are byte-identical copies
kept under this package, and the WSI application plus its three
main-path kernels (``color_deconv``, ``morph_recon``,
``feature_fused``) are ported, the kernels as hand-written CUDA C++ for
Hopper (``kernels/csrc/*.cu``).

Entry points run on the CUDA card by default; pass ``device="cpu"`` to
run the kernels' plain PyTorch versions instead (as the tests do).
"""

__version__ = "0.1.0"
