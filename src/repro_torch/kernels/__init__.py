"""Hand-written CUDA kernels for the main path (``csrc/*.cu``).

* :mod:`.ops` — the entry points, dispatching on the tensor's device,
  and the launch counters (``launch_counts`` / ``reset_launch_counts``);
* :mod:`.color_deconv`, :mod:`.morph_recon`, :mod:`.feature_fused` —
  one ctypes wrapper (and launch counter) per kernel;
* :mod:`.ref` — the plain PyTorch versions;
* :mod:`._build` — compiles the sources with ``nvcc`` at first use.

Nothing here builds or needs a CUDA toolchain at import time. The
package re-exports nothing, so each kernel's name stays its module.
"""
