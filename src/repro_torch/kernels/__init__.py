"""Hand-written CUDA kernels of the port (``csrc/*.cu``).

* :mod:`.ops` — the entry points, dispatching on the tensor's device,
  and the launch counters (``launch_counts`` / ``reset_launch_counts``);
* :mod:`.color_deconv`, :mod:`.morph_recon`, :mod:`.feature_fused`,
  :mod:`.sobel_stats` (image kernels), :mod:`.flash_attention`,
  :mod:`.decode_attention`, :mod:`.mamba2_scan` (language-model
  kernels) — one ctypes wrapper (and launch counter) per kernel;
* :mod:`.ref` — the plain PyTorch versions;
* :mod:`._build` — compiles the sources with ``nvcc`` at first use.

Nothing here builds or needs a CUDA toolchain at import time. The
package re-exports nothing, so each kernel's name stays its module.
"""
