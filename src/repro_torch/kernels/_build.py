"""Build and load the CUDA kernels of this package.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a -O3``, no fast math) into its
own shared library with a plain C interface, loaded with ``ctypes``.
No PyTorch headers are involved, so a build takes seconds. Libraries
go to ``build/torch_kernels/`` at the repository root, named by a hash
of the source, the ``csrc/`` headers it includes (``#include "x.cuh"``)
and the flags: an unchanged source is built once, and an edited header
rebuilds every source that includes it.

A build happens at first use, never at import. A failed build raises;
nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["KERNELS", "build_all", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
KERNELS = (
    "color_deconv", "morph_recon", "feature_fused", "sobel_stats",
    "flash_attention", "decode_attention", "mamba2_scan",
)
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, directly
    or through another header, in the order first met."""
    seen: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha1()
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen | None]:
    target = _target(name)
    log = target.with_suffix(".log")
    if target.exists():
        return target, log, None
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return target, log, proc


def _finish(name: str, target: Path, log: Path, proc) -> None:
    if proc is None:
        return
    rc = proc.wait()
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (rc={rc}):\n{log.read_text()}"
        )
    os.replace(tmp, target)  # atomic: concurrent builds race safely


def build_all(names=KERNELS) -> dict[str, str]:
    """Build every named kernel library at once (one ``nvcc`` process
    per source, all started together) and return ``{name: ptxas log}``."""
    started: dict[str, tuple] = {}
    with _lock:
        try:
            for n in names:
                started[n] = _start(n)
            for n, (target, log, proc) in started.items():
                _finish(n, target, log, proc)
        finally:
            for _, _, proc in started.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return {
        n: log.read_text() if log.exists() else ""
        for n, (_, log, _) in started.items()
    }


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib
