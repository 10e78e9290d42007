"""The port stands alone: no module under ``src/repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, the copied runtime
modules are byte-identical to their originals, and the entry points
that default to the card raise where there is none."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}

COPIED = [
    *(f"core/{m}.py" for m in ("workflow", "variants", "calibration", "cost_model",
                               "scheduling", "worker", "manager")),
    *(f"staging/{p.name}" for p in sorted((REF / "staging").glob("*.py"))),
    *(f"telemetry/{m}.py" for m in ("metrics", "tracing", "export", "recorder")),
    *(f"transport/{m}.py" for m in ("bus", "inproc", "socketbus", "endpoint")),
    *(f"serving/{p.name}" for p in sorted((REF / "serving").glob("*.py"))),
    "app/tiles.py",
    "data/ledger.py",
    "models/config.py",
    *(f"configs/{p.name}" for p in sorted((REF / "configs").glob("*.py"))
      if p.name != "__init__.py"),
]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch, repro_torch.app, repro_torch.core, repro_torch.staging\n"
        "import repro_torch.telemetry, repro_torch.transport\n"
        "import repro_torch.faults, repro_torch.serving, repro_torch.transport.endpoint\n"
        "import repro_torch.transport.demo, repro_torch.app.pipeline\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "import repro_torch.models, repro_torch.configs, repro_torch.train\n"
        "import repro_torch.launch.serve, repro_torch.launch.costs_h100\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.ckpt\n"
        "import repro_torch.launch.train\n"
        "import chip_smoke\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and"
        " (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("rel", COPIED)
def test_runtime_copy_is_byte_identical(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes(), rel


def test_card_entry_points_raise_without_a_card():
    """Decided here, not at import: with no card, ``device="cuda"`` (the
    default) raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.app import register_variants, run_tile, synth_tile
    from repro_torch.app.pipeline import wsi_registry_cuda
    from repro_torch.app.segmentation import rbc_detection_accel
    from repro_torch.core import VariantRegistry

    with pytest.raises(RuntimeError, match="cuda"):
        register_variants(VariantRegistry())
    with pytest.raises(RuntimeError, match="cuda"):
        register_variants(VariantRegistry(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        wsi_registry_cuda()  # a spawned worker's factory: no CPU fallback
    tile = synth_tile(0, size=32, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        run_tile(tile, "accel")
    with pytest.raises(RuntimeError, match="cuda"):
        rbc_detection_accel(np.zeros((8, 8, 3), np.uint8))


def test_chip_smoke_fails_without_a_card(tmp_path):
    """``chip_smoke.py`` exits non-zero with no result line, both here
    (no card) and alone in a directory without the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_lm_entry_points_raise_without_a_card():
    """``serve_requests()`` and ``build_model`` default to the card and
    raise without one; nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import build_model

    with pytest.raises(RuntimeError, match="cuda"):
        serve_requests()
    with pytest.raises(RuntimeError, match="cuda"):
        serve_requests(arch="zamba2-1.2b", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_smoke_config("zamba2-1.2b"), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_smoke_config("qwen1.5-4b"))


def test_configs_match_reference():
    """The port's config registry resolves every architecture to the
    reference's configuration (its ``__init__`` differs from the
    reference's in one import line, so it is not in ``COPIED``)."""
    import dataclasses

    from repro.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch import configs as port_configs

    assert port_configs.ARCH_IDS == ARCH_IDS
    for arch in [*ARCH_IDS, "zamba2-1.2b", "qwen1.5-4b"]:
        assert dataclasses.asdict(port_configs.get_config(arch)) == dataclasses.asdict(
            get_config(arch))
        assert dataclasses.asdict(port_configs.get_smoke_config(arch)) == dataclasses.asdict(
            get_smoke_config(arch))


def test_training_entry_points_raise_without_a_card():
    """``run_training()``, ``build_model(..., trainable=True)`` and the
    loader's default ``device_put`` default to the card and raise
    without one; nothing trains on the CPU unless asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import ChunkLedger, PrefetchLoader, TokenChunkSource
    from repro_torch.launch.train import run_training
    from repro_torch.models import build_model

    with pytest.raises(RuntimeError, match="cuda"):
        run_training()
    with pytest.raises(RuntimeError, match="cuda"):
        run_training(arch="zamba2-1.2b", steps=1, batch=1, seq=31, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_smoke_config("zamba2-1.2b"), trainable=True)
    with pytest.raises(RuntimeError, match="cuda"):
        PrefetchLoader(ChunkLedger(2), TokenChunkSource(16, 4, 1))
