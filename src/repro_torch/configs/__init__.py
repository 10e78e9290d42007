"""Assigned architecture configs (public-literature parameters).

Select with ``--arch <id>`` in the launchers.  Every entry also defines
its valid input shapes (see ``SHAPES``) and a reduced smoke config.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from ..models.config import ArchConfig, reduced

ARCH_IDS = [
    "zamba2_1p2b",
    "phi3_medium_14b",
    "mistral_nemo_12b",
    "qwen1p5_4b",
    "yi_34b",
    "arctic_480b",
    "dbrx_132b",
    "xlstm_125m",
    "whisper_small",
    "pixtral_12b",
]

#: canonical cli names (dashes) -> module ids
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen1.5-4b": "qwen1p5_4b",
})


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode" | "long-decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "long-decode"),
}


def get_config(arch: str) -> ArchConfig:
    arch = ALIASES.get(arch, arch)
    mod = importlib.import_module(f".{arch}", __package__)
    return mod.CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return reduced(get_config(arch))


def valid_cells(arch: str) -> list[str]:
    """Which of the 4 shapes this arch runs (DESIGN.md §Arch-applicability)."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k"]
    if cfg.supports_decode:
        cells.append("decode_32k")
    if cfg.supports_long:
        cells.append("long_500k")
    return cells


__all__ = [
    "ARCH_IDS",
    "ALIASES",
    "SHAPES",
    "ShapeSpec",
    "get_config",
    "get_smoke_config",
    "valid_cells",
]
