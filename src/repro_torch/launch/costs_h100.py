"""Roofline lane model of one NVIDIA H100 SXM for the PATS estimates.

Spec-sheet values (NVIDIA H100 data sheet, SXM part, dense rates
without sparsity), not measurements: 989 TFLOP/s bf16 on the tensor
cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM3, NVLink
900 GB/s to the host's other cards (450 GB/s each way). The copied
``core/cost_model.py`` stays byte-identical; the port passes this
lane where the reference uses ``TPU_V5E``.
"""

from __future__ import annotations

from ..core.cost_model import LaneModel

__all__ = ["H100_SXM"]

H100_SXM = LaneModel(
    name="h100_sxm",
    peak_flops=989e12,
    mem_bw=3.35e12,
    link_bw=450e9,
    vector_flops=67e12,
)
