"""Workload calibration constants derived from the paper's measurements.

The paper reports (Keeneland: 2x Intel X5660 + 3x NVIDIA M2090 per node):

* Fig 7  — per-operation GPU-vs-1-CPU-core speedups vary widely; the
  feature-computation stage accelerates best; Morph. Open is ~4% of CPU
  time but ~23% of the GPU-accelerated computation time.
* Fig 8  — end-to-end 1-GPU speedup ≈5.3x incl. I/O, ≈6.5x compute-only
  (1.22x higher); Closest placement beats OS by ~3/6/8% at 1/2/3 GPUs.
* Fig 9  — 12-core CPU speedup ≈9; 3 GPUs scale ≈linearly; PATS
  pipelined ≈1.33x over FCFS.
* §V-D   — CPU<->GPU data transfer ≈13% of computation time.
* Table II — 3 GPUs + 9 cores: FCFS ≈75s regardless of window; PATS
  75.1 -> 50.7s as the window grows 12 -> 19 (saturating ≈W=15).
* Fig 14 — 36,848 tiles on 100 nodes in <4 min ≈150 tiles/s; 77%
  strong-scaling efficiency with I/O, ≈93% compute-only.

Fig 7's exact bar heights are not recoverable from the text, so the
per-op speedups below are chosen to be *jointly consistent* with every
quantitative statement above (checked by ``validate_calibration`` and
tests/test_calibration.py):  Σ cpu_fraction = 1; Morph-Open GPU share
≈23%; aggregate compute-only speedup ≈6.5; PATS-assignable split such
that low-speedup ops sit below and feature ops above the aggregate.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "OpProfile",
    "OP_PROFILES",
    "PIPELINE_ORDER",
    "FUSED_FEATURE_OPS",
    "fused_feature_profile",
    "NodeConfig",
    "KEENELAND_NODE",
    "TILE_CPU_SECONDS",
    "TRANSFER_IMPACT",
    "IO_SECONDS_PER_TILE",
    "LUSTRE_AGGREGATE_BW_TILES",
    "aggregate_gpu_speedup",
    "validate_calibration",
]


@dataclass(frozen=True)
class OpProfile:
    """Per-operation workload model.

    ``cpu_fraction`` — share of one tile's single-core CPU time.
    ``gpu_speedup``  — computation-only GPU-vs-1-core speedup (Fig 7).
    ``transfer_impact`` — fraction of op execution time spent in
    CPU<->GPU transfers when inputs/outputs are NOT resident.
    """

    name: str
    cpu_fraction: float
    gpu_speedup: float
    transfer_impact: float
    stage: str  # "segmentation" | "features"
    # Micro-batched dispatch: regular, shape-stable ops whose kernels
    # compile once per tile size may be executed as one vmapped call
    # over several ready instances (launch-overhead amortization).
    # Irregular segmentation ops (wave propagation, labelling) are not.
    batchable: bool = False


# Segmentation ops are irregular (wave propagation, labelling) => modest
# speedups; feature ops are regular and compute-dense => high speedups.
OP_PROFILES: dict[str, OpProfile] = {
    p.name: p
    for p in [
        # Thresholding / fixed-structuring-element morphology are
        # shape-stable (compile once per tile size) => batchable; the
        # fixpoint-iteration ops (reconstruction, watershed, labelling,
        # hole filling) have data-dependent trip counts => not.
        OpProfile("rbc_detection",   0.095, 6.70, 0.14, "segmentation", batchable=True),
        OpProfile("morph_open",      0.040, 1.13, 0.12, "segmentation", batchable=True),
        OpProfile("recon_to_nuclei", 0.175, 12.2, 0.10, "segmentation"),
        OpProfile("area_threshold",  0.020, 1.95, 0.15, "segmentation", batchable=True),
        OpProfile("fill_holes",      0.035, 2.60, 0.16, "segmentation"),
        OpProfile("pre_watershed",   0.145, 10.6, 0.11, "segmentation", batchable=True),
        OpProfile("watershed",       0.120, 6.30, 0.13, "segmentation"),
        OpProfile("bwlabel",         0.030, 1.65, 0.15, "segmentation"),
        # Feature stage (§II): color deconvolution feeds feature ops that
        # are mutually independent ("most of the features can be computed
        # concurrently").  Regular + compute-dense => high speedups.
        OpProfile("color_deconv",    0.050, 18.0, 0.08, "features", batchable=True),
        OpProfile("pixel_stats",     0.050, 20.0, 0.08, "features", batchable=True),
        OpProfile("gradient_stats",  0.060, 24.0, 0.08, "features", batchable=True),
        OpProfile("haralick",        0.100, 28.0, 0.08, "features", batchable=True),
        OpProfile("canny_edge",      0.050, 21.0, 0.08, "features", batchable=True),
        OpProfile("morphometry",     0.030, 15.0, 0.10, "features", batchable=True),
    ]
}

#: Fine-grain op order within one tile.  Segmentation (Fig 1) is a
#: chain; the feature ops all depend on color_deconv only.
PIPELINE_ORDER: tuple[str, ...] = (
    "rbc_detection",
    "morph_open",
    "recon_to_nuclei",
    "area_threshold",
    "fill_holes",
    "pre_watershed",
    "watershed",
    "bwlabel",
    "color_deconv",
    "pixel_stats",
    "gradient_stats",
    "haralick",
    "canny_edge",
    "morphometry",
)

#: Feature ops that run concurrently once color_deconv is done.
PARALLEL_FEATURE_OPS: tuple[str, ...] = (
    "pixel_stats",
    "gradient_stats",
    "haralick",
    "canny_edge",
    "morphometry",
)

#: Ops covered by the fused feature megakernel (kernels/feature_fused):
#: one VMEM pass / single HBM read replaces three separate tile reads.
FUSED_FEATURE_OPS: tuple[str, ...] = (
    "color_deconv",
    "pixel_stats",
    "gradient_stats",
)


def fused_feature_profile() -> OpProfile:
    """Derived profile of the fused color_deconv+pixel+gradient op.

    CPU fraction is the sum of the fused ops'; GPU speedup is the
    harmonic composition of theirs; transfer impact halves because the
    tile is read from HBM once instead of three times.
    """
    parts = [OP_PROFILES[n] for n in FUSED_FEATURE_OPS]
    frac = sum(p.cpu_fraction for p in parts)
    speedup = frac / sum(p.cpu_fraction / p.gpu_speedup for p in parts)
    impact = min(p.transfer_impact for p in parts) / 2.0
    return OpProfile("feature_fused", frac, speedup, impact, "features",
                     batchable=True)

#: Single-core CPU seconds to process one 4Kx4K tile end-to-end.
#: Chosen so 3 GPUs + 9 cores under PATS processes ~100 tiles in ~51s
#: (Table II) and one node sustains ~1.95 tiles/s with all
#: optimizations (Fig 14: 150 tiles/s at 100 nodes / 77% efficiency)
#: — see tests/test_calibration.py.
TILE_CPU_SECONDS: float = 16.5

#: Paper §V-D: transfers ≈13% of computation time (aggregate).
TRANSFER_IMPACT: float = 0.13

#: Reading one tile from Lustre, uncontended (end-to-end 1-GPU speedup
#: drops 6.5 -> 5.3 when I/O is included: io ≈ (1/5.3 - 1/6.5) * T_cpu).
IO_SECONDS_PER_TILE: float = TILE_CPU_SECONDS * (1 / 5.3 - 1 / 6.5)

#: Aggregate Lustre read bandwidth expressed in tiles/s; shared by all
#: nodes, produces the 93% -> 77% efficiency drop at 100 nodes (Fig 14).
LUSTRE_AGGREGATE_BW_TILES: float = 170.0


@dataclass(frozen=True)
class NodeConfig:
    """One cluster node (Keeneland: 12 cores, 3 GPUs, Fig 6)."""

    n_cpu_cores: int = 12
    n_gpus: int = 3
    # Sub-linear multi-core scaling: 12 cores => ~9x (memory bandwidth
    # saturation, Fig 9).  Modeled as per-core efficiency when k cores
    # compute concurrently: eff(k) = 1 / (1 + alpha*(k-1)).
    cpu_bw_alpha: float = 0.0303
    # Storage-hierarchy capacity (Keeneland KIDS: 24 GB RAM per node,
    # local scratch disk).  StagingConfig.from_calibration derives
    # host/disk tier budgets from these instead of hand-set constants.
    host_ram_gb: float = 24.0
    scratch_disk_gb: float = 250.0
    # Cluster wiring: nodes per rack / leaf switch.  KIDS packs ~8
    # compute nodes behind each InfiniBand leaf; the simulator's
    # fat-tree network model (SimConfig.network="fat_tree") defaults
    # its rack grouping to this when SimConfig.rack_size is unset.
    rack_size: int = 8

    def cpu_core_efficiency(self, active_cores: int) -> float:
        return 1.0 / (1.0 + self.cpu_bw_alpha * max(active_cores - 1, 0))

    @property
    def n_compute_cores(self) -> int:
        """Cores left for compute when each GPU pins a control thread."""
        return self.n_cpu_cores - self.n_gpus


KEENELAND_NODE = NodeConfig()


def aggregate_gpu_speedup(include_transfer: bool = False) -> float:
    """Whole-pipeline 1-GPU-vs-1-core speedup implied by OP_PROFILES."""
    gpu_time = 0.0
    for p in OP_PROFILES.values():
        t = p.cpu_fraction / p.gpu_speedup
        if include_transfer:
            t /= (1.0 - p.transfer_impact)
        gpu_time += t
    return 1.0 / gpu_time


def validate_calibration() -> dict[str, float]:
    """Quantities the constants must reproduce; asserted in tests."""
    fractions = sum(p.cpu_fraction for p in OP_PROFILES.values())
    s_compute = aggregate_gpu_speedup(include_transfer=False)
    s_with_tx = aggregate_gpu_speedup(include_transfer=True)
    gpu_times = {
        n: p.cpu_fraction / p.gpu_speedup for n, p in OP_PROFILES.items()
    }
    morph_open_share = gpu_times["morph_open"] / sum(gpu_times.values())
    return {
        "cpu_fraction_sum": fractions,          # == 1.0
        "gpu_speedup_compute_only": s_compute,  # ≈ 6.5
        "gpu_speedup_with_transfer": s_with_tx, # ≈ 6.5 * (1-0.13) ≈ 5.7
        "morph_open_gpu_share": morph_open_share,  # ≈ 0.23
        "transfer_impact_aggregate": 1.0 - s_with_tx / s_compute,  # ≈ 0.13
    }
