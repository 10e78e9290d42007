"""The hierarchical WSI analysis workflow + variant registration.

Builds the two-level abstract workflow of paper Fig 1/2 over the real
operation implementations and registers the CPU/accelerator function
variants with their calibrated PATS speedup estimates.

The accelerator (``gpu``) variants run on one torch device, the card by
default. Their ``color_deconv``, ``recon_to_nuclei`` and
``feature_fused`` reach the hand-written kernels through
:mod:`repro_torch.kernels.ops` (as the JAX package's ``tpu`` variants
reach its Pallas kernels), and so do the other reconstructions
(``fill_holes``, ``pre_watershed``, ``canny_edge``).

Host/device boundary
--------------------
* A ``gpu`` variant moves the numpy inputs it reads to its device
  (the chunk payload on the first op); the tile then stays there as
  ``state["rgb"]``.
* A ``cpu`` variant downloads tensor inputs with ``.cpu().numpy()``.
* ``feat_*`` outputs and ``n_objects`` leave the device at the end of
  the op that makes them, so ``Manager.stage_outputs`` gives host
  results.
* A tile's result is :data:`RESULT`: ``bwlabel``'s ``objects`` and
  ``n_objects`` and every ``feat_*``, named on the workflow's ops
  (``Operation.outputs``). A ``gpu`` op copies its result tensors to the
  host inside the read that ends it (``core.release.HostCopies``: the
  one download of ``objects`` a tile). Once every stage of a tile has
  completed, the Manager keeps only the result and the worker drops
  every other plane of the tile (``core/release.py``).
* A ``gpu`` variant synchronises its device before it returns: the
  Worker times each call on the host clock (``lane.busy_seconds``, the
  PATS runtime estimate), which would otherwise see only the enqueue.
* Every blocking read of the device by the host goes through
  ``_device.host_sync``, a ``sync`` span where the op is traced; a
  traced ``gpu`` op on the card also notes the caching allocator's
  counts across it (``_device.alloc_counts``).

Spawned workers
---------------
A worker process (``transport.spawn_worker``) rebuilds its registry from
a ``"module:attr"`` path to a zero-argument factory:
``repro_torch.app.pipeline:wsi_registry_cuda`` (the card) or
``:wsi_registry_cpu`` (the ``gpu`` variants on the CPU). Kernel launch
counts live in the process that launches; with ``$REPRO_TORCH_LAUNCH_LOG``
naming a directory, a worker built by either factory writes its counts
there as ``launches-<pid>.json`` when it exits.

Fused-variant substitution rule: ``build_workflow(fused=True)``
replaces ``color_deconv -> {pixel_stats, gradient_stats}`` by the single
``feature_fused`` op (one read of the tile instead of three); see the
JAX package's ``app/pipeline.py`` for when that pays.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from concurrent.futures import Future
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core.calibration import (
    FUSED_FEATURE_OPS,
    OP_PROFILES,
    PARALLEL_FEATURE_OPS,
    fused_feature_profile,
)
from ..core.release import HostCopies
from ..core.variants import VariantRegistry, registry as global_registry
from ..core.workflow import AbstractWorkflow, Operation, Stage
from ..core.worker import OpContext
from ..telemetry.lanes import current_op
from ..kernels import ops as K
from . import features as F
from . import segmentation as S
from ._device import alloc_counts, host_sync, resolve_device, to_device, to_host

__all__ = [
    "build_workflow", "register_variants", "run_tile", "OP_IMPLS", "RESULT",
    "wsi_registry_cuda", "wsi_registry_cpu", "LAUNCH_LOG_ENV",
]

#: op name -> (cpu impl, accel impl) over the pipeline state dict; the
#: accel impls take ``device=`` (default: the card).
OP_IMPLS: dict[str, tuple[Any, Any]] = {
    "rbc_detection": (S.rbc_detection_cpu, S.rbc_detection_accel),
    "morph_open": (S.morph_open_cpu, S.morph_open_accel),
    "recon_to_nuclei": (S.recon_to_nuclei_cpu, S.recon_to_nuclei_accel),
    "area_threshold": (S.area_threshold_cpu, S.area_threshold_accel),
    "fill_holes": (S.fill_holes_cpu, S.fill_holes_accel),
    "pre_watershed": (S.pre_watershed_cpu, S.pre_watershed_accel),
    "watershed": (S.watershed_cpu, S.watershed_accel),
    "bwlabel": (S.bwlabel_cpu, S.bwlabel_accel),
    "color_deconv": (F.color_deconv_cpu, F.color_deconv_accel),
    "pixel_stats": (F.pixel_stats_cpu, F.pixel_stats_accel),
    "gradient_stats": (F.gradient_stats_cpu, F.gradient_stats_accel),
    "haralick": (F.haralick_cpu, F.haralick_accel),
    "canny_edge": (F.canny_edge_cpu, F.canny_edge_accel),
    "morphometry": (F.morphometry_cpu, F.morphometry_accel),
}

_SEG_ORDER = (
    "rbc_detection",
    "morph_open",
    "recon_to_nuclei",
    "area_threshold",
    "fill_holes",
    "pre_watershed",
    "watershed",
    "bwlabel",
)


#: A tile's result, by the op whose output state holds it: what the
#: tile keeps once all its stages completed (``core/release.py``). The
#: workflow's ops carry it as their ``outputs``.
RESULT: dict[str, tuple[str, ...]] = {
    "bwlabel": ("objects", "n_objects"),
    "pixel_stats": ("feat_pixel",),
    "gradient_stats": ("feat_gradient",),
    "feature_fused": ("feat_pixel", "feat_gradient"),
    "haralick": ("feat_haralick",),
    "canny_edge": ("feat_canny",),
    "morphometry": ("feat_morph",),
}


def _op(name: str) -> Operation:
    return Operation(name, outputs=RESULT.get(name, ()))


def build_workflow(fused: bool = False) -> AbstractWorkflow:
    """The two-level workflow; ``fused=True`` applies the fused-variant
    substitution rule (see module docstring)."""
    seg_ops = [_op(n) for n in _SEG_ORDER]
    if fused:
        rest = tuple(
            n for n in PARALLEL_FEATURE_OPS if n not in FUSED_FEATURE_OPS
        )
        feat_ops = [_op("feature_fused")] + [_op(n) for n in rest]
        feat_edges = tuple(("feature_fused", n) for n in rest)
    else:
        feat_ops = [_op("color_deconv")] + [
            _op(n) for n in PARALLEL_FEATURE_OPS
        ]
        feat_edges = tuple(("color_deconv", n) for n in PARALLEL_FEATURE_OPS)
    return AbstractWorkflow.chain(
        "wsi-analysis",
        [
            Stage.chain("segmentation", seg_ops),
            Stage("features", tuple(feat_ops), feat_edges),
        ],
    )


def _to_host(state: Any) -> Any:
    """Download device-produced state for a host-core consumer (the
    reference's ``np.asarray`` raises on a CUDA tensor)."""
    if not isinstance(state, dict):
        return state
    return {k: to_host(v) for k, v in state.items()}


def _wrap(fn, to_host: bool = False, device: torch.device | None = None,
          result: tuple[str, ...] = ()):
    """Adapt a state-dict function to the OpContext calling convention.

    The first op receives the raw tile (chunk payload); downstream ops
    receive the upstream op's state dict (merged when several inputs
    arrive). ``to_host=True`` (CPU implementations) downloads tensor
    inputs; with a ``device`` (accelerator implementations) the call
    gets ``device=`` and the device is synchronised before returning,
    in the same blocking read that copies the ``result`` tensors of a
    card's output to the host.
    """
    kw = {} if device is None else {"device": device}
    cuda = device is not None and device.type == "cuda"

    def impl(ctx: OpContext):
        if not ctx.inputs:
            arg = ctx.chunk.payload
        elif len(ctx.inputs) == 1:
            arg = next(iter(ctx.inputs.values()))
        else:
            arg = {}
            for v in ctx.inputs.values():
                arg.update(v)
        op = current_op() if cuda else None
        before = alloc_counts(device) if op is not None else None
        out = fn(_to_host(arg) if to_host else arg, **kw)
        if cuda:
            host = host_sync("op_end", _end_op, device, out, result)
            if host:
                out = HostCopies(out, host)
        if before is not None:
            op.note(**{k: n - before[k] for k, n in alloc_counts(device).items()})
        return out

    return impl


def _end_op(device: torch.device, out: Any, result: tuple[str, ...]) -> dict:
    """Wait for the op's work on ``device`` and for the ``result``
    tensors of its output state to reach page-locked staging (the
    caching host allocator's, reused tile after tile); return their host
    copies, each a Future of the array a thread of its own writes.

    On an H100's host a 4096x4096 int32 plane takes 28-30 ms from the
    card into fresh pageable memory, mostly the first touch of its pages,
    and 1.4-1.6 ms into page-locked memory: the lane waits for the
    latter alone."""
    staged = {}
    if isinstance(out, dict):
        for k in result:
            v = out.get(k)
            if isinstance(v, torch.Tensor):
                staged[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                staged[k].copy_(v, non_blocking=True)
    torch.cuda.synchronize(device)
    return {k: _in_thread(lambda t=v: t.numpy().copy()) for k, v in staged.items()}


def _in_thread(fn) -> Future:
    """``fn()`` on a thread of its own, as a Future."""
    done: Future = Future()

    def run() -> None:
        try:
            done.set_result(fn())
        except BaseException as exc:  # noqa: BLE001 - handed to the reader
            done.set_exception(exc)

    threading.Thread(target=run, name="host-copy").start()
    return done


def _feature_fused_cpu(state: dict) -> dict:
    return F.gradient_stats_cpu(F.pixel_stats_cpu(F.color_deconv_cpu(state)))


def _feature_fused_accel(state: dict, device="cuda") -> dict:
    """One read of the tile through the ``feature_fused`` kernel: stain
    planes + Sobel |grad| of the luminance, then the per-object
    reductions of hema and |grad|."""
    dev = resolve_device(device)
    rgb = to_device(state["rgb"], dev)
    objects = to_device(state["objects"], dev)
    hema, eosin, mag, _ = K.feature_fused(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    return {
        **state,
        "hema": hema,
        "eosin": eosin,
        "feat_pixel": to_host(F._obj_stats_t(hema, objects)),
        "feat_gradient": to_host(F._obj_stats_t(mag, objects)),
    }


def register_variants(
    reg: VariantRegistry | None = None, accel_kind: str = "gpu",
    device: Any = "cuda",
) -> VariantRegistry:
    """Register the cpu and ``accel_kind`` variants of every op (and of
    ``feature_fused``); the accelerator variants run on ``device``,
    which must exist (``device="cuda"`` without a card raises)."""
    dev = resolve_device(device)
    reg = reg or global_registry
    for name, (cpu_fn, accel_fn) in OP_IMPLS.items():
        p = OP_PROFILES[name]
        reg.register(name, "cpu", _wrap(cpu_fn, to_host=True), speedup=1.0)
        reg.register(
            name,
            accel_kind,
            _wrap(accel_fn, device=dev, result=RESULT.get(name, ())),
            speedup=p.gpu_speedup,
            transfer_impact=p.transfer_impact,
            batchable=p.batchable,
        )
    fp = fused_feature_profile()
    reg.register("feature_fused", "cpu",
                 _wrap(_feature_fused_cpu, to_host=True), speedup=1.0)
    reg.register(
        "feature_fused",
        accel_kind,
        _wrap(_feature_fused_accel, device=dev, result=RESULT["feature_fused"]),
        speedup=fp.gpu_speedup,
        transfer_impact=fp.transfer_impact,
        batchable=fp.batchable,
    )
    return reg


#: Environment variable naming the directory where a worker process
#: built by a registry factory below writes its kernel launch counts.
LAUNCH_LOG_ENV = "REPRO_TORCH_LAUNCH_LOG"


def _log_launches_at_exit() -> None:
    out = os.environ.get(LAUNCH_LOG_ENV)
    if not out:
        return
    path = Path(out) / f"launches-{os.getpid()}.json"
    K.reset_launch_counts()
    atexit.register(lambda: path.write_text(json.dumps(K.launch_counts())))


def wsi_registry_cuda() -> VariantRegistry:
    """Zero-argument registry factory for a spawned worker: the WSI
    variants, ``gpu`` on the card (raises without one)."""
    reg = register_variants(VariantRegistry(), device="cuda")
    _log_launches_at_exit()
    return reg


def wsi_registry_cpu() -> VariantRegistry:
    """As :func:`wsi_registry_cuda`, with the ``gpu`` variants on the
    CPU (the kernels' plain versions): the spawned-worker tests."""
    reg = register_variants(VariantRegistry(), device="cpu")
    _log_launches_at_exit()
    return reg


def run_tile(tile: np.ndarray, variant: str = "cpu", device: Any = "cuda") -> dict:
    """Reference single-threaded execution of the full pipeline: numpy
    for ``variant="cpu"``, else the accel ops on ``device``."""
    state: Any = tile
    names = _SEG_ORDER + ("color_deconv",) + tuple(PARALLEL_FEATURE_OPS)
    if variant == "cpu":
        for name in names:
            state = OP_IMPLS[name][0](state)
        return state
    dev = resolve_device(device)
    for name in names:
        state = OP_IMPLS[name][1](state, device=dev)
    return state
