"""Dry run: build and run one step of every (arch x shape) cell on the
production meshes, with no card and no memory (the counterpart of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for 256 or 512 TPU chips.
PyTorch compiles no whole-program graph, so the port runs the step
itself: as rank 0 of a ``torch.distributed`` ``"fake"`` process group
of 256 (16x16) or 512 (2x16x16) ranks, on the ``meta`` device. The
model is built on ``meta`` without drawing weights, laid out on the
mesh by ``launch/sharding.py`` (``spmd.distribute``), and one step runs
on this rank's chunks: train (``make_train_step`` with AdamW, or
AdamW8bit under ``--opt8bit``), prefill (``make_prefill_step``), or
decode and long-decode (``init_caches`` and one ``make_serve_step``;
``long_500k`` is batch 1 on 16 or 32 data ranks, the caches' sequence
split over them). Nothing is allocated; a collective (``mesh.Comm``)
only counts its bytes, and the kernels' entries give empty outputs of
their shapes (``kernels/ops.py``).

Each cell's record has the reference's keys where the port has a
counterpart:

* ``build_s`` and ``step_s`` (host seconds; in place of the reference's
  lower and compile seconds);
* ``argument_size_in_bytes``: this rank's chunks of the parameters, the
  optimizer state, the caches and the inputs (``param_bytes``: of the
  parameters alone);
* ``peak_live_bytes``: the most bytes of storage live on rank 0 during
  the step (a ``TorchDispatchMode`` counts each storage that an
  operation makes once, from its making to its freeing), with the
  arguments; ``temp_size_in_bytes`` without them; ``fits_hbm`` whether
  it stays under one H100's 80 GB;
* ``coll_by_kind`` / ``coll_bytes_per_device``: ``Comm.bytes`` on rank 0
  over the step, the port's own collectives (explicit tensor
  parallelism, the per-layer FSDP gathers and their reduce-scatters).
  The reference parses GSPMD's collectives out of the optimized HLO
  (``collective_bytes``); there is no HLO here to parse (ROADMAP.md,
  intended differences);
* the analytic FLOPs and bytes of ``launch/costs.cell_cost``;
* the roofline terms on ``launch/costs_h100.H100_SXM`` (989e12 FLOP/s,
  3.35e12 B/s, ``link_bw`` 450e9 B/s), ``dominant`` and
  ``useful_ratio`` as the reference computes them. The link term uses
  NVLink's rate, so beyond one 8-card node it is a lower bound;
* ``fsdp``: the port always runs its per-layer gather schedule
  (``"gather"``); ``fsdp_requested`` keeps what ``--fsdp`` asked.

These are host-side counts on ``meta`` tensors, not device times.

Usage (CPU only; results in ``build/dryrun/torch_dryrun_results.json``)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep [--multi-pod]
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
import weakref
from collections import Counter
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, SHAPES, get_config, valid_cells
from ..models import transformer as T
from ..models.attention import attention_options
from ..models.layers import COMPUTE_DTYPE, stored
from ..models.model import Model
from ..models.plan import make_plan
from ..optim import AdamW, AdamW8bit
from ..train import TrainState, make_prefill_step, make_serve_step, make_train_step
from .costs import cell_cost
from .costs_h100 import H100_SXM
from .mesh import axes_for, make_mesh
from .sharding import input_structs
from .spmd import distribute

__all__ = ["build_cell", "run_cell", "main", "LiveBytes", "RESULTS"]

RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"

HBM_BYTES = 80e9  # one H100 SXM


# --------------------------------------------------------------------------
# Live storage
# --------------------------------------------------------------------------


class LiveBytes(TorchDispatchMode):
    """The bytes of storage that operations make while the mode is on:
    each storage counted once, from the first tensor an operation returns
    on it to the freeing of the last tensor that views it. Storage that
    an operation's output shares with one of its inputs (a view, an
    in-place update) is not new. ``peak`` is the most at any time."""

    def __init__(self):
        super().__init__()
        self.live: dict[int, list] = {}  # storage key -> [bytes, tensors alive]
        self.now = self.peak = 0

    def _drop(self, key: int) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.now -= entry[0]
            del self.live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage()._cdata
                  for t in torch.utils._pytree.tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in torch.utils._pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            key = t.untyped_storage()._cdata
            if key in self.live:
                self.live[key][1] += 1
            elif key in inputs:
                continue
            else:
                self.live[key] = [t.untyped_storage().nbytes(), 1]
                self.now += self.live[key][0]
                self.peak = max(self.peak, self.now)
            weakref.finalize(t, self._drop, key)
        return out


def _tree_bytes(tree) -> int:
    """Bytes of the distinct storages of every tensor in ``tree``."""
    seen: dict[int, int] = {}
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            seen[t.untyped_storage()._cdata] = t.untyped_storage().nbytes()
    return sum(seen.values())


# --------------------------------------------------------------------------
# Cells
# --------------------------------------------------------------------------


def fake_world(size: int) -> None:
    """This process as rank 0 of a ``"fake"`` process group of ``size``
    ranks (the group is made here, in the dry run's own process)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def production_mesh(multi_pod: bool):
    """The reference's production mesh over a fake group, rank 0's view."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    fake_world(math.prod(shape))
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, "cpu")


def _meta_model(cfg, mesh, trainable: bool) -> Model:
    """The model on ``meta`` (no weights drawn), this rank's chunks kept."""
    ax = axes_for(mesh)
    plan = make_plan(cfg, tp=ax.model_size(mesh), dp_axes=ax.data, tp_axis=ax.model)
    tree = T.init_model_params(None, cfg, plan, "meta",
                               store=lambda name, t: stored(name, t, trainable))
    model = Model(cfg, plan, tree, trainable, COMPUTE_DTYPE if trainable else None)
    return distribute(model, mesh)


def _rows(t: torch.Tensor, sp, rows_split: bool) -> torch.Tensor:
    """This rank's rows of a global input (all of them where the data
    axes do not divide the batch), in storage of their own."""
    return sp.data.chunk(t, 0).clone() if rows_split else t


def build_cell(arch: str, shape_name: str, mesh, opt8bit: bool = False):
    """-> (step, its arguments, the model, what this rank holds of the
    arguments): the step of the cell's kind on this rank's chunks. The
    train and prefill steps take the global batch and keep their rows;
    the decode step takes the rank's rows."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ax = axes_for(mesh)
    inputs, _ = input_structs(cfg, shape, ax, mesh)
    model = _meta_model(cfg, mesh, trainable=shape.kind == "train")
    sp = model.spmd
    split = sp.serve_layout(shape.global_batch, shape.seq_len).rows_split
    if shape.kind == "train":  # the global batch in; the step keeps its rows
        opt = AdamW8bit(lr=3e-4) if opt8bit else AdamW(lr=3e-4)
        params = dict(model.named_parameters())
        state = TrainState(params, opt.init(params))
        rows = {k: _rows(v, sp, True) for k, v in inputs.items()}
        return make_train_step(model, opt), (state, inputs), model, (state, rows)
    if shape.kind == "prefill":
        rows = {k: _rows(v, sp, split) for k, v in inputs.items()}
        return make_prefill_step(model, max_len=shape.seq_len), (inputs,), model, (rows,)
    layout = sp.serve_layout(shape.global_batch, shape.seq_len)
    caches = model.init_caches(shape.global_batch, shape.seq_len)
    args = (caches, _rows(inputs["tokens"], sp, split), _rows(inputs["lengths"], sp, split))
    return make_serve_step(model, layout), args, model, args


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, fsdp: str = "naive",
             causal_skip: bool = False, kv_quant: bool = False,
             opt8bit: bool = False) -> dict:
    mesh = production_mesh(multi_pod)
    n_chips = mesh.size
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape.values()),
        "chips": n_chips,
        "fsdp": "gather",
        "fsdp_requested": fsdp,
        "causal_skip": causal_skip,
        "kv_quant": kv_quant,
        "opt8bit": opt8bit,
    }
    counts: Counter = mesh.comm(mesh.axis_names).bytes
    t0 = time.perf_counter()
    with torch.device("meta"), attention_options(causal_skip=causal_skip, kv_quant=kv_quant):
        step, args, model, held = build_cell(arch, shape_name, mesh, opt8bit=opt8bit)
        t_build = time.perf_counter() - t0
        param_bytes = _tree_bytes(dict(model.named_parameters()))
        arg_bytes = _tree_bytes((held, dict(model.named_parameters())))
        counts.clear()
        live = LiveBytes()
        with live:
            out = step(*args)
        del out
        t_step = time.perf_counter() - t0 - t_build
    coll = {k: int(v) for k, v in counts.items()}
    coll_total = sum(coll.values())
    cm = cell_cost(cfg, shape, tp=mesh.shape["model"], causal_skip=causal_skip,
                   kv_quant=kv_quant)
    plan = model.plan
    rec.update(
        arch_name=cfg.name,
        build_s=round(t_build, 2),
        step_s=round(t_step, 2),
        flops_global=cm.flops,
        bytes_global=cm.bytes,
        flops_by=cm.flops_by,
        bytes_by=cm.bytes_by,
        coll_bytes_per_device=coll_total,
        coll_by_kind=coll,
        compute_term_s=cm.flops / (n_chips * H100_SXM.peak_flops),
        memory_term_s=cm.bytes / (n_chips * H100_SXM.mem_bw),
        collective_term_s=(coll_total * n_chips) / (n_chips * H100_SXM.link_bw),
        q_waste=plan.attention.q_waste if plan.attention else 0.0,
        kv_overhead=plan.attention.kv_overhead if plan.attention else 1.0,
        param_bytes=int(param_bytes),
        argument_size_in_bytes=int(arg_bytes),
        temp_size_in_bytes=int(live.peak),
        peak_live_bytes=int(arg_bytes + live.peak),
        fits_hbm=bool(arg_bytes + live.peak < HBM_BYTES),
    )
    rec["dominant"] = max(("compute", "memory", "collective"), key=lambda k: rec[f"{k}_term_s"])
    if shape.kind == "train":
        model_flops = 6 * cfg.active_params() * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2 * cfg.active_params() * shape.global_batch * shape.seq_len
    else:
        model_flops = 2 * cfg.active_params() * shape.global_batch
    rec["model_flops"] = float(model_flops)
    rec["useful_ratio"] = float(model_flops / cm.flops) if cm.flops else 0.0
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--fsdp", default="naive", choices=["naive", "gather"])
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--opt8bit", action="store_true")
    ap.add_argument("--out", default=str(RESULTS / "torch_dryrun_results.json"))
    args = ap.parse_args(argv)

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results: list[dict] = json.loads(out_path.read_text()) if out_path.exists() else []

    def done(a, s, mp):
        mesh = "2x16x16" if mp else "16x16"
        return any(r["arch"] == a and r["shape"] == s and r["mesh"] == mesh
                   and "error" not in r for r in results)

    if args.sweep:  # both meshes, as the reference's sweep
        cells = [(a, s, mp) for a in ARCH_IDS for s in valid_cells(a) for mp in (False, True)
                 if not done(a, s, mp)]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --sweep")
        cells = [(args.arch, args.shape, args.multi_pod)]

    if args.fsdp == "naive":
        print("note: the port always runs its per-layer FSDP gather schedule "
              "(recorded as fsdp='gather', fsdp_requested='naive')", flush=True)
    for a, s, mp in cells:
        label = f"{a} x {s} x {'2x16x16' if mp else '16x16'}"
        print(f"=== {label}", flush=True)
        try:
            rec = run_cell(a, s, multi_pod=mp, fsdp=args.fsdp, causal_skip=args.causal_skip,
                           kv_quant=args.kv_quant, opt8bit=args.opt8bit)
            print(f"    ok  build={rec['build_s']}s step={rec['step_s']}s "
                  f"flops={rec['flops_global']:.3e} "
                  f"coll/dev={rec['coll_bytes_per_device']:.3e} "
                  f"peak/dev={rec['peak_live_bytes']:.3e} fits={rec['fits_hbm']} "
                  f"terms(c/m/coll)={rec['compute_term_s']:.3f}/{rec['memory_term_s']:.3f}/"
                  f"{rec['collective_term_s']:.3f}s dominant={rec['dominant']} "
                  f"useful={rec['useful_ratio']:.2f}", flush=True)
        except Exception as e:  # noqa: BLE001
            rec = {"arch": a, "shape": s, "mesh": "2x16x16" if mp else "16x16",
                   "error": f"{type(e).__name__}: {e}"}
            print(f"    FAIL {rec['error'][:300]}", flush=True)
            traceback.print_exc()
        results = [r for r in results
                   if not (r["arch"] == a and r["shape"] == s and r["mesh"] == rec["mesh"])]
        results.append(rec)
        out_path.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
