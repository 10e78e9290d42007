"""Driver of the WSI cells: the port's in-process main path.

``Manager.run`` leases a bag of tiles, ``ConcreteWorkflow.replicate(
build_workflow(fused=...), [DataChunk(i, payload=tile), ...])``, to one
``WorkerRuntime`` with the configuration's lanes (PATS, locality) and
the ``gpu`` variants of ``register_variants(device=...)``. The whole
bag is queued at the start, as the paper's bag of tasks, and is far
longer than any window: the run stops when the window closes.

The configuration's ``lease_order`` is the Manager's order over the
bag. ``tile``: each stage instance carries its tile's place in the bag
as its deadline (``StageInstance.deadline``, not its ops'), so the
Manager's pending queue (its EDF tier) leases a tile's features before
the segmentation of later tiles, and the bag runs tile by tile, in scan
order. ``fifo``: no deadline, the Manager's default, which leases every
segmentation of the bag before the first features stage. The worker
keeps its own order (PATS, locality): its ops carry no deadline.

The window opens in the Manager's completion hook, at the completion of
the warm-up's last tile: the warm-up runs enough tiles that every
memory slot of the lanes is full, and ``WARMUP_EXTRA_TILES`` more, so
the window measures the steady state, with evictions. It closes at the
first tile completion at least ``seconds`` after it opened, so that it
holds whole tiles at both ends and its count of tiles is not cut at an
arbitrary instant (within one tile's time of ``seconds``). The hook runs on the lane's thread between
two ops, so the counters and the memory peak it reads or resets at both
ends belong to the window alone.

The memory peak of a run is ``torch.cuda.max_memory_allocated()`` from
the window's opening until the ``PEAK_TILES``-th tile completed in it
(the whole window's where fewer complete): the port keeps every
finished tile's state on the card, so a peak over the whole window
would grow with the number of tiles the window completes, and a faster
program would read as a larger one.

Times are the harness's own: the lease of a tile's first stage (the
Manager's call into the worker, wrapped here) and the completion of
its last (the hook). With ``trace`` the program's ``Tracer`` records
its spans and ``torch.profiler`` the device over the window.
"""

from __future__ import annotations

import math
import threading
import time

from benchkit.record import Item, Run, Sample
from kinds.wsi_record import WsiRecord
from kinds.wsi_tiles import make_traffic, rng_for

__all__ = ["run"]

#: Seconds the warm-up may take (a checkout's first run builds the
#: kernels inside it), and the close may wait past ``seconds`` for a tile.
WARM_LIMIT_S, CLOSE_LIMIT_S = 900.0, 120.0
#: Tiles the warm-up runs beyond those whose ops fill the memory slots.
WARMUP_EXTRA_TILES = 1
#: Tiles completed in the window over which the memory peak is read.
PEAK_TILES = 20
#: The op whose outputs are the tile's object labels and count.
LABELS_OP = "bwlabel"
FEAT_PREFIX = "feat_"
#: ``lease_order`` -> whether a stage instance's deadline is its tile's index.
LEASE_ORDERS = {"tile": True, "fifo": False}


def _counters(rt) -> dict[str, float]:
    """The worker's busy seconds and evictions."""
    st = rt.stats()
    return {"lane_busy": float(sum(st["lane_busy"].values())),
            "device_evictions": float(st["device_evictions"])}


class _Window:
    """The window's two ends, set from the completion hook."""

    def __init__(self, warm_tiles: int, seconds: float, rt, dev) -> None:
        import torch

        self.warm_tiles, self.seconds = warm_tiles, seconds
        self.rt, self.dev = rt, dev
        self.cuda = torch.cuda if dev.type == "cuda" else None
        self.done = 0
        self.opened, self.closed = threading.Event(), threading.Event()
        self.t_open = self.wall_open = self.t_close = 0.0
        self.at_open: dict = {}
        self.at_close: dict = {}
        self.peak = self.window_peak = 0

    def tile_done(self, now: float) -> None:
        self.done += 1
        if self.done == self.warm_tiles:
            self.t_open, self.wall_open = now, time.time()
            self.at_open = _counters(self.rt)
            if self.cuda is not None:
                self.cuda.reset_peak_memory_stats(self.dev)
            self.opened.set()
        elif self.opened.is_set() and not self.closed.is_set():
            if self.cuda is not None and self.done == self.warm_tiles + PEAK_TILES:
                self.peak = self.cuda.max_memory_allocated(self.dev)
            if now - self.t_open >= self.seconds:
                self.t_close = now
                self.at_close = _counters(self.rt)
                if self.cuda is not None:
                    self.window_peak = self.cuda.max_memory_allocated(self.dev)
                    self.peak = self.peak or self.window_peak
                self.closed.set()


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> tuple[Run, list[Sample]]:
    """One run of ``cell`` on tiles made from ``seed``: returns the
    :class:`Run` and, for a sample of the tiles completed in the window
    (drawn from ``seed``), each tile and its outputs on the host."""
    import torch

    from repro_torch.app import build_workflow, register_variants
    from repro_torch.core import (
        ConcreteWorkflow, DataChunk, LaneSpec, Manager, ManagerConfig, VariantRegistry,
        WorkerRuntime,
    )
    from repro_torch.telemetry.tracing import Tracer, use_context

    cfg = cell.config
    traffic = make_traffic(cell.traffic, seed, int(cfg["tile"]))
    dev = torch.device(device)
    workflow = build_workflow(**cfg["workflow"])
    stage_names = workflow.stage_order()
    stage_ops = {s: [op.name for op in workflow.stage(s).ops] for s in stage_names}
    first, last = stage_names[0], stage_names[-1]
    worker = cfg["worker"]
    slots = int(worker["memory_slots"])
    ops_per_tile = sum(len(v) for v in stage_ops.values())
    warm_tiles = math.ceil(slots / ops_per_tile) + WARMUP_EXTRA_TILES

    reg = register_variants(VariantRegistry(), device=dev)
    cw = ConcreteWorkflow.replicate(
        workflow, [DataChunk(i, payload=traffic.tile(i)) for i in range(traffic.bag_tiles)])
    if LEASE_ORDERS[cfg["lease_order"]]:
        for si in cw.stage_instances.values():
            si.deadline = float(si.chunk.chunk_id)
    uid_of = {(si.chunk.chunk_id, si.stage.name): si.uid for si in cw.stage_instances.values()}
    stage_of = {si.uid: (si.chunk.chunk_id, si.stage.name) for si in cw.stage_instances.values()}
    tracer = Tracer("bench", sample_rate=1.0, capacity=1 << 20, seed=seed % 2**32) if trace else None
    rt = WorkerRuntime(0, lanes=tuple(LaneSpec(k, i, slots) for i, k in enumerate(worker["lanes"])),
                       policy=worker["policy"], locality=bool(worker["locality"]),
                       variant_registry=reg, tracer=tracer)
    mgr = Manager(cw, ManagerConfig(**cfg["manager"]), tracer=tracer)
    mgr.register_worker(rt)

    tiles = {i: Item(i) for i in range(traffic.bag_tiles)}
    window = _Window(warm_tiles, seconds, rt, dev)
    submit = rt.submit_stage

    def leased(si):
        chunk, stage = stage_of[si.uid]
        if stage == first and tiles[chunk].start is None:
            tiles[chunk].start = time.perf_counter()
        return submit(si)

    def completed(uid: int) -> None:
        chunk, stage = stage_of[uid]
        if stage == last:
            tiles[chunk].done = time.perf_counter()
            window.tile_done(tiles[chunk].done)

    rt.submit_stage = leased
    mgr.completion_hook = completed
    profiler = None
    if trace and dev.type == "cuda":
        from benchkit.trace import Profiler

        first_session = Profiler()  # pays the profiler's own set-up
        first_session.start()
        torch.ones(1, device=dev).add_(1)
        first_session.stop()
        profiler = Profiler()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    root = tracer.start_trace() if tracer is not None else None
    rt.start()
    device_trace = None
    try:
        with use_context(root):
            mgr.run(timeout=0.0)  # leases the bag; the lane starts on it
        if not window.opened.wait(timeout=WARM_LIMIT_S):
            raise RuntimeError(f"warm-up: {window.done} of {warm_tiles} tiles in "
                               f"{WARM_LIMIT_S} s; errors {rt.errors[:3]}")
        if profiler is not None:
            profiler.start()
        with use_context(root):
            finished = mgr.run(timeout=max(window.t_open + seconds - time.perf_counter(), 0.0))
        if finished or not window.closed.wait(timeout=CLOSE_LIMIT_S):
            raise RuntimeError(f"the window did not close: {window.done} tiles done of the "
                               f"bag's {traffic.bag_tiles}; errors {rt.errors[:3]}")
        if profiler is not None:
            device_trace = profiler.stop()
    finally:
        rt.stop()
    record = Run(
        t_open=window.t_open, t_close=window.t_close, wall_open=window.wall_open,
        setup_s=window.t_open - t_start, items=tiles,
        counters_open=window.at_open, counters_close=window.at_close,
        peak_bytes=int(window.peak), window_peak_bytes=int(window.window_peak),
        spans=tracer.spans() if tracer is not None else [], device=device_trace,
        errors=[f"op {uid}: {type(exc).__name__}: {exc}" for uid, exc in rt.errors],
        own=WsiRecord(tile_shape=(int(cfg["tile"]), int(cfg["tile"])), stage_ops=stage_ops,
                      op_chunks={oi.uid: oi.chunk.chunk_id
                                 for oi in cw.op_instances.values()} if trace else {}))
    return record, _samples(mgr, uid_of, record, traffic, cell, seed, first, last)


def _samples(mgr, uid_of, record: Run, traffic, cell, seed: int, first: str,
             last: str) -> list[Sample]:
    """A seeded sample of the tiles completed in the window: each tile,
    and its outputs on the host: the labels and object count of the
    first stage's ``LABELS_OP``, and every ``feat_*`` of the last stage."""
    from repro_torch.app._device import to_host

    done = sorted(t.key for t in record.done())
    k = min(int(cell.limits["check_tiles"]), len(done))
    picks = sorted(int(c) for c in rng_for(seed, 3).choice(done, size=k, replace=False)) if k else []
    out = []
    for chunk in picks:
        seg = mgr.stage_outputs(uid_of[(chunk, first)])
        feats = mgr.stage_outputs(uid_of[(chunk, last)])
        labelled = seg[LABELS_OP]
        got = {"objects": to_host(labelled["objects"]), "n_objects": int(labelled["n_objects"])}
        for st in feats.values():
            got.update({key: to_host(v) for key, v in st.items() if key.startswith(FEAT_PREFIX)})
        out.append(Sample(chunk, traffic.tile(chunk), got))
    return out
