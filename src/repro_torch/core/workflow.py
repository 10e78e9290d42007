"""Hierarchical workflow representation (paper §III-A).

An analysis application is described twice:

* an :class:`AbstractWorkflow` — the *logical* pipeline: a DAG of
  :class:`Stage` nodes, where each stage is itself a DAG of fine-grain
  :class:`Operation` nodes (the paper presents two levels; nesting is
  arbitrary here because a Stage may embed another AbstractWorkflow);
* a :class:`ConcreteWorkflow` — the abstract workflow *instantiated*
  against data chunks: ``(data chunk, stage)`` stage instances and
  ``(data chunk, operation)`` operation instances with explicit
  dependency edges exported to the runtime.

Two instantiation modes mirror Fig. 3 of the paper:

* ``replicate`` — the full pipeline is replicated per data chunk
  (bag-of-tasks over chunks, dataflow within a chunk);
* ``stage_parallel`` — individual stages are instantiated a different
  number of times and fan in/out across chunks (e.g. two copies of an
  expensive stage A feeding a single reducer stage B).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Optional, Sequence

__all__ = [
    "Operation",
    "Stage",
    "AbstractWorkflow",
    "StageInstance",
    "OperationInstance",
    "ConcreteWorkflow",
    "DataChunk",
]


# --------------------------------------------------------------------------
# Abstract (logical) representation
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Operation:
    """A fine-grain operation: the unit scheduled onto a compute lane.

    ``variant`` names an entry in the function-variant registry; the
    runtime resolves it to a device-specific implementation at dispatch
    time (paper §III-A "function variants").
    """

    name: str
    variant: str | None = None  # defaults to ``name``
    # Inputs consumed / outputs produced, by key.  Used by the
    # data-locality scheduler to reason about residency.
    inputs: tuple[str, ...] = ()
    outputs: tuple[str, ...] = ()

    @property
    def variant_name(self) -> str:
        return self.variant or self.name


@dataclass(frozen=True)
class Stage:
    """A coarse-grain stage: a DAG of operations (or a single op).

    ``ops`` maps op name -> Operation; ``edges`` are (src, dst) pairs
    within the stage.  A stage with one op and no edges is the
    degenerate "single step pipeline" of the paper.
    """

    name: str
    ops: tuple[Operation, ...]
    edges: tuple[tuple[str, str], ...] = ()

    def __post_init__(self) -> None:
        names = [op.name for op in self.ops]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate op names in stage {self.name!r}")
        known = set(names)
        for src, dst in self.edges:
            if src not in known or dst not in known:
                raise ValueError(
                    f"edge ({src!r}, {dst!r}) references unknown op in "
                    f"stage {self.name!r}"
                )
        _check_acyclic(names, self.edges, f"stage {self.name!r}")

    @staticmethod
    def single(op: Operation) -> "Stage":
        return Stage(name=op.name, ops=(op,))

    @staticmethod
    def chain(name: str, ops: Sequence[Operation]) -> "Stage":
        edges = tuple(
            (a.name, b.name) for a, b in zip(ops[:-1], ops[1:])
        )
        return Stage(name=name, ops=tuple(ops), edges=edges)

    def op(self, name: str) -> Operation:
        for op in self.ops:
            if op.name == name:
                return op
        raise KeyError(name)

    def sources(self) -> list[str]:
        has_in = {dst for _, dst in self.edges}
        return [op.name for op in self.ops if op.name not in has_in]

    def sinks(self) -> list[str]:
        has_out = {src for src, _ in self.edges}
        return [op.name for op in self.ops if op.name not in has_out]


@dataclass(frozen=True)
class AbstractWorkflow:
    """Logical application: DAG of stages."""

    name: str
    stages: tuple[Stage, ...]
    edges: tuple[tuple[str, str], ...] = ()

    def __post_init__(self) -> None:
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names in workflow {self.name!r}")
        known = set(names)
        for src, dst in self.edges:
            if src not in known or dst not in known:
                raise ValueError(
                    f"edge ({src!r}, {dst!r}) references unknown stage"
                )
        _check_acyclic(names, self.edges, f"workflow {self.name!r}")

    @staticmethod
    def chain(name: str, stages: Sequence[Stage]) -> "AbstractWorkflow":
        edges = tuple(
            (a.name, b.name) for a, b in zip(stages[:-1], stages[1:])
        )
        return AbstractWorkflow(name=name, stages=tuple(stages), edges=edges)

    def stage(self, name: str) -> Stage:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(name)

    def stage_order(self) -> list[str]:
        return _topo_sort([s.name for s in self.stages], self.edges)

    def all_ops(self) -> list[Operation]:
        return [op for s in self.stages for op in s.ops]


def _check_acyclic(
    nodes: Sequence[str], edges: Iterable[tuple[str, str]], what: str
) -> None:
    _topo_sort(nodes, edges, what=what)


def _topo_sort(
    nodes: Sequence[str],
    edges: Iterable[tuple[str, str]],
    what: str = "graph",
) -> list[str]:
    edges = list(edges)
    indeg = {n: 0 for n in nodes}
    out: dict[str, list[str]] = {n: [] for n in nodes}
    for src, dst in edges:
        indeg[dst] += 1
        out[src].append(dst)
    ready = [n for n in nodes if indeg[n] == 0]
    order: list[str] = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        for m in out[n]:
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(m)
    if len(order) != len(list(nodes)):
        raise ValueError(f"{what} contains a cycle")
    return order


# --------------------------------------------------------------------------
# Concrete (instantiated) representation
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class DataChunk:
    """Application-specific portion of the dataset (paper §I).

    ``payload`` may be the data itself, a lazy loader callable, or a
    descriptor understood by the application's operations.  ``meta``
    carries per-chunk attributes the cost model may use (e.g. estimated
    foreground fraction of an image tile).
    """

    chunk_id: int
    payload: Any = None
    meta: Mapping[str, Any] = field(default_factory=dict)

    def __hash__(self) -> int:  # payload may be unhashable
        return hash(self.chunk_id)


@dataclass
class OperationInstance:
    """(data chunk, operation) tuple — the WRM scheduling unit."""

    uid: int
    chunk: DataChunk
    op: Operation
    stage_instance: "StageInstance"
    deps: set[int] = field(default_factory=set)  # uids of upstream op instances
    dependents: set[int] = field(default_factory=set)
    # dep uid -> producing op name, recorded at wiring time (both edge
    # endpoints are known there).  A worker leasing only the consumer
    # stage can then name cross-stage inputs correctly — it may never
    # see the producing stage instance at all when the region arrives
    # through the data plane (direct pull / predictive push).
    dep_names: dict[int, str] = field(default_factory=dict)

    # Filled by the scheduler / cost model at enqueue time.
    speedup: float = 1.0          # estimated accelerator-vs-host-core speedup
    transfer_impact: float = 0.0  # fraction of exec time spent moving data
    # Absolute completion deadline (serving front end).  Inherited from
    # the request via the stage instance; None = batch work with no
    # latency contract.  The ReadyScheduler's EDF tier orders deadline
    # work ahead of the PATS speedup order.
    deadline: Optional[float] = None

    def __hash__(self) -> int:
        return self.uid


@dataclass
class StageInstance:
    """(data chunk, stage) tuple — the Manager scheduling unit."""

    uid: int
    chunk: DataChunk
    stage: Stage
    deps: set[int] = field(default_factory=set)  # uids of upstream stage insts
    dependents: set[int] = field(default_factory=set)
    op_instances: list[OperationInstance] = field(default_factory=list)
    # Absolute completion deadline inherited from the serving request
    # this instance belongs to (None = batch work).  The Manager's
    # pending queue orders deadline work earliest-first (EDF tier).
    deadline: Optional[float] = None

    def set_deadline(self, deadline: Optional[float]) -> None:
        """Deadline inheritance: request -> stage -> operations."""
        self.deadline = deadline
        for oi in self.op_instances:
            oi.deadline = deadline

    def __hash__(self) -> int:
        return self.uid


class ConcreteWorkflow:
    """Instantiation of an AbstractWorkflow against a set of data chunks."""

    def __init__(self, abstract: AbstractWorkflow):
        self.abstract = abstract
        self.stage_instances: dict[int, StageInstance] = {}
        self.op_instances: dict[int, OperationInstance] = {}
        # Instance uids are scoped to this workflow (they key every
        # scheduler map).  A per-workflow counter — not a module-global
        # one — makes two same-seed runs allocate identical uids, which
        # the event core's bit-identical-replay guarantee relies on.
        self._uid_counter = itertools.count()

    # -- instantiation -----------------------------------------------------

    @staticmethod
    def replicate(
        abstract: AbstractWorkflow, chunks: Sequence[DataChunk]
    ) -> "ConcreteWorkflow":
        """Replicate the full pipeline once per data chunk (Fig 3, top)."""
        cw = ConcreteWorkflow(abstract)
        for chunk in chunks:
            cw.instantiate(chunk)
        return cw

    def instantiate(
        self, chunk: DataChunk, deadline: Optional[float] = None
    ) -> list[StageInstance]:
        """Replicate the abstract pipeline for ONE data chunk and return
        the new stage instances (in topological stage order).

        This is the continuous-ingestion entry point: a serving gateway
        instantiates each admitted request against the live workflow
        and hands the instances to a streaming Manager, instead of
        building the whole ConcreteWorkflow up front.  ``deadline`` (an
        absolute timestamp) is inherited by every stage and operation
        instance created here (EDF scheduling tier).
        """
        abstract = self.abstract
        order = abstract.stage_order()
        preds: dict[str, list[str]] = {s: [] for s in order}
        for src, dst in abstract.edges:
            preds[dst].append(src)
        per_stage: dict[str, StageInstance] = {}
        created: list[StageInstance] = []
        for sname in order:
            si = self._new_stage_instance(chunk, abstract.stage(sname))
            for p in preds[sname]:
                self._link_stages(per_stage[p], si)
            per_stage[sname] = si
            if deadline is not None:
                si.set_deadline(deadline)
            created.append(si)
        return created

    @staticmethod
    def stage_parallel(
        abstract: AbstractWorkflow,
        assignments: Mapping[str, Sequence[DataChunk]],
        fan_in: Mapping[str, Sequence[str]] | None = None,
    ) -> "ConcreteWorkflow":
        """Instantiate different numbers of copies per stage (Fig 3, bottom).

        ``assignments[stage] = [chunk, ...]`` creates one instance per
        chunk for that stage.  ``fan_in[dst_stage] = [src_stage, ...]``
        (default: the abstract edges) wires *every* instance of each
        source stage into *every* instance of the destination stage —
        the "computation involving intermediary results generated from
        multiple input files" pattern.
        """
        cw = ConcreteWorkflow(abstract)
        created: dict[str, list[StageInstance]] = {}
        for sname in abstract.stage_order():
            for chunk in assignments.get(sname, ()):  # may be zero copies
                created.setdefault(sname, []).append(
                    cw._new_stage_instance(chunk, abstract.stage(sname))
                )
        wiring: Mapping[str, Sequence[str]]
        if fan_in is None:
            wiring = {}
            for src, dst in abstract.edges:
                wiring.setdefault(dst, []).append(src)  # type: ignore[attr-defined]
        else:
            wiring = fan_in
        for dst, srcs in wiring.items():
            for dst_inst in created.get(dst, ()):  # all-to-all fan-in
                for src in srcs:
                    for src_inst in created.get(src, ()):  # noqa: B007
                        cw._link_stages(src_inst, dst_inst)
        return cw

    # -- graph construction helpers ----------------------------------------

    def _new_stage_instance(self, chunk: DataChunk, stage: Stage) -> StageInstance:
        si = StageInstance(uid=next(self._uid_counter), chunk=chunk, stage=stage)
        self.stage_instances[si.uid] = si
        # Expand the stage's internal op DAG into operation instances.
        by_name: dict[str, OperationInstance] = {}
        for op in stage.ops:
            oi = OperationInstance(
                uid=next(self._uid_counter), chunk=chunk, op=op, stage_instance=si
            )
            self.op_instances[oi.uid] = oi
            si.op_instances.append(oi)
            by_name[op.name] = oi
        for src, dst in stage.edges:
            by_name[dst].deps.add(by_name[src].uid)
            by_name[dst].dep_names[by_name[src].uid] = src
            by_name[src].dependents.add(by_name[dst].uid)
        return si

    def _link_stages(self, src: StageInstance, dst: StageInstance) -> None:
        dst.deps.add(src.uid)
        src.dependents.add(dst.uid)
        # Export fine-grain dependencies: sink ops of src gate source ops
        # of dst, so the WRM can start downstream fine ops as soon as the
        # true producers finish (not only at stage granularity).
        sink_uids = [
            oi.uid
            for oi in src.op_instances
            if oi.op.name in src.stage.sinks()
        ]
        for oi in dst.op_instances:
            if oi.op.name in dst.stage.sources():
                oi.deps.update(sink_uids)
                for uid in sink_uids:
                    oi.dep_names[uid] = self.op_instances[uid].op.name
                    self.op_instances[uid].dependents.add(oi.uid)

    # -- queries -------------------------------------------------------------

    def ready_stage_instances(self, done: set[int]) -> list[StageInstance]:
        return [
            si
            for si in self.stage_instances.values()
            if si.uid not in done and si.deps.issubset(done)
        ]

    def validate_schedule(self, completion_order: Sequence[int]) -> bool:
        """True iff op instances completed in dependency order."""
        seen: set[int] = set()
        for uid in completion_order:
            oi = self.op_instances[uid]
            if not oi.deps.issubset(seen):
                return False
            seen.add(uid)
        return True
