"""Within-node operation scheduling: FCFS, PATS, and data-locality (DL).

This module contains the decision logic only — it is shared verbatim by
the real threaded Worker (``core/worker.py``) and by the discrete-event
cluster simulator (``core/simulator.py``), so scheduling behaviour
measured in the simulator is the behaviour of the production code.

Policies (paper §IV):

* ``fcfs``  — FIFO queue; the next idle device takes the head.
* ``pats``  — queue kept sorted by estimated accelerator speedup.  An
  idle accelerator takes the *maximum*-speedup ready tuple, an idle CPU
  core the *minimum*-speedup tuple.  Only the relative order of the
  estimates matters (paper §V-G).

Data-locality conscious assignment (DL, paper §IV-C) is orthogonal and
applies to accelerator lanes: prefer a ready dependent whose inputs are
already resident in that accelerator's memory.  When speedups are
known, the dependent wins only if ``S_d >= S_q * (1 - transferImpact)``
where ``S_q`` is the best non-resident candidate and ``transferImpact``
is the fraction of that candidate's execution time spent moving data.

Two extensions for the device-resident fast path:

* **chain affinity** — when the runtime chains operations on the
  device (outputs stay resident, no host materialization), a resident
  dependent additionally skips its *own* transfer fraction, so its
  effective speedup is ``S_d / (1 - transferImpact_d)``.  Enabled via
  ``chain_affinity`` in [0, 1] scaling that bonus.
* **micro-batching** — :meth:`ReadyScheduler.pop_batch` pops up to
  ``limit`` ready instances of the *same operation* in one decision so
  an accelerator lane can execute them as a single batched kernel call
  and amortize its launch overhead.

One extension for the serving front end (:mod:`repro.serving`):

* **deadline tier (EDF)** — operation instances carrying a deadline
  (inherited from their serving request) form a tier *above* the
  FCFS/PATS order: an idle lane always takes the earliest-deadline
  work first, and only falls back to the batch queue when no deadline
  work is ready.  Within one deadline group (all ops of one request
  share its deadline) the PATS rule still applies — accelerators take
  the max-speedup member, host cores the min — so EDF decides *which
  request* runs next and PATS decides *where* its ops run.
* **slack band** — with ``edf_slack_band`` set, strict EDF preemption
  applies only to deadline work that is *at risk* (earliest deadline
  within ``band`` seconds of now).  Deadline work with ample slack no
  longer starves the locality/PATS order: the batch tier runs with its
  normal placement quality and the EDF tier reclaims priority exactly
  when urgency demands it.  ``None`` keeps the strict-EDF behavior.
"""

from __future__ import annotations

import bisect
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from .workflow import OperationInstance

__all__ = ["ReadyScheduler", "SchedulerStats", "HOST_KIND"]

HOST_KIND = "cpu"


@dataclass
class SchedulerStats:
    """Per-(op name, lane kind) assignment counts — Fig 10/12 profiles."""

    assigned: dict[tuple[str, str], int] = field(default_factory=dict)
    reuse_hits: int = 0
    reuse_misses: int = 0
    # Micro-batched dispatch: batched pops (>1 member) and the total
    # number of op instances dispatched inside those batches.
    batches: int = 0
    batched_ops: int = 0
    # Serving: pops served from the deadline (EDF) tier.
    deadline_pops: int = 0
    # Slack-band hybrid: pops where deadline work was queued but had
    # enough slack that the locality/PATS order was served instead.
    slack_deferrals: int = 0

    def record(self, op_name: str, lane_kind: str) -> None:
        key = (op_name, lane_kind)
        self.assigned[key] = self.assigned.get(key, 0) + 1

    def profile(self) -> dict[str, dict[str, int]]:
        out: dict[str, dict[str, int]] = {}
        for (op, kind), n in self.assigned.items():
            out.setdefault(op, {})[kind] = n
        return out

    def accel_fraction(self, accel_kind: str = "gpu") -> dict[str, float]:
        prof = self.profile()
        return {
            op: kinds.get(accel_kind, 0) / max(sum(kinds.values()), 1)
            for op, kinds in prof.items()
        }

    def bind(self, registry, prefix: str = "scheduler") -> "SchedulerStats":
        """Serve the scalar counters from a shared ``MetricsRegistry``.

        The int fields are replaced with the registry's int-like
        counter cells (same ``+=`` call sites, comparisons, and reads
        — see :mod:`repro.telemetry.metrics`); ``assigned`` stays a
        plain dict (its per-(op, lane) keys are a profile, not a
        scalar metric).  Unbound (the default, e.g. the thousands of
        per-node schedulers inside a simulation) nothing changes and
        increments stay plain-int cheap.
        """
        for name in ("reuse_hits", "reuse_misses", "batches",
                     "batched_ops", "deadline_pops", "slack_deferrals"):
            cell = registry.counter(f"{prefix}.{name}")
            cell.inc(int(getattr(self, name)))
            setattr(self, name, cell)
        return self


class _SortedTasks:
    """Tasks kept sorted by (speedup, seq).  O(log n) insert/remove."""

    def __init__(self) -> None:
        self._keys: list[tuple[float, int]] = []
        self._tasks: list[OperationInstance] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._tasks)

    def add(self, task: OperationInstance) -> None:
        key = (task.speedup, self._seq)
        self._seq += 1
        i = bisect.bisect(self._keys, key)
        self._keys.insert(i, key)
        self._tasks.insert(i, task)

    def pop_min(self) -> OperationInstance:
        self._keys.pop(0)
        return self._tasks.pop(0)

    def pop_max(self) -> OperationInstance:
        self._keys.pop()
        return self._tasks.pop()

    def peek_max(self) -> OperationInstance:
        return self._tasks[-1]

    def remove(self, task: OperationInstance) -> None:
        # speedup is not mutated while queued, so key search is exact.
        lo = bisect.bisect_left(self._keys, (task.speedup, -1))
        for i in range(lo, len(self._tasks)):
            if self._tasks[i] is task:
                del self._keys[i]
                del self._tasks[i]
                return
            if self._keys[i][0] > task.speedup:
                break
        raise ValueError("task not in queue")

    def __iter__(self) -> Iterable[OperationInstance]:
        return iter(self._tasks)


class _DeadlineTasks:
    """Deadline-carrying tasks sorted by (deadline, speedup, seq).

    The earliest-deadline *group* (ops sharing one request's deadline)
    is served first; within the group an accelerator lane takes the
    max-speedup member and a host lane the min — the PATS rule applied
    inside the EDF tier.
    """

    def __init__(self) -> None:
        self._keys: list[tuple[float, float, int]] = []
        self._tasks: list[OperationInstance] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._tasks)

    def __iter__(self) -> Iterable[OperationInstance]:
        return iter(self._tasks)

    def add(self, task: OperationInstance) -> None:
        key = (float(task.deadline), task.speedup, self._seq)
        self._seq += 1
        i = bisect.bisect(self._keys, key)
        self._keys.insert(i, key)
        self._tasks.insert(i, task)

    def peek_deadline(self) -> float:
        return self._keys[0][0]

    def pop_for(self, lane_kind: str) -> OperationInstance:
        d0 = self._keys[0][0]
        # End of the earliest-deadline group.
        hi = bisect.bisect_right(self._keys, (d0, float("inf"), 1 << 62))
        i = 0 if lane_kind == HOST_KIND else hi - 1
        self._keys.pop(i)
        return self._tasks.pop(i)

    def remove(self, task: OperationInstance) -> None:
        lo = bisect.bisect_left(
            self._keys, (float(task.deadline), task.speedup, -1)
        )
        for i in range(lo, len(self._tasks)):
            if self._tasks[i] is task:
                del self._keys[i]
                del self._tasks[i]
                return
        raise ValueError("task not in deadline queue")


class ReadyScheduler:
    """Queue of ready ``(data chunk, operation)`` tuples + pop policy."""

    def __init__(self, policy: str = "fcfs", locality: bool = False,
                 speedups_known: bool = True, chain_affinity: float = 0.0,
                 deadline_aware: bool = True, registry=None,
                 edf_slack_band: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        if policy not in ("fcfs", "pats"):
            raise ValueError(f"unknown policy {policy!r}")
        self.policy = policy
        self.locality = locality
        # DL degrades gracefully when estimates are unavailable: always
        # prefer reuse (paper §IV-C, first case).
        self.speedups_known = speedups_known
        # Device-resident chaining recovers the dependent's own transfer
        # fraction on top of the classic DL rule (0 = plain DL).
        self.chain_affinity = chain_affinity
        # Serving deadline tier: tasks with a deadline are popped EDF,
        # ahead of the batch queue.  False = deadlines ignored (the
        # FIFO baseline the serving benchmarks compare against).
        self.deadline_aware = deadline_aware
        # Slack-aware EDF hybrid: strict EDF preemption only when the
        # earliest deadline is within this many seconds; otherwise the
        # locality/PATS order runs first (None = always preempt).  The
        # clock is injectable so the simulator can drive it with
        # virtual time; deadlines must be on the same clock.
        self.edf_slack_band = edf_slack_band
        self.clock: Callable[[], float] = clock or time.monotonic
        self.stats = SchedulerStats()
        if registry is not None:
            self.stats.bind(registry)
        self._fifo: deque[OperationInstance] = deque()
        self._sorted = _SortedTasks()
        self._edf = _DeadlineTasks()

    # -- queue maintenance ---------------------------------------------------

    def push(self, task: OperationInstance) -> None:
        if self.deadline_aware and task.deadline is not None:
            self._edf.add(task)
        elif self.policy == "pats":
            self._sorted.add(task)
        else:
            self._fifo.append(task)

    def __len__(self) -> int:
        n = len(self._sorted) if self.policy == "pats" else len(self._fifo)
        return n + len(self._edf)

    def __bool__(self) -> bool:
        return len(self) > 0

    # -- dispatch --------------------------------------------------------------

    def pop(
        self,
        lane_kind: str,
        resident_producers: Optional[set[int]] = None,
    ) -> Optional[OperationInstance]:
        """Select the next tuple for an idle lane of ``lane_kind``.

        ``resident_producers`` — uids of op instances whose outputs are
        already in this lane's device memory (accelerator lanes only).
        """
        if not self:
            return None
        task: Optional[OperationInstance]
        if self._edf:
            # Deadline tier first: the most urgent request's ops beat
            # any batch work, whatever its speedup or residency — unless
            # a slack band says the earliest deadline is not yet at
            # risk AND batch work exists to fill the lane (the hybrid
            # stays work-conserving: an empty batch tier always serves
            # deadline work regardless of slack).
            band = self.edf_slack_band
            batch_n = (
                len(self._sorted) if self.policy == "pats" else len(self._fifo)
            )
            if (
                band is None
                or batch_n == 0
                or self._edf.peek_deadline() - self.clock() <= band
            ):
                task = self._edf.pop_for(lane_kind)
                self.stats.deadline_pops += 1
                self.stats.record(task.op.name, lane_kind)
                return task
            self.stats.slack_deferrals += 1
        if self.locality and lane_kind != HOST_KIND and resident_producers:
            task = self._pop_locality(lane_kind, resident_producers)
        elif self.policy == "pats":
            task = (
                self._sorted.pop_min()
                if lane_kind == HOST_KIND
                else self._sorted.pop_max()
            )
        else:
            task = self._fifo.popleft()
        if task is not None:
            self.stats.record(task.op.name, lane_kind)
        return task

    def batch_limit(self, micro_batch: int, idle_lanes: int) -> int:
        """Work-conserving batch depth for one idle accelerator lane.

        Never batch deeper than the ready queue can still feed the
        other idle lanes — amortization must not steal their
        parallelism.  Shared by the threaded worker and the simulator
        so measured batching behaviour is production behaviour.
        """
        return min(micro_batch, max(1, len(self) // max(idle_lanes, 1)))

    def pop_batch(
        self,
        lane_kind: str,
        resident_producers: Optional[set[int]] = None,
        *,
        limit: int = 1,
        batchable: Optional[Callable[[OperationInstance], int]] = None,
    ) -> list[OperationInstance]:
        """Pop up to ``limit`` ready instances of the *same operation*.

        The head is selected with the normal policy (PATS/FCFS + DL);
        when it is batchable, further queued instances of the same op
        join it regardless of queue position — they would execute with
        identical kernels anyway, and one batched launch amortizes the
        dispatch overhead (latency tradeoff measured in the simulator's
        batched-runtime curves).

        ``batchable(head)`` returns the head op's own batch cap (its
        variant's ``max_batch``; <= 1 disables batching) — a batched
        implementation must never receive more contexts than its
        declared maximum.
        """
        first = self.pop(lane_kind, resident_producers)
        if first is None:
            return []
        batch = [first]
        if batchable is not None:
            limit = min(limit, int(batchable(first)))
        if limit <= 1:
            return batch
        # Urgent (EDF-tier) members join the batch first: a batched
        # launch that would run anyway should carry the deadline work.
        pool = list(self._edf)
        pool += list(self._sorted) if self.policy == "pats" else list(self._fifo)
        for task in pool:
            if len(batch) >= limit:
                break
            if task.op.name != first.op.name:
                continue
            self._remove(task)
            self.stats.record(task.op.name, lane_kind)
            batch.append(task)
        if len(batch) > 1:
            self.stats.batches += 1
            self.stats.batched_ops += len(batch)
        return batch

    def reestimate(
        self, estimate: Callable[[OperationInstance], float]
    ) -> None:
        """Refresh queued tasks' speedup estimates and restore order.

        Called when the online EMA estimator (``FunctionVariant.
        observe_runtime``) shifts an estimate: PATS keeps the ready
        queue sorted by speedup, so already-queued instances must be
        re-keyed or the queue order goes stale against the estimates.
        """
        if self._edf:
            # Deadline keys embed the speedup (PATS-in-tier tie-break):
            # re-key the EDF queue alongside the batch queue.
            urgent = list(self._edf)
            for task in urgent:
                task.speedup = estimate(task)
            fresh_edf = _DeadlineTasks()
            for task in urgent:
                fresh_edf.add(task)
            self._edf = fresh_edf
        if self.policy != "pats":
            for task in self._fifo:
                task.speedup = estimate(task)
            return
        tasks = list(self._sorted)
        for task in tasks:
            task.speedup = estimate(task)
        fresh = _SortedTasks()
        for task in tasks:
            fresh.add(task)
        self._sorted = fresh

    def _chained_speedup(self, task: OperationInstance) -> float:
        """Effective speedup of a resident dependent under chaining:
        its inputs need no upload and its output stays resident, so the
        transfer fraction of its own runtime is recovered."""
        return task.speedup / max(
            1.0 - self.chain_affinity * task.transfer_impact, 1e-9
        )

    def _pop_locality(
        self, lane_kind: str, resident: set[int]
    ) -> Optional[OperationInstance]:
        pool = list(self._sorted) if self.policy == "pats" else list(self._fifo)
        reusing = [t for t in pool if t.deps & resident]
        if not reusing:
            self.stats.reuse_misses += 1
            return self._pop_plain(lane_kind)
        if self.policy == "fcfs" or not self.speedups_known:
            # No (usable) estimates: reuse always wins.
            choice = reusing[0]
            self._remove(choice)
            self.stats.reuse_hits += 1
            return choice
        # PATS + DL: best dependent vs best non-resident candidate.
        best_dep = max(reusing, key=self._chained_speedup)
        non_reusing = [t for t in pool if not (t.deps & resident)]
        if not non_reusing:
            self._remove(best_dep)
            self.stats.reuse_hits += 1
            return best_dep
        best_q = max(non_reusing, key=lambda t: t.speedup)
        if self._chained_speedup(best_dep) >= best_q.speedup * (
            1.0 - best_q.transfer_impact
        ):
            self._remove(best_dep)
            self.stats.reuse_hits += 1
            return best_dep
        self._remove(best_q)
        self.stats.reuse_misses += 1
        return best_q

    def _pop_plain(self, lane_kind: str) -> Optional[OperationInstance]:
        if self.policy == "pats":
            return (
                self._sorted.pop_min()
                if lane_kind == HOST_KIND
                else self._sorted.pop_max()
            )
        return self._fifo.popleft()

    def _remove(self, task: OperationInstance) -> None:
        if self.deadline_aware and task.deadline is not None:
            self._edf.remove(task)
        elif self.policy == "pats":
            self._sorted.remove(task)
        else:
            self._fifo.remove(task)
