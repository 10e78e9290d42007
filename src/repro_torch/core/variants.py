"""Function-variant registry (paper §III-A).

A *function variant* is a group of implementations with the same name,
arguments and result types, one per device kind.  Binding a logical
operation to a variant lets the runtime pick the implementation that
matches whatever compute lane the scheduler chose — CPU core, GPU,
TPU-interpret, ... — so heterogeneous devices are used concurrently and
in coordination.

The registry also carries per-variant *speedup estimates* (accelerator
vs one host core) which feed the PATS scheduler.  Estimates may be

* static (registered alongside the implementation),
* data-dependent (a callable of the chunk's ``meta``), or
* learned online from observed runtimes (exponential moving average),

mirroring the paper's observation that both per-operation and per-chunk
variability exist.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

__all__ = ["FunctionVariant", "VariantRegistry", "registry"]

SpeedupFn = Callable[[Mapping[str, Any]], float]


@dataclass
class FunctionVariant:
    """All registered implementations of one logical operation."""

    name: str
    impls: dict[str, Callable[..., Any]] = field(default_factory=dict)
    # accelerator-vs-host speedup estimate; key is accelerator kind
    speedup: dict[str, float] = field(default_factory=dict)
    speedup_fn: dict[str, SpeedupFn] = field(default_factory=dict)
    # fraction of exec time spent on host<->device transfers
    transfer_impact: float = 0.0
    # Micro-batched dispatch: a batchable variant allows an idle
    # accelerator lane to pop up to ``max_batch`` ready instances of
    # this op and execute them as one (v)mapped kernel call.  Only ops
    # whose implementation compiles once per chunk shape (regular,
    # shape-stable) should declare this.
    batchable: bool = False
    max_batch: int = 1
    # kind -> batched implementation taking a list of OpContexts and
    # returning a same-length list of outputs.  Absent => the runtime
    # loops the scalar implementation (still one dispatch decision).
    batch_impls: dict[str, Callable[..., Any]] = field(default_factory=dict)
    # online estimator state: kind -> (ema_runtime, n_obs)
    _observed: dict[str, tuple[float, int]] = field(default_factory=dict)

    def implementation(self, device_kind: str) -> Callable[..., Any]:
        if device_kind in self.impls:
            return self.impls[device_kind]
        # Fall back to the host implementation: a variant is allowed to
        # exist only for some kinds (e.g. no accelerator port yet).
        if "cpu" in self.impls:
            return self.impls["cpu"]
        raise KeyError(
            f"variant {self.name!r} has no implementation for {device_kind!r}"
        )

    def supports(self, device_kind: str) -> bool:
        return device_kind in self.impls

    def batch_implementation(
        self, device_kind: str
    ) -> Callable[..., Any] | None:
        """Batched implementation for ``device_kind`` (None => loop)."""
        return self.batch_impls.get(device_kind)

    def estimate_speedup(
        self, device_kind: str, meta: Mapping[str, Any] | None = None
    ) -> float:
        """Estimated speedup of running on ``device_kind`` vs one host core."""
        if device_kind == "cpu":
            return 1.0
        # Online observations dominate once both kinds have been timed.
        obs = self._observed
        if "cpu" in obs and device_kind in obs and obs[device_kind][1] >= 2:
            return max(obs["cpu"][0] / max(obs[device_kind][0], 1e-12), 1e-6)
        if device_kind in self.speedup_fn and meta is not None:
            return self.speedup_fn[device_kind](meta)
        return self.speedup.get(device_kind, 1.0)

    def observe_runtime(self, device_kind: str, seconds: float) -> None:
        ema, n = self._observed.get(device_kind, (seconds, 0))
        alpha = 0.3
        self._observed[device_kind] = (alpha * seconds + (1 - alpha) * ema, n + 1)

    def expected_runtime(self, device_kind: str) -> float | None:
        """Online EMA of the per-instance runtime on ``device_kind``
        (None until observed) — feeds the adaptive micro-batch sizing
        (``cost_model.optimal_micro_batch`` latency-budget curve)."""
        obs = self._observed.get(device_kind)
        return obs[0] if obs is not None else None


class VariantRegistry:
    """Thread-safe name -> FunctionVariant map."""

    def __init__(self) -> None:
        self._variants: dict[str, FunctionVariant] = {}
        self._lock = threading.Lock()

    def register(
        self,
        name: str,
        device_kind: str,
        fn: Callable[..., Any],
        *,
        speedup: float | None = None,
        speedup_fn: SpeedupFn | None = None,
        transfer_impact: float | None = None,
        batchable: bool | None = None,
        max_batch: int | None = None,
        batch_fn: Callable[..., Any] | None = None,
    ) -> FunctionVariant:
        with self._lock:
            var = self._variants.setdefault(name, FunctionVariant(name))
            var.impls[device_kind] = fn
            if speedup is not None:
                var.speedup[device_kind] = speedup
            if speedup_fn is not None:
                var.speedup_fn[device_kind] = speedup_fn
            if transfer_impact is not None:
                var.transfer_impact = transfer_impact
            if batchable is not None:
                var.batchable = batchable
            if batch_fn is not None:
                var.batch_impls[device_kind] = batch_fn
                var.batchable = True
            if max_batch is not None:
                var.max_batch = max_batch
            elif var.batchable and var.max_batch <= 1:
                var.max_batch = 8  # usable default once declared batchable
            return var

    def cpu(self, name: str, **kw: Any) -> Callable[[Callable], Callable]:
        """Decorator: ``@registry.cpu("watershed")``."""
        return self._decorator(name, "cpu", **kw)

    def accel(self, name: str, kind: str = "gpu", **kw: Any):
        return self._decorator(name, kind, **kw)

    def _decorator(self, name: str, kind: str, **kw: Any):
        def deco(fn: Callable) -> Callable:
            self.register(name, kind, fn, **kw)
            return fn

        return deco

    def get(self, name: str) -> FunctionVariant:
        with self._lock:
            if name not in self._variants:
                raise KeyError(f"no function variant registered as {name!r}")
            return self._variants[name]

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._variants

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._variants)

    def clear(self) -> None:  # test hook
        with self._lock:
            self._variants.clear()


#: Process-global registry; applications may also instantiate their own.
registry = VariantRegistry()
