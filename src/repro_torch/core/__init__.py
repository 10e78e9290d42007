"""Core middleware of the port: the threaded Manager/Worker runtime.

The modules here are byte-identical copies of their counterparts in the
JAX package (they are pure Python and import only their siblings). The
simulator and the network model are not part of this package yet.

* :mod:`.workflow` — hierarchical abstract/concrete workflows
* :mod:`.variants` — function-variant registry
* :mod:`.scheduling` — FCFS / PATS / DL policies
* :mod:`.worker` — threaded Worker Resource Manager
* :mod:`.manager` — demand-driven Manager (fault tolerant)
* :mod:`.calibration` — paper-calibrated workload model
* :mod:`.cost_model` — roofline PATS estimates
"""

from .calibration import OP_PROFILES, PIPELINE_ORDER
from .cost_model import OpCost, estimate_speedup, roofline_terms
from .manager import Manager, ManagerConfig
from .scheduling import ReadyScheduler, SchedulerStats
from .variants import FunctionVariant, VariantRegistry, registry
from .worker import DeviceMemory, LaneSpec, OpContext, WorkerRuntime
from .workflow import (
    AbstractWorkflow,
    ConcreteWorkflow,
    DataChunk,
    Operation,
    OperationInstance,
    Stage,
    StageInstance,
)

__all__ = [
    "AbstractWorkflow",
    "ConcreteWorkflow",
    "DataChunk",
    "DeviceMemory",
    "FunctionVariant",
    "LaneSpec",
    "Manager",
    "ManagerConfig",
    "OpContext",
    "OpCost",
    "Operation",
    "OperationInstance",
    "OP_PROFILES",
    "PIPELINE_ORDER",
    "ReadyScheduler",
    "SchedulerStats",
    "Stage",
    "StageInstance",
    "VariantRegistry",
    "WorkerRuntime",
    "estimate_speedup",
    "registry",
    "roofline_terms",
]
