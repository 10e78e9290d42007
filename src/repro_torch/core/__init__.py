"""Core middleware of the port: the threaded Manager/Worker runtime and
the cluster simulator.

The modules here are byte-identical copies of their counterparts in the
JAX package (they are pure Python and import only their siblings and
the port's own copies of ``staging``, ``telemetry`` and ``serving``).

* :mod:`.workflow` — hierarchical abstract/concrete workflows
* :mod:`.variants` — function-variant registry
* :mod:`.scheduling` — FCFS / PATS / DL policies
* :mod:`.worker` — threaded Worker Resource Manager
* :mod:`.manager` — demand-driven Manager (fault tolerant)
* :mod:`.simulator` — discrete-event cluster simulator
* :mod:`.network` — per-link topology model (flat / fat-tree)
* :mod:`.calibration` — paper-calibrated workload model
* :mod:`.cost_model` — roofline PATS estimates
"""

from .calibration import OP_PROFILES, PIPELINE_ORDER
from .cost_model import OpCost, estimate_speedup, roofline_terms
from .manager import Manager, ManagerConfig
from .network import FatTreeNetwork, FlatNetwork, NetworkModel, build_network
from .scheduling import ReadyScheduler, SchedulerStats
from .simulator import ClusterSim, SimConfig, SimResult, run_simulation
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
    "ClusterSim",
    "ConcreteWorkflow",
    "DataChunk",
    "DeviceMemory",
    "FatTreeNetwork",
    "FlatNetwork",
    "FunctionVariant",
    "LaneSpec",
    "Manager",
    "ManagerConfig",
    "NetworkModel",
    "OpContext",
    "OpCost",
    "Operation",
    "OperationInstance",
    "OP_PROFILES",
    "PIPELINE_ORDER",
    "ReadyScheduler",
    "SchedulerStats",
    "SimConfig",
    "SimResult",
    "Stage",
    "StageInstance",
    "VariantRegistry",
    "WorkerRuntime",
    "build_network",
    "estimate_speedup",
    "registry",
    "roofline_terms",
    "run_simulation",
]
