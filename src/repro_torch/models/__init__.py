"""LM model zoo of the port: configs, planning, and the ``dense`` and
``hybrid`` families on the port's attention and scan kernels."""

from .config import ArchConfig, reduced
from .convert import params_from_jax
from .model import Model, build_model
from .plan import AttentionPlan, ShardingPlan, make_plan, plan_attention

__all__ = [
    "ArchConfig",
    "AttentionPlan",
    "Model",
    "ShardingPlan",
    "build_model",
    "make_plan",
    "params_from_jax",
    "plan_attention",
    "reduced",
]
