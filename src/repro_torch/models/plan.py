"""Tensor-parallel attention sharding plan (GQA-aware head padding).

The port's copy of the reference's planner (``repro/models/plan.py``)
without ``ShardingPlan.batch_spec``, which builds a JAX
``PartitionSpec``; the port runs tp=1 only for now.

The planner reorganizes attention into ``slots`` = kv groups
padded/replicated to a multiple of TP, with ``g_eff`` query heads per
slot:

* ``Hkv >= tp``       -> pad kv groups up to a multiple of tp (dead
  slots carry zero weights), queries keep their group size;
* ``Hkv < tp`` and ``tp % Hkv == 0`` -> *replicate* each kv group
  ``rep = tp/Hkv`` times and split its queries across the replicas;
* otherwise            -> pad kv groups straight to tp.

A ``head_mask`` (slots, g_eff) zeroes padded query heads after
attention so numerics are exactly GQA regardless of padding.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .config import ArchConfig

__all__ = ["AttentionPlan", "plan_attention", "ShardingPlan", "make_plan"]


@dataclass(frozen=True)
class AttentionPlan:
    n_heads: int          # real query heads
    n_kv_heads: int       # real kv heads
    slots: int            # padded/replicated kv groups (shardable by tp)
    g_eff: int            # query heads per slot (padded group size)
    rep: int              # kv replication factor
    head_dim: int

    @property
    def q_eff(self) -> int:
        return self.slots * self.g_eff

    @property
    def q_waste(self) -> float:
        """Fraction of query-head compute that is padding."""
        return 1.0 - self.n_heads / self.q_eff

    @property
    def kv_overhead(self) -> float:
        """KV-cache inflation factor vs the real kv head count."""
        return self.slots / self.n_kv_heads

    def q_map(self) -> np.ndarray:
        """real q head i -> (slot, pos) in the padded layout."""
        g = self.n_heads // self.n_kv_heads
        out = np.zeros((self.n_heads, 2), np.int32)
        for i in range(self.n_heads):
            gidx, j = divmod(i, g)
            if self.rep > 1:
                out[i] = (gidx * self.rep + j // self.g_eff, j % self.g_eff)
            else:
                out[i] = (gidx, j)
        return out

    def kv_map(self) -> np.ndarray:
        """slot -> real kv head (or -1 for a dead slot)."""
        out = np.full((self.slots,), -1, np.int32)
        for s in range(self.slots):
            real = s // self.rep
            if real < self.n_kv_heads:
                out[s] = real
        return out

    def head_mask(self) -> np.ndarray:
        m = np.zeros((self.slots, self.g_eff), np.float32)
        for s, p in self.q_map():
            m[s, p] = 1.0
        return m


def plan_attention(cfg: ArchConfig, tp: int = 1) -> AttentionPlan:
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if hq % hkv:
        raise ValueError(f"{cfg.name}: n_heads {hq} not divisible by kv {hkv}")
    g = hq // hkv
    if tp <= 1:
        return AttentionPlan(hq, hkv, hkv, g, 1, hd)
    if hkv >= tp:
        slots = math.ceil(hkv / tp) * tp
        return AttentionPlan(hq, hkv, slots, g, 1, hd)
    if tp % hkv == 0:
        rep = tp // hkv
        g_eff = math.ceil(g / rep)
        return AttentionPlan(hq, hkv, tp, g_eff, rep, hd)
    return AttentionPlan(hq, hkv, tp, g, 1, hd)


@dataclass(frozen=True)
class ShardingPlan:
    """Full logical-axis -> mesh-axis plan for one (arch, mesh) pair."""

    tp: int = 1
    dp_axes: tuple[str, ...] = ()      # mesh axes carrying the batch
    tp_axis: str | None = None         # mesh axis carrying model parallelism
    seq_axis: str | None = None        # mesh axis sharding sequence (SP)
    attention: AttentionPlan | None = None
    shard_experts: bool = True         # EP over tp_axis
    shard_vocab: bool = True


def make_plan(
    cfg: ArchConfig,
    *,
    tp: int = 1,
    dp_axes: tuple[str, ...] = (),
    tp_axis: str | None = None,
    seq_axis: str | None = None,
) -> ShardingPlan:
    return ShardingPlan(
        tp=tp,
        dp_axes=dp_axes,
        tp_axis=tp_axis,
        seq_axis=seq_axis,
        attention=plan_attention(cfg, tp),
        shard_experts=cfg.n_experts > 0,
    )
