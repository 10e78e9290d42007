"""Checkpointing of the port: async, sharded, atomic (torch + numpy shards)."""

from .checkpoint import AsyncCheckpointer, latest_step, load_checkpoint, save_checkpoint

__all__ = ["AsyncCheckpointer", "latest_step", "load_checkpoint", "save_checkpoint"]
