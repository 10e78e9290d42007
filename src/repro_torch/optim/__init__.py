"""Optimizers of the port: AdamW, clipping, schedules, int8 moments and
gradient compression (the port of ``repro/optim``)."""

from .adamw import AdamW, OptState, cosine_schedule, global_norm
from .adamw8bit import AdamW8bit, Opt8State, dequantize_blockwise, quantize_blockwise
from .compress import compress_int8, decompress_int8

__all__ = [
    "AdamW",
    "AdamW8bit",
    "Opt8State",
    "OptState",
    "cosine_schedule",
    "global_norm",
    "compress_int8",
    "decompress_int8",
    "quantize_blockwise",
    "dequantize_blockwise",
]
