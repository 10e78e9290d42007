"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the
700 W power limit) and the roofline share of a kernel in a device
trace."""

from __future__ import annotations

import re

__all__ = ["F32_FLOPS", "HBM_BYTES_PER_S", "least_seconds", "roofline_share"]

HBM_BYTES_PER_S = 3.35e12   # HBM3
F32_FLOPS = 67e12           # float32 outside the tensor cores


def least_seconds(nbytes: float, flops: float, peak_flops: float = F32_FLOPS) -> float:
    """The least time the chip could take: the larger of the bytes at
    the memory's peak and the operations at the compute peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def roofline_share(run, symbol: str, nbytes: float, flops: float,
                   peak_flops: float = F32_FLOPS) -> float | None:
    """Percent of its roofline that the kernel ``symbol`` reached over
    the traced window: the least time of each of its launches (each of
    ``nbytes`` and ``flops``, counted from the shapes the harness hands
    in) over their device time. None where the trace holds no launch."""
    if run.device is None:
        return None
    pat = re.compile(rf"\b{re.escape(symbol)}\b")
    times = [e.dur for e in run.device.events if e.kind == "kernel" and pat.search(e.name)]
    if not times or sum(times) <= 0:
        return None
    return 100.0 * len(times) * least_seconds(nbytes, flops, peak_flops) / sum(times)
