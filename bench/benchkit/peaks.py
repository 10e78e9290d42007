"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the
700 W power limit) and the roofline share of a kernel in a device
trace."""

from __future__ import annotations

import re

__all__ = ["BF16_FLOPS", "F32_FLOPS", "HBM_BYTES_PER_S", "launch_times", "least_seconds",
           "roofline_share", "roofline_share_per_launch"]

HBM_BYTES_PER_S = 3.35e12   # HBM3
F32_FLOPS = 67e12           # float32 outside the tensor cores
BF16_FLOPS = 989e12         # bfloat16 on the tensor cores, dense


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


def launch_times(run, symbol: str) -> list[float]:
    """Device seconds of each launch of the kernel ``symbol`` in the
    traced window, in the order the launches started (none untraced)."""
    if run.device is None:
        return []
    pat = re.compile(rf"\b{re.escape(symbol)}\b")
    return [e.dur for e in sorted(run.device.events, key=lambda e: e.start)
            if e.kind == "kernel" and pat.search(e.name)]


def roofline_share_per_launch(run, symbol: str, sizes: list[tuple[float, float]],
                              peak_flops: float = F32_FLOPS) -> float | None:
    """As :func:`roofline_share`, where each launch has a size of its
    own: ``sizes`` holds ``(nbytes, flops)`` of each launch in the
    traced window, in the order they started. None where the trace holds
    no launch, or another number of launches than ``sizes``."""
    times = launch_times(run, symbol)
    if not times or len(times) != len(sizes) or sum(times) <= 0:
        return None
    return 100.0 * sum(least_seconds(b, f, peak_flops) for b, f in sizes) / sum(times)
