"""The readers of the program's lane spans on hand-made records: each
reads the window's tiles only, and reads nothing where the run holds
no such span (an untraced run, or a program without them). On the
card: the program's spans and the profiler's device events are on one
clock."""

import time

import pytest
import torch

from benchkit.record import Run, TileTimes
from benchkit.spans import Busy, device_s_by_op, idle_by_span
from benchkit.spec import load_module
from benchkit.trace import DeviceEvent, DeviceTrace, union_seconds

NEW = ("op_wait_s_per_tile", "lease_wait_s_per_tile", "host_syncs_per_tile",
       "op_device_busy_share", "device_allocs_per_tile", "gc_ms_per_tile")


def span(name, ts, dur, **args):
    return {"name": name, "ts": ts, "dur": dur, "args": args}


def _run(spans=(), device=None):
    # Window (100, 110] on perf_counter, wall 1000-1010: tiles 1 and 2
    # complete in it, tile 0 before it and tile 3 after it.
    tiles = {0: TileTimes(0, 95.0, 99.0), 1: TileTimes(1, 99.0, 104.0),
             2: TileTimes(2, 101.0, 109.0), 3: TileTimes(3, 105.0, 111.0)}
    return Run(t_open=100.0, t_close=110.0, wall_open=1000.0, setup_s=1.0, tiles=tiles,
               counters_open={}, counters_close={}, peak_bytes=0, window_peak_bytes=0,
               tile_shape=(4096, 4096), stage_ops={"segmentation": ["a", "b"], "features": ["c"]},
               spans=list(spans), op_chunks={10: 1, 11: 2, 12: 0, 13: 3}, device=device)


def read(name, run):
    return load_module("metrics", name).read(run)


def test_queue_and_lease_waits_per_tile():
    spans = [span("wait:op", 1000.0, 0.5, chunk=1), span("wait:op", 1001.0, 1.5, chunk=2),
             span("wait:op", 990.0, 9.0, chunk=0), span("wait:op", 1009.0, 4.0, chunk=3),
             span("wait:lease", 1000.0, 0.25, chunk=1, stage="features"),
             span("wait:lease", 995.0, 7.0, chunk=2, stage="segmentation"),  # a first stage
             span("wait:lease", 1002.0, 0.75, chunk=2, stage="features"),
             span("op:a", 1000.0, 3.0, uid=10)]
    run = _run(spans)
    assert read("op_wait_s_per_tile", run) == pytest.approx(1.0)
    assert read("lease_wait_s_per_tile", run) == pytest.approx(0.5)


def test_syncs_and_allocations_per_tile():
    spans = [span("sync", 1000.0, 0.01, chunk=1, site="label_sweep")] * 3 + [
        span("sync", 1001.0, 0.01, chunk=2, site="op_end"),
        span("sync", 999.0, 0.01, chunk=0, site="op_end"),
        span("lane:between", 1000.0, 0.001, chunk=1, uid=10, allocs=4, frees=0, retries=0),
        span("lane:between", 1001.0, 0.001, chunk=2, uid=11, allocs=2, frees=1, retries=0),
        span("lane:between", 1002.0, 0.001, chunk=2, uid=11),  # an op that noted nothing
        span("lane:between", 998.0, 0.001, chunk=0, uid=12, allocs=100)]
    run = _run(spans)
    assert read("host_syncs_per_tile", run) == pytest.approx(2.0)
    assert read("device_allocs_per_tile", run) == pytest.approx(3.0)
    # A program whose ops note no allocator counts: nothing to read.
    assert read("device_allocs_per_tile", _run([spans[-2]])) is None


def test_gc_inside_the_window_per_tile():
    spans = [span("gc", 1001.0, 0.004, generation=0), span("gc", 1009.999, 0.002, generation=2),
             span("gc", 990.0, 1.0, generation=2)]
    # 4 ms inside, 1 of the 2 ms straddling the close, none before the opening.
    assert read("gc_ms_per_tile", _run(spans)) == pytest.approx(2.5)


def _device(events, start=1000.0, end=1010.0):
    return DeviceTrace(start, end, [DeviceEvent(n, s, d) for n, s, d in events])


def test_device_busy_inside_the_window_tiles_ops():
    ev = [("k1", 1000.5, 1.0), ("k2", 1001.0, 1.0), ("k3", 1005.0, 2.0), ("k4", 999.0, 2.0)]
    spans = [span("op:a", 999.5, 3.5, uid=10),   # [1000, 1003] in the window: busy 2 (k4 to 1001, k1, k2)
             span("op:c", 1004.0, 2.0, uid=11),  # busy 1 of 2
             span("op:a", 1005.0, 2.0, uid=12),  # tile 0: not read
             span("op:b", 1003.0, 4.0, uid=13)]  # tile 3: not read
    run = _run(spans, _device(ev))
    assert read("op_device_busy_share", run) == pytest.approx(100.0 * 3.0 / 5.0)
    assert device_s_by_op(run) == pytest.approx({"op:a": 2.0, "op:c": 1.0})


def test_busy_within_any_interval():
    busy = Busy(_device([("a", 1000.0, 1.0), ("b", 1000.5, 1.0), ("c", 1003.0, 1.0)]))
    assert busy.within(999.0, 1011.0) == pytest.approx(2.5)
    assert busy.within(1000.25, 1003.5) == pytest.approx(1.75)
    assert busy.within(1001.6, 1002.9) == 0.0
    assert busy.within(1003.2, 1003.4) == pytest.approx(0.2)


def test_idle_named_by_the_innermost_span():
    trace = _device([("k", 1000.0, 1.0), ("k", 1004.0, 1.0), ("k", 1009.0, 1.0)])
    spans = [span("op:a", 1000.0, 3.0, uid=10), span("sync", 1001.5, 1.0, site="label_sweep"),
             span("gc", 1002.0, 0.25, generation=0), span("lane:between", 1003.0, 0.5, chunk=1),
             span("op:b", 1003.5, 4.0, uid=11), span("wait:op", 1000.0, 9.0, chunk=1)]
    idle = idle_by_span(trace, spans)
    assert idle == pytest.approx({"op:a": 1.0, "sync:label_sweep": 0.75, "gc": 0.25,
                                  "lane:between": 0.5, "op:b": 3.0, "no span": 1.5})
    assert sum(idle.values()) == pytest.approx(10.0 - union_seconds(trace.clipped()))


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_a_trace(name):
    # An untraced run: no spans, no device trace.
    assert read(name, _run()) is None
    # A traced run of a program that records only ``op:*`` spans reads
    # nothing from the lane spans; the device share still reads.
    run = _run([span("op:a", 1000.0, 2.0, uid=10)], _device([("k", 1000.0, 1.0)]))
    assert (read(name, run) is None) == (name != "op_device_busy_share")


@pytest.mark.gpu
def test_spans_and_device_trace_share_one_clock():
    """A span opened around a ``torch.cuda._sleep`` and a synchronise
    holds the kernel's interval as ``benchkit.trace`` reads it, each end
    within 0.2 ms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchkit.trace import Profiler
    from repro_torch.telemetry import Tracer

    tracer = Tracer("clock", sample_rate=1.0, seed=0)
    torch.cuda._sleep(1_000_000)  # warm the launch path
    torch.cuda.synchronize()
    prof = Profiler()
    prof.start()
    torch.cuda._sleep(1000)  # the profiler may drop a session's first record
    for _ in range(3):
        time.sleep(0.01)
        with tracer.span("probe", ctx=tracer.start_trace()):
            torch.cuda._sleep(20_000_000)  # ~10 ms at the card's clock
            torch.cuda.synchronize()
    torch.cuda._sleep(1000)
    trace = prof.stop()
    probes = [s for s in tracer.spans() if s["name"] == "probe"]
    spins = sorted((e for e in trace.events if "spin_kernel" in e.name and e.dur > 2e-3),
                   key=lambda e: e.start)
    assert len(spins) == len(probes) == 3
    offsets = [(k.start - s["ts"], s["ts"] + s["dur"] - k.end) for s, k in zip(probes, spins)]
    print("kernel start after span start, span end after kernel end (ms):",
          [(round(1e3 * a, 4), round(1e3 * b, 4)) for a, b in offsets])
    for a, b in offsets:
        assert -2e-4 <= a <= 2e-4 and -2e-4 <= b <= 2e-4
