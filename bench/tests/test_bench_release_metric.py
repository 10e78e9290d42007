"""The reader of the program's ``release`` spans on hand-made records:
it reads the window's tiles only, and nothing where the run holds no
such span (an untraced run, or a program that releases nothing)."""

import pytest

from benchkit.record import Run, TileTimes
from benchkit.spec import load_module

GIB = 2**30


def span(name, ts, dur, **args):
    return {"name": name, "ts": ts, "dur": dur, "args": args}


def _run(spans=()):
    # Window (100, 110] on perf_counter, wall 1000-1010: tiles 1 and 2
    # complete in it, tile 0 before it and tile 3 after it.
    tiles = {0: TileTimes(0, 95.0, 99.0), 1: TileTimes(1, 99.0, 104.0),
             2: TileTimes(2, 101.0, 109.0), 3: TileTimes(3, 105.0, 111.0)}
    return Run(t_open=100.0, t_close=110.0, wall_open=1000.0, setup_s=1.0, tiles=tiles,
               counters_open={}, counters_close={}, peak_bytes=0, window_peak_bytes=0,
               tile_shape=(4096, 4096), stage_ops={"segmentation": ["a", "b"], "features": ["c"]},
               spans=list(spans), op_chunks={10: 1, 11: 2, 12: 0, 13: 3}, device=None)


def read(run):
    return load_module("metrics", "released_gib_per_tile").read(run)


def test_released_gib_per_tile_of_the_window():
    spans = [span("release", 1004.0, 0.001, chunk=1, bytes=GIB // 2),
             span("release", 1009.0, 0.001, chunk=2, bytes=GIB),
             span("release", 999.0, 0.001, chunk=0, bytes=8 * GIB),   # before the window
             span("release", 1011.0, 0.001, chunk=3, bytes=8 * GIB),  # after it
             span("op:a", 1000.0, 3.0, uid=10)]
    assert read(_run(spans)) == pytest.approx(0.75)


def test_nothing_to_read_without_a_release():
    assert read(_run()) is None
    assert read(_run([span("op:a", 1000.0, 2.0, uid=10),
                      span("lane:between", 1002.0, 0.001, chunk=1, uid=10)])) is None
