"""The metric arithmetic on synthetic records: the rate over the whole
window, the percentile over all tiles, the union of device intervals
and its gaps, and the roofline's bytes."""

import math

import pytest

from benchkit.peaks import HBM_BYTES_PER_S, least_seconds
from benchkit.record import Item, Run, nearest_rank
from benchkit.spec import load_module
from benchkit.trace import DeviceEvent, DeviceTrace, breakdown, gaps, union_seconds
from kinds.wsi_record import WsiRecord


def _run(done_at, leased_at=None, seconds=10.0, device=None, spans=(), **kw):
    tiles = {}
    for i, t in enumerate(done_at):
        tiles[i] = Item(i, start=(leased_at[i] if leased_at else t - 1.0), done=t)
    own = WsiRecord(tile_shape=(4096, 4096), stage_ops={"segmentation": ["a", "b"], "features": ["c"]},
                    op_chunks=kw.pop("op_chunks", {}))
    base = dict(t_open=100.0, t_close=100.0 + seconds, wall_open=1000.0, setup_s=12.5, items=tiles,
                counters_open={"lane_busy": 5.0, "device_evictions": 70.0},
                counters_close={"lane_busy": 14.0, "device_evictions": 230.0},
                peak_bytes=3 << 30, window_peak_bytes=4 << 30,
                spans=list(spans), device=device, own=own)
    base.update(kw)
    return Run(**base)


def read(name, run):
    return load_module("metrics", name).read(run)


def test_rate_counts_only_the_window():
    # Window (100, 110]: completions at 100 (the opening tile), 100.5 ... 110, 110.5.
    run = _run([99.0, 100.0] + [100.5 * 1 + 0.5 * k for k in range(20)] + [110.5])
    assert len(run.done()) == 20
    assert read("tiles_per_s", run) == pytest.approx(2.0)
    # The tile that closes the window counts, whatever the rounding of its length.
    run = _run([100.0, 117.3], t_open=100.0, t_close=117.3)
    run.items[1].done = run.t_close
    assert len(run.done()) == 1 and run.seconds == pytest.approx(17.3)


def test_p80_over_every_tile():
    turn = [1.0 + 0.1 * k for k in range(10)]  # 1.0 .. 1.9
    done = [101.0 + k for k in range(10)]
    run = _run(done, [d - t for d, t in zip(done, turn)])
    assert read("tile_p80_s", run) == pytest.approx(1.7)   # rank ceil(8) of 10
    assert nearest_rank([5.0], 80) == 5.0
    assert nearest_rank(list(range(1, 101)), 80) == 80


def test_counters_and_setup():
    run = _run([101.0, 102.0, 103.0, 104.0])
    assert read("lane_busy_share", run) == pytest.approx(90.0)
    assert read("evictions_per_tile", run) == pytest.approx(40.0)
    assert read("setup_s", run) == 12.5
    assert read("peak_device_gib", run) == pytest.approx(3.0)


def test_stage_spans_per_tile():
    # Ops of the tiles completed in the window count (tiles 1, 2), by uid;
    # the warm-up tile 0's op and a lease span do not, whatever their clock.
    span = lambda name, uid, dur: {"name": name, "ts": 0.0, "dur": dur, "args": {"uid": uid}}  # noqa: E731
    spans = [span("op:a", 10, 0.25), span("op:b", 11, 0.5), span("op:c", 12, 0.125),
             span("op:a", 0, 9.0), {"name": "stage:lease", "ts": 1004.0, "dur": 1.0, "args": {}}]
    run = _run([99.0, 101.0, 102.0], spans=spans, op_chunks={0: 0, 10: 1, 11: 1, 12: 2})
    assert read("segmentation_s_per_tile", run) == pytest.approx(0.375)
    assert read("features_s_per_tile", run) == pytest.approx(0.0625)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (5.0, 5.0)]
    assert union_seconds(iv) == pytest.approx(3.0)
    assert gaps(iv, 0.0, 6.0) == [(2.0, 3.0), (4.0, 6.0)]
    assert union_seconds([]) == 0.0


def _trace(events, start=1000.0, end=1010.0):
    return DeviceTrace(start, end, [DeviceEvent(*e) for e in events])


def test_idle_share_and_copies():
    ev = [("kernel_a(int)", 1000.0, 4.0), ("Memcpy HtoD (Pageable -> Device)", 1003.0, 2.0),
          ("Memcpy DtoH (Device -> Pageable)", 1006.0, 0.5), ("Memset (Device)", 1009.5, 1.0)]
    run = _run([101.0, 102.0, 103.0, 104.0, 105.0], device=_trace(ev))
    # Busy: [1000, 1005] + [1006, 1006.5] + [1009.5, 1010] (clipped) = 6 s of 10.
    assert read("device_idle_share", run) == pytest.approx(40.0)
    assert read("copy_ms_per_tile", run) == pytest.approx(1e3 * 2.5 / 5)
    out = breakdown(run.device, [{"name": "op:watershed", "ts": 1007.0, "dur": 2.0}])
    assert out["device_ops"][0] == ["kernel_a(int)", 4.0]
    assert out["idle_gaps"][0] == ["op:watershed", pytest.approx(3.0)]
    assert out["idle_gaps"][1] == ["host between ops", pytest.approx(1.0)]


def test_roofline_bytes():
    px = 4096 * 4096
    t = least_seconds(12.0 * px, 10.0 * px)
    assert t == pytest.approx(12.0 * px / HBM_BYTES_PER_S)   # bytes bound morph_recon
    ev = [("morph_recon_kernel(Params)", 1000.0, 2 * t), ("morph_recon_kernel(Params)", 1001.0, 2 * t),
          ("void color_deconv_kernel<unsigned char>(...)", 1002.0, least_seconds(15.0 * px, 30.0 * px))]
    run = _run([101.0], device=_trace(ev))
    assert read("morph_recon_roofline", run) == pytest.approx(50.0)
    assert read("color_deconv_roofline", run) == pytest.approx(100.0)
    # A kernel the trace does not hold reads nothing, never 0.
    assert read("feature_fused_roofline", run) is None
    assert read("morph_recon_roofline", _run([101.0])) is None


def test_readers_find_nothing_without_a_trace():
    run = _run([101.0])
    for name in ("copy_ms_per_tile", "device_idle_share", "segmentation_s_per_tile"):
        assert read(name, run) is None
    assert read("tile_p80_s", _run([99.0])) is None
    assert not math.isnan(read("tiles_per_s", _run([99.0])))
