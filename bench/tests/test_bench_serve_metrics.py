"""The serving cells' metric arithmetic on hand-made records: rates and
tails over the window's requests only, the step times over the
window's batches, the kernels inside decode, the model FLOPs and the
rooflines' bytes; and nothing to read where a run holds nothing."""

import json

import pytest

from benchkit.flops import hybrid_forward_flops, hybrid_params
from benchkit.peaks import BF16_FLOPS, HBM_BYTES_PER_S, least_seconds, roofline_share_per_launch
from benchkit.record import Item, Run
from benchkit.spec import BENCH, load_reader
from benchkit.trace import DeviceEvent, DeviceTrace
from kinds.serve import Batch, ServeRecord, window_batches

CFG = json.loads((BENCH / "configs" / "zamba2-1.2b.json").read_text())
PLEN, NEW, B = 1024, 128, 2


def _run(device=None):
    # Window (100, 130] on the driver's clock, wall 1000-1030. Batch 0 is
    # the warm-up (done at the opening), 1 and 2 are the window's, 3 ends
    # after it.
    own = ServeRecord(model=CFG, prompt_len=PLEN, batch_size=B, ssd_chunk=128)
    items = {}
    for i, (admit, first, done) in enumerate([(88.0, 89.0, 100.0), (100.0, 101.0, 114.0),
                                              (114.0, 115.5, 130.0), (130.0, 131.0, 145.0)]):
        own.batches.append(Batch(i, [2 * i, 2 * i + 1], admit, first, done, NEW - 1))
        for rid in (2 * i, 2 * i + 1):
            items[rid] = Item(rid, admit, done)
            own.first[rid] = first + 0.1 * (rid % 2)
            own.tokens[rid] = NEW
    return Run(t_open=100.0, t_close=130.0, wall_open=1000.0, setup_s=7.0, items=items,
               counters_open={}, counters_close={}, peak_bytes=5 << 30, window_peak_bytes=5 << 30,
               device=device, own=own)


def read(name, run):
    return load_reader(name)(run)


def test_rate_and_tail_over_the_window_requests():
    run = _run()
    assert [b.index for b in window_batches(run)] == [1, 2]
    assert read("output_tokens_per_s", run) == pytest.approx(4 * NEW / 30.0)
    # TTFTs 1.0, 1.1, 1.5, 1.6: the 80th percentile by nearest rank is the 4th.
    assert read("ttft_p80_s", run) == pytest.approx(1.6)
    assert read("prefill_s_per_batch", run) == pytest.approx((1.0 + 1.5) / 2)
    assert read("decode_step_ms", run) == pytest.approx(1e3 * (13.0 + 14.5) / (2 * (NEW - 1)))
    assert read("peak_device_gib", run) == pytest.approx(5.0)
    assert read("setup_s", run) == 7.0


def _trace(events, start=1000.0, end=1030.0):
    return DeviceTrace(start, end, [DeviceEvent(n, s, d) for n, s, d in events])


def test_kernels_inside_decode_steps():
    ev = [("gemm", 1000.5, 0.01),                       # batch 1's prefill: not decode
          *[("k", 1001.5 + 0.1 * i, 0.01) for i in range(20)],  # batch 1's decode
          ("Memcpy DtoH (Device -> Pageable)", 1002.0, 0.001),  # a copy is no kernel
          *[("k", 1016.0 + 0.1 * i, 0.01) for i in range(30)]]  # batch 2's decode
    run = _run(_trace(ev))
    assert read("decode_kernels_per_step", run) == pytest.approx(50 / (2 * (NEW - 1)))
    assert read("decode_kernels_per_step", _run()) is None


def test_mfu_counts_the_window_batches():
    run = _run(_trace([("k", 1000.0, 1.0)]))
    per_seq = hybrid_forward_flops(CFG, 0, PLEN, 1) + sum(
        hybrid_forward_flops(CFG, PLEN - 1 + s, PLEN + s, 1) for s in range(1, NEW))
    assert read("serve_mfu", run) == pytest.approx(100.0 * 4 * per_seq / 30.0 / BF16_FLOPS)
    assert read("serve_mfu", _run()) is None


def test_model_flops():
    k = hybrid_params(CFG)
    assert k["applications"] == 6 and k["layers"] == 38
    # 1.17e9 parameters in all, 65.5e6 in the embedding.
    total = k["layers"] * k["mamba_layer"] + k["shared"] + k["head"] + 32000 * 2048
    assert total == pytest.approx(1.17e9, rel=0.01)
    one = hybrid_forward_flops(CFG, 10, 11, 1)
    assert one == 2 * (38 * k["mamba_layer"] + 6 * k["shared"]) + 4 * 6 * 64 * 32 * 11 + 2 * k["head"]
    # Positions add up: a prefill is the sum of its positions.
    assert hybrid_forward_flops(CFG, 0, 8, 0) == sum(hybrid_forward_flops(CFG, p, p + 1, 0) for p in range(8))


def test_rooflines_per_launch_and_per_shape():
    apps = 6
    sizes = []
    for _ in range(2):
        for step in range(1, NEW):
            valid = PLEN + step
            sizes += [(2.0 * B * (2 * 32 * valid * 64 + 2 * 32 * 64) + 4.0 * B,
                       4.0 * B * 32 * valid * 64)] * apps
    t = [least_seconds(b, f, BF16_FLOPS) for b, f in sizes]
    assert t[0] == pytest.approx(sizes[0][0] / HBM_BYTES_PER_S)  # the bytes bound it
    ev = [("void decode_tc_kernel<64>(...)", 1001.0 + 1e-3 * i, 2 * ti) for i, ti in enumerate(t)]
    run = _run(_trace(ev))
    assert read("decode_attention_roofline", run) == pytest.approx(50.0)
    # Another number of launches than steps reads nothing, never 0.
    assert roofline_share_per_launch(run, "decode_tc_kernel", sizes[:-1], BF16_FLOPS) is None
    assert read("decode_attention_roofline", _run(_trace(ev[:-1]))) is None
    rows, elems, chunks = B * 4096 // 64, 64 * 64, PLEN // 128
    nbytes = 4.0 * (chunks * rows + 2 * chunks * rows * elems + rows * elems)
    scan = [("void (anonymous namespace)::mamba2_scan_kernel<float>(...)", 1000.2, nbytes / HBM_BYTES_PER_S)]
    assert read("mamba2_scan_roofline", _run(_trace(scan))) == pytest.approx(100.0)
    assert read("mamba2_scan_roofline", _run(_trace([("k", 1000.0, 1.0)]))) is None


def test_idle_share_of_the_serving_cells():
    run = _run(_trace([("k", 1000.0, 3.0), ("k", 1010.0, 3.0)]))
    assert read("device_idle_share.serve", run) == pytest.approx(80.0)
    assert read("device_idle_share.serve", _run()) is None
