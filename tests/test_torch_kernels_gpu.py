"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Every test carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is False (decided inside the test).

This file imports neither JAX nor the JAX package, so it also runs on
a machine with a card and no JAX; there the repository's
``conftest.py`` (which imports JAX) is skipped:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import feature_fused as FF
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import morph_recon as MR
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sobel_stats as SS

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _device_kernel_names(fn, calls: int = 3, tries: int = 3) -> list[str]:
    """Names of the device kernels ``calls`` calls of ``fn`` run, from
    ``torch.profiler``: the fullest of ``tries`` sessions. The profiler
    drops a kernel's record now and then, mostly the first of a session,
    and never adds one: a marker kernel (``torch.cuda._sleep``'s
    ``spin_kernel``) runs first and last in each session and is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def session(body):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            body()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]

    def body():
        for _ in range(calls):
            fn()

    return max(([n for n in session(body) if "spin_kernel" not in n] for _ in range(tries)),
               key=len)


def _planes(h, w, dtype, rng):
    mk = lambda: (  # noqa: E731
        rng.integers(0, 256, (h, w)).astype(dtype)
        if dtype == np.uint8
        else rng.uniform(0, 255, (h, w)).astype(dtype)
    )
    return mk(), mk(), mk()


@pytest.mark.parametrize("hw", [(128, 128), (1000, 1500), (4096, 4096)])
@pytest.mark.parametrize("layout", ["planes_u8", "planes_f32", "interleaved_u8", "crop_u8"])
def test_cuda_color_deconv_and_feature_fused(hw, layout):
    dev = _cuda()
    rng = np.random.default_rng(7)
    if layout == "interleaved_u8":
        rgb = torch.as_tensor(rng.integers(0, 256, (*hw, 3)).astype(np.uint8), device=dev)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        # 16-byte aligned rows take the fast path (1500 px: 4500-byte rows do not)
        assert FF.interleaved(r, g, b) == (hw[1] % 16 == 0)
    elif layout == "crop_u8":  # a crop of a larger HWC tile: unaligned, row stride 3(W+1)
        big = rng.integers(0, 256, (hw[0] + 1, hw[1] + 1, 3)).astype(np.uint8)
        rgb = torch.as_tensor(big, device=dev)[1:, 1:]
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        assert not FF.interleaved(r, g, b)
    else:
        dtype = np.uint8 if layout == "planes_u8" else np.float32
        r, g, b = (torch.as_tensor(p, device=dev) for p in _planes(*hw, dtype, rng))
    ops.reset_launch_counts()
    for got, want in zip(ops.color_deconv(r, g, b), ref.color_deconv_ref(r, g, b)):
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
    got, want = ops.feature_fused(r, g, b), ref.feature_fused_ref(r, g, b)
    for gp, wp in zip(got[:3], want[:3]):
        torch.testing.assert_close(gp, wp, rtol=3e-5, atol=1e-4)
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0.0)
    assert ops.launch_counts()["color_deconv"] == 1
    assert ops.launch_counts()["feature_fused"] == 1
    assert FF.last_plan == FF.plan(*hw, torch.cuda.get_device_properties(dev).multi_processor_count)


@pytest.mark.parametrize("hw", [(128, 128), (192, 384), (1000, 1500)])
def test_cuda_morph_recon(hw):
    dev = _cuda()
    rng = np.random.default_rng(3)
    mask = rng.uniform(0, 255, hw).astype(np.float32)
    marker = np.maximum(mask - 55.0, 0.0) * (rng.uniform(0, 1, hw) > 0.6)
    marker = torch.as_tensor(marker.astype(np.float32), device=dev)
    mask = torch.as_tensor(mask, device=dev)
    ops.reset_launch_counts()
    got = ops.morph_recon(marker, mask)
    assert ops.launch_counts()["morph_recon"] == 1  # one launch per reconstruction
    assert torch.equal(got, ref.morph_recon_ref(marker, mask))


# Inputs of the reconstruction at the kernel's sizes (the CPU model of its
# schedule, tests/test_torch_morph_recon_schedule.py, takes them small).


def _recon_random(h, w):
    rng = np.random.default_rng(h + w)
    mask = rng.uniform(0, 255, (h, w)).astype(np.float32)
    marker = np.maximum(mask - 55.0, 0.0) * (rng.uniform(0, 1, (h, w)) > 0.6)
    return marker.astype(np.float32), mask


def _recon_snake(h, w):
    """A one-pixel serpentine path: lines every h/8 rows joined at
    alternate ends, crossing tile borders all along its length."""
    gap = max(2, h // 8)
    mask = np.zeros((h, w), np.float32)
    rows = list(range(0, h, gap))
    for i, r in enumerate(rows):
        mask[r, :] = 200.0
        if i + 1 < len(rows):
            mask[r:rows[i + 1] + 1, w - 1 if i % 2 == 0 else 0] = 200.0
    marker = np.zeros_like(mask)
    marker[0, 0] = 255.0
    return marker, mask


def _recon_staircase(h, w):
    """(i, 2i), (i, 2i + 1): every 32 rows the path steps from one 32x64
    tile's bottom-right corner pixel to the next tile's top-left one."""
    mask = np.zeros((h, w), np.float32)
    i = np.arange(min(h, w // 2))
    mask[i, 2 * i] = mask[i, 2 * i + 1] = 150.0
    marker = np.zeros_like(mask)
    marker[0, 0] = 150.0
    return marker, mask


def _recon_fill_holes(h, w):
    """fill_holes' input: the background flooded from a 255 frame, with
    square rings of objects enclosing holes."""
    rng = np.random.default_rng(h * w)
    obj = np.zeros((h, w), bool)
    for _ in range(h * w // 4000):
        y, x = int(rng.integers(0, h - 40)), int(rng.integers(0, w - 40))
        s = int(rng.integers(6, 40))
        obj[y:y + s, x:x + s] = True
        obj[y + 2:y + s - 2, x + 2:x + s - 2] = False
    inv = (~obj).astype(np.float32) * 255.0
    border = np.zeros((h, w), np.float32)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = 255.0
    return np.minimum(border, inv), inv


def _recon_constant(h, w):
    return np.full((h, w), 7.0, np.float32), np.full((h, w), 7.0, np.float32)


_RECON_INPUTS = {"random": _recon_random, "snake": _recon_snake,
                 "staircase": _recon_staircase, "fill_holes": _recon_fill_holes,
                 "constant": _recon_constant}


@pytest.mark.parametrize("name", list(_RECON_INPUTS))
@pytest.mark.parametrize("hw", [(1000, 1500), (4096, 4096)])
def test_cuda_morph_recon_bit_identical(name, hw):
    """One launch, bit-identical to the plain version, whatever order
    the blocks visit the tiles in; the kernel's rounds and tile visits."""
    dev = _cuda()
    marker, mask = (torch.as_tensor(a, device=dev) for a in _RECON_INPUTS[name](*hw))
    ops.reset_launch_counts()
    got = ops.morph_recon(marker, mask)
    assert ops.launch_counts()["morph_recon"] == 1
    assert torch.equal(got, ref.morph_recon_ref(marker, mask))
    rounds, visits, sweeps = MR.last_stats.tolist()
    n_tiles = -(-hw[0] // MR.TILE_H) * -(-hw[1] // MR.TILE_W)
    assert rounds >= 1 and n_tiles <= visits <= rounds * n_tiles
    assert visits <= sweeps <= MR.MAX_SWEEPS * visits
    if name == "constant":
        assert (rounds, visits, sweeps) == (1, n_tiles, n_tiles)


@pytest.mark.parametrize("hw", [(1, 4096), (4096, 1), (1, 1500), (1000, 1), (33, 65)])
def test_cuda_morph_recon_thin_and_ragged(hw):
    dev = _cuda()
    marker, mask = (torch.as_tensor(a, device=dev) for a in _recon_random(*hw))
    assert torch.equal(ops.morph_recon(marker, mask), ref.morph_recon_ref(marker, mask))


def test_cuda_morph_recon_makes_no_host_sync():
    """The wrapper issues one launch and returns: under the sync debug
    mode "error" any synchronising call would raise."""
    dev = _cuda()
    marker, mask = (torch.as_tensor(a, device=dev) for a in _recon_fill_holes(1000, 1500))
    want = ref.morph_recon_ref(marker, mask)
    ops.morph_recon(marker, mask)  # builds and loads the kernel first
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.morph_recon(marker, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.launch_counts()["morph_recon"] == 1
    assert torch.equal(got, want)


def test_cuda_morph_recon_step_keeps_its_meaning():
    """``morph_recon_step`` is one round: ``(out, changed)`` with
    ``changed`` nonzero unless ``min(marker, mask)`` is already the
    fixpoint; stepping until it is 0 gives the reconstruction."""
    dev = _cuda()
    marker, mask = (torch.as_tensor(a, device=dev) for a in _recon_random(300, 500))
    want = ref.morph_recon_ref(marker, mask)
    ops.reset_launch_counts()
    cur, changed = MR.morph_recon_step(marker, mask)
    assert changed.device == dev and changed.dtype == torch.int32 and changed.shape == (1,)
    assert int(changed.item()) != 0
    steps = 1
    while int(changed.item()):
        cur, changed = MR.morph_recon_step(cur, mask)
        steps += 1
    assert torch.equal(cur, want)
    assert ops.launch_counts()["morph_recon"] == steps
    const = torch.full((64, 128), 3.0, device=dev)
    out, changed = MR.morph_recon_step(const, const)
    assert int(changed.item()) == 0 and torch.equal(out, const)
    with pytest.raises(ValueError, match="alias"):
        MR.morph_recon_step(marker, mask, out=marker)


@pytest.mark.parametrize("hw", [(128, 128), (1000, 1500), (4096, 4096)])
def test_cuda_sobel_stats(hw):
    dev = _cuda()
    rng = np.random.default_rng(5)
    gray = torch.as_tensor(rng.uniform(0, 255, hw).astype(np.float32), device=dev)
    ops.reset_launch_counts()
    mag, stats = ops.sobel_stats(gray)
    want_mag, want_stats = ref.sobel_stats_ref(gray)
    torch.testing.assert_close(mag, want_mag, rtol=0.0, atol=0.0)  # same arithmetic
    torch.testing.assert_close(stats, want_stats, rtol=1e-4, atol=0.0)  # sum order
    assert ops.launch_counts()["sobel_stats"] == 1


@pytest.mark.parametrize("view", ["contiguous", "transposed", "column_crop", "row_strided"])
def test_cuda_sobel_stats_views(view):
    """float32 planes the fast path takes (contiguous, 16-byte aligned
    rows) and those it leaves to the strided path; mag bit-equal."""
    dev = _cuda()
    base = torch.as_tensor(np.random.default_rng(6).uniform(0, 255, (1002, 1504))
                           .astype(np.float32), device=dev)
    gray = {"contiguous": base[:1000, :1500], "transposed": base.t().contiguous().t()[:1000],
            "column_crop": base[1:, 1:], "row_strided": base[::2]}[view]
    assert SS.rows_aligned(gray) == (view in ("contiguous", "row_strided"))
    mag, stats = ops.sobel_stats(gray)
    want_mag, want_stats = ref.sobel_stats_ref(gray)
    torch.testing.assert_close(mag, want_mag, rtol=0.0, atol=0.0)
    torch.testing.assert_close(stats, want_stats, rtol=1e-4, atol=0.0)


def _stencil_case(kernel, dev, hw=(4096, 4096), layout="fast", seed=12):
    """A call of ``kernel`` ("feature_fused" or "sobel_stats") on seeded
    inputs: the fast path's layout (a contiguous HWC tile; a plane whose
    rows start 16-byte aligned, 4-float padded), or the generic one (a
    crop of an HWC tile; the plane's view 4 bytes in)."""
    rng = np.random.default_rng(seed)
    if kernel == "feature_fused":
        big = torch.as_tensor(rng.integers(0, 256, (hw[0] + 1, hw[1] + 1, 3)).astype(np.uint8),
                              device=dev)
        rgb = big[:-1, :-1].contiguous() if layout == "fast" else big[1:, 1:]
        args = (rgb[..., 0], rgb[..., 1], rgb[..., 2])
        assert FF.interleaved(*args) == (layout == "fast")
        return lambda: ops.feature_fused(*args), lambda: ref.feature_fused_ref(*args)
    pitch = -(-(hw[1] + 1) // 4) * 4  # rows of 16-byte multiples
    gray = torch.as_tensor(rng.uniform(0, 255, (hw[0], pitch)).astype(np.float32), device=dev)
    gray = gray[:, :hw[1]] if layout == "fast" else gray[:, 1:hw[1] + 1]  # or 4 bytes in
    assert SS.rows_aligned(gray) == (layout == "fast")
    return lambda: ops.sobel_stats(gray), lambda: ref.sobel_stats_ref(gray)


def _check_stencil(got, want):
    """The tolerances of the kernel tests above: planes rtol 3e-5, atol
    1e-4 (sobel_stats' mag bit for bit), moments rtol 1e-4."""
    for gp, wp in zip(got[:-1], want[:-1]):
        if len(got) == 2:
            torch.testing.assert_close(gp, wp, rtol=0.0, atol=0.0)
        else:
            torch.testing.assert_close(gp, wp, rtol=3e-5, atol=1e-4)
    torch.testing.assert_close(got[-1], want[-1], rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("layout", ["fast", "generic"])
@pytest.mark.parametrize("kernel", ["feature_fused", "sobel_stats"])
def test_cuda_stencil_one_device_launch_per_call(kernel, layout):
    """The blocks' moments merge inside the one launch: the profiler sees
    a single device kernel per call (the workspace is made once)."""
    dev = _cuda()
    call, _ = _stencil_case(kernel, dev, layout=layout)
    call()  # builds the kernel, makes the workspace
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    names = _device_kernel_names(call)
    assert ops.launch_counts()[kernel] == 9
    assert len(names) == 3 and all(f"{kernel}_kernel<" in n for n in names), names


@pytest.mark.parametrize("layout", ["fast", "generic"])
@pytest.mark.parametrize("kernel", ["feature_fused", "sobel_stats"])
def test_cuda_stencil_back_to_back_calls_are_bit_equal(kernel, layout):
    """The partial rows merge in block order, whichever block arrives
    last: repeated calls give the same bits."""
    dev = _cuda()
    call, plain = _stencil_case(kernel, dev, layout=layout)
    first = call()
    for _ in range(5):
        again = call()
        for a, b in zip(again, first):
            assert torch.equal(a, b)
    _check_stencil(first, plain())


@pytest.mark.parametrize("kernel", ["feature_fused", "sobel_stats"])
def test_cuda_stencil_alternating_shapes_on_one_stream(kernel):
    """Calls of different shapes share the stream's workspace: each
    launch leaves its counter 0 for the next, and the 4096x4096 call
    grows the partials."""
    dev = _cuda()
    cases = [_stencil_case(kernel, dev, hw, layout, seed)
             for hw, layout, seed in (((130, 257), "generic", 1), ((4096, 4096), "fast", 2),
                                      ((3, 304), "fast", 3), ((1, 300), "generic", 4),
                                      ((1000, 1500), "generic", 5))]
    firsts = [call() for call, _ in cases]
    for (_, plain), first in zip(cases, firsts):
        _check_stencil(first, plain())
    for _ in range(2):
        for (call, _), first in zip(cases, firsts):
            for a, b in zip(call(), first):
                assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["feature_fused", "sobel_stats"])
def test_cuda_stencil_call_is_captured_in_a_cuda_graph(kernel):
    """The wrapper allocates its outputs, launches once and waits on
    nothing, so a call can be captured in a CUDA graph; replays give the
    eager call's bits."""
    dev = _cuda()
    call, plain = _stencil_case(kernel, dev, (1000, 1504), "fast")
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        eager = call()  # builds, makes the side stream's workspace
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b)
    _check_stencil(captured, plain())


def _qkv(shape_q, shape_kv, dtype, dev, rng):
    mk = lambda s: torch.as_tensor(rng.normal(0, 1, s).astype(np.float32),  # noqa: E731
                                   device=dev).to(dtype)
    return mk(shape_q), mk(shape_kv), mk(shape_kv)


# bfloat16 outputs: one bfloat16 ulp (2**-8 relative) of rounding apart;
# float32: summation order only.
_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("b,h,hkv,s,d", [(4, 32, 32, 1024, 64), (2, 8, 2, 1000, 64),
                                         (1, 4, 4, 15, 64), (1, 2, 1, 129, 128),
                                         (2, 4, 4, 77, 32), (1, 32, 8, 1024, 128),
                                         (1, 4, 2, 1, 64), (1, 4, 2, 16, 64),
                                         (1, 4, 2, 63, 64), (1, 4, 2, 65, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_attention(b, h, hkv, s, d, causal, dtype):
    dev = _cuda()
    q, k, v = _qkv((b, h, s, d), (b, hkv, s, d), dtype, dev, np.random.default_rng(s))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal)
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal), **_TOL[dtype])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_bf16_peaked_scores(d, causal):
    """q scaled by 8: scores of standard deviation 8, so the running max
    moves by many units between KV blocks and most of P rounds to 0."""
    dev = _cuda()
    q, k, v = _qkv((2, 4, 1000, d), (2, 2, 1000, d), torch.float32, dev,
                   np.random.default_rng(d))
    q, k, v = (q * 8).bfloat16(), k.bfloat16(), v.bfloat16()
    got = ops.flash_attention(q, k, v, causal)
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal),
                               **_TOL[torch.bfloat16])


def test_cuda_flash_attention_bf16_misaligned_raises():
    """The bfloat16 kernel copies 16-byte chunks: a tensor that starts
    one element into its storage is refused, not read."""
    dev = _cuda()
    shape = (1, 2, 64, 64)
    q = torch.zeros(int(np.prod(shape)) + 1, dtype=torch.bfloat16, device=dev)[1:].view(shape)
    k = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    assert q.is_contiguous() and q.data_ptr() % 16
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(q, k, k, True)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(k, q, k, True)
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("b,h,hkv,s,d", [(2, 4, 2, 1000, 64), (1, 4, 2, 200, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_f32_peaked_scores(b, h, hkv, s, d, causal):
    """q scaled by 8 in float32: the running max moves by many units
    between KV tiles, and the three-pass TF32 products must hold the
    float32 bar. The scores' float32 rounding alone then moves the output
    by ~1e-5: at D=128 over 1000 keys the plain version is itself 0.9-1.2
    of the bar from exact attention (benchmarks/torch_flash_f32_ab.py), so
    D=128 takes the CPU model's 200 keys here, and 1000 keys against exact
    attention below."""
    dev = _cuda()
    q, k, v = _qkv((b, h, s, d), (b, hkv, s, d), torch.float32, dev, np.random.default_rng(d))
    q = q * 8
    out, lse = FA.flash_attention_cuda(q, k, v, causal, return_lse=True)
    want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal)
    torch.testing.assert_close(out, want_out, **_TOL[torch.float32])
    torch.testing.assert_close(lse, want_lse, **_TOL[torch.float32])
    torch.testing.assert_close(ops.flash_attention(q, k, v, causal), want_out,
                               **_TOL[torch.float32])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_f32_peaked_scores_against_exact(d, causal):
    """q scaled by 8 over 1000 keys, held at the float32 bar to exact
    attention (float64 on the card). At D=128 the plain float32 version is
    itself ~0.9-1.2 of that bar from exact, so the kernel is held to exact
    there rather than to it."""
    dev = _cuda()
    q, k, v = _qkv((2, 4, 1000, d), (2, 2, 1000, d), torch.float32, dev,
                   np.random.default_rng(d + 1))
    q = q * 8
    kd, vd = (t.double().repeat_interleave(2, 1) for t in (k, v))
    s = q.double() @ kd.transpose(-1, -2) / d ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(1000, 1000, dtype=torch.bool, device=dev).triu(1),
                          float("-inf"))
    exact = torch.softmax(s, -1) @ vd
    torch.testing.assert_close(FA.flash_attention_cuda(q, k, v, causal).double(), exact,
                               **_TOL[torch.float32])


@pytest.mark.parametrize("b,h,hkv,s,d", [(1, 4, 4, 15, 64), (1, 2, 1, 129, 128),
                                         (2, 4, 4, 77, 32), (2, 8, 2, 1000, 64),
                                         (1, 4, 2, 1, 64), (1, 8, 2, 300, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_f32_lse(b, h, hkv, s, d, causal):
    """The float32 forward with its log-sum-exp (the instantiation that
    training runs) against ``flash_attention_fwd_ref`` at 2e-5, out and
    lse; its out is the bits of the call without lse."""
    dev = _cuda()
    q, k, v = _qkv((b, h, s, d), (b, hkv, s, d), torch.float32, dev,
                   np.random.default_rng(s + d))
    out, lse = FA.flash_attention_cuda(q, k, v, causal, return_lse=True)
    want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    torch.testing.assert_close(out, want_out, **_TOL[torch.float32])
    torch.testing.assert_close(lse, want_lse, **_TOL[torch.float32])
    assert torch.equal(out, FA.flash_attention_cuda(q, k, v, causal))


@pytest.mark.parametrize("d", [32, 64, 128])
def test_cuda_flash_attention_f32_is_bit_equal_on_repeat(d):
    """Two calls give the same bits, each one launch of the three-pass
    TF32 kernel (the CUDA-core float32 forward is gone)."""
    dev = _cuda()
    q, k, v = _qkv((2, 8, 333, d), (2, 2, 333, d), torch.float32, dev,
                   np.random.default_rng(d))
    first = FA.flash_attention_cuda(q, k, v, True, return_lse=True)
    again = FA.flash_attention_cuda(q, k, v, True, return_lse=True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    names = _device_kernel_names(lambda: FA.flash_attention_cuda(q, k, v, True))
    assert len(names) == 3 and all("flash_f32_kernel" in n for n in names), names


def test_cuda_flash_attention_f32_misaligned_raises():
    """The float32 kernel also copies 16-byte chunks: a float32 tensor
    that starts one element into its storage is refused, not read."""
    dev = _cuda()
    shape = (1, 2, 64, 64)
    q = torch.zeros(int(np.prod(shape)) + 1, dtype=torch.float32, device=dev)[1:].view(shape)
    k = torch.zeros(shape, dtype=torch.float32, device=dev)
    assert q.is_contiguous() and q.data_ptr() % 16
    ops.reset_launch_counts()
    for args in ((q, k, k), (k, q, k), (k, k, q)):
        with pytest.raises(ValueError, match="aligned"):
            ops.flash_attention(*args, True)
    assert ops.launch_counts()["flash_attention"] == 0


def _decode_want(q, k, v, lens):
    """The plain version, with zeros where a length is 0 (the plain
    softmax over no key gives NaN there; the kernel, like the TPU
    kernel, gives zeros)."""
    want = ref.decode_attention_ref(q, k, v, lens)
    return torch.where((lens > 0)[:, None, None].to(want.device), want, torch.zeros_like(want))


@pytest.mark.parametrize("b,hq,hkv,s,d,lengths", [
    (4, 32, 32, 2048, 64, [2048, 1025, 700, 1]),
    (3, 8, 2, 512, 64, [512, 171, 1]),
    (2, 16, 8, 1000, 128, [1000, 999]),
    (2, 4, 4, 77, 32, [1, 77]),
    (2, 32, 8, 16384, 128, [16384, 4097]),       # group 4 (mistral-nemo-12b), long
    (2, 40, 8, 3000, 128, [3000, 1234]),         # group 5
    (2, 40, 10, 3000, 128, [2999, 3000]),        # group 4 (phi3-medium-14b)
    (2, 56, 8, 5000, 128, [5000, 2049]),         # group 7 (yi-34b)
    (4, 8, 2, 600, 64, [0, 1, 600, 77]),         # lengths 0, 1, S, inside a tile
    (3, 12, 4, 333, 32, [333, 0, 17]),
    (2, 24, 2, 700, 64, [700, 300]),             # group 12: two chunks of 8 heads
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_decode_attention(b, hq, hkv, s, d, lengths, dtype):
    dev = _cuda()
    q, k, v = _qkv((b, hq, d), (b, hkv, s, d), dtype, dev, np.random.default_rng(s))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    got = ops.decode_attention(q, k, v, lens)
    assert ops.launch_counts()["decode_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got, _decode_want(q, k, v, lens), **_TOL[dtype])


def test_cuda_decode_attention_length_zero_gives_zeros():
    dev = _cuda()
    q, k, v = _qkv((2, 4, 64), (2, 4, 300, 64), torch.float32, dev, np.random.default_rng(0))
    lens = torch.tensor([0, 300], dtype=torch.int32, device=dev)
    got = ops.decode_attention(q, k, v, lens)
    assert bool((got[0] == 0).all())
    torch.testing.assert_close(got[1:], ref.decode_attention_ref(q[1:], k[1:], v[1:], lens[1:]),
                               **_TOL[torch.float32])


def test_cuda_decode_attention_clamps_lengths():
    """A length past S attends to all of S; a negative one gives zeros."""
    dev = _cuda()
    q, k, v = _qkv((2, 8, 128), (2, 2, 1000, 128), torch.bfloat16, dev, np.random.default_rng(1))
    got = ops.decode_attention(q, k, v, torch.tensor([1500, -4], dtype=torch.int32, device=dev))
    want = ref.decode_attention_ref(q, k, v, torch.tensor([1000, 1], dtype=torch.int32,
                                                          device=dev))
    torch.testing.assert_close(got[0], want[0], **_TOL[torch.bfloat16])
    assert bool((got[1] == 0).all())


# The log-sum-exp of the scaled scores: float32 sums in another order
# than the plain version's, and ex2.approx (2**-22 relative) per key.
_DECODE_LSE_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,hq,hkv,s,d,lengths", [
    (4, 8, 2, 600, 64, [0, 1, 600, 77]),          # length 0: out 0, lse -inf
    (1, 32, 32, 262144, 64, [200000]),            # a long-context rank's chunk, many splits
    (2, 32, 8, 16384, 128, [16384, 4097]),        # group 4, two head chunks in float32
    (2, 24, 2, 700, 64, [700, 300]),              # group 12
    (3, 4, 4, 77, 32, [1, 77, 40]),               # one split
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_decode_attention_lse(b, hq, hkv, s, d, lengths, dtype):
    """``return_lse``: the same launch writes each row's log-sum-exp
    beside ``out``; ``out`` is bit-equal to the call without it, and
    both match the plain version's (out, lse)."""
    dev = _cuda()
    q, k, v = _qkv((b, hq, d), (b, hkv, s, d), dtype, dev, np.random.default_rng(s + b))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    plain = ops.decode_attention(q, k, v, lens)
    ops.reset_launch_counts()
    out, lse = ops.decode_attention(q, k, v, lens, return_lse=True)
    assert ops.launch_counts()["decode_attention"] == 1
    assert lse.dtype == torch.float32 and lse.shape == (b, hq)
    assert torch.equal(out, plain)
    want_out, want_lse = ref.decode_attention_ref(q, k, v, lens, return_lse=True)
    torch.testing.assert_close(out, want_out, **_TOL[dtype])
    empty = (lens <= 0)[:, None].expand_as(want_lse)
    assert bool(torch.isneginf(lse[empty]).all())
    torch.testing.assert_close(lse[~empty], want_lse[~empty], **_DECODE_LSE_TOL)


def _decode_case(dev, dtype=torch.bfloat16):
    q, k, v = _qkv((4, 32, 128), (4, 8, 8192, 128), dtype, dev, np.random.default_rng(8))
    lens = torch.tensor([8192, 4500, 2049, 1], dtype=torch.int32, device=dev)
    return q, k, v, lens


def test_cuda_decode_attention_one_device_launch_per_call():
    """The splits are combined inside the one launch: the profiler sees
    a single device kernel per call (the workspace is made once)."""
    dev = _cuda()
    q, k, v, lens = _decode_case(dev)
    ops.decode_attention(q, k, v, lens)  # builds the kernel, makes the workspace
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    names = _device_kernel_names(lambda: ops.decode_attention(q, k, v, lens))
    assert ops.launch_counts()["decode_attention"] == 9
    assert len(names) == 3 and all(re.search(r"decode_(tc_)?kernel<", n) for n in names), names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_decode_attention_back_to_back_calls_are_bit_equal(dtype):
    """The splits merge in split order, whichever block arrives last."""
    dev = _cuda()
    q, k, v, lens = _decode_case(dev, dtype)
    first = ops.decode_attention(q, k, v, lens)
    for _ in range(5):
        assert torch.equal(ops.decode_attention(q, k, v, lens), first)
    torch.testing.assert_close(first, _decode_want(q, k, v, lens), **_TOL[dtype])


def test_cuda_decode_attention_alternating_shapes_on_one_stream():
    """Calls of different shapes share the stream's workspace: each
    launch leaves its counters 0 for the next, and a larger shape grows
    the workspace."""
    dev = _cuda()
    cases = [_decode_case(dev)]
    for b, hq, hkv, s, d, lengths in ((4, 32, 32, 2048, 64, [2048, 1025, 700, 1]),
                                      (2, 56, 8, 20000, 128, [20000, 15000])):
        q, k, v = _qkv((b, hq, d), (b, hkv, s, d), torch.bfloat16, dev,
                       np.random.default_rng(s))
        cases.append((q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)))
    firsts = [ops.decode_attention(*c) for c in cases]
    for c, first in zip(cases, firsts):
        torch.testing.assert_close(first, _decode_want(*c), **_TOL[torch.bfloat16])
    for _ in range(3):
        for c, first in zip(cases, firsts):
            assert torch.equal(ops.decode_attention(*c), first)


def test_cuda_decode_attention_makes_no_host_sync():
    """The wrapper reads no length and waits on nothing: under the sync
    debug mode "error" any synchronising call would raise."""
    dev = _cuda()
    q, k, v, lens = _decode_case(dev)
    want = ops.decode_attention(q, k, v, lens)  # builds, makes the workspace
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.decode_attention(q, k, v, lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.launch_counts()["decode_attention"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("c,h,f", [(8, 256, 4096), (3, 5, 7), (1, 16, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mamba2_chunk_scan(c, h, f, dtype):
    dev = _cuda()
    rng = np.random.default_rng(c * h)
    decay = torch.as_tensor(rng.uniform(0.3, 1.0, (c, h)).astype(np.float32), device=dev)
    inc = torch.as_tensor(rng.normal(0, 1, (c, h, f)).astype(np.float32), device=dev).to(dtype)
    ops.reset_launch_counts()
    states, final = ops.mamba2_chunk_scan(decay, inc)
    assert ops.launch_counts()["mamba2_chunk_scan"] == 1
    ws, wf = ref.mamba2_chunk_scan_ref(decay, inc)
    torch.testing.assert_close(states, ws, rtol=0.0, atol=0.0)  # same rounded mul, add
    torch.testing.assert_close(final, wf, rtol=0.0, atol=0.0)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen1.5-4b"])
def test_cuda_smoke_model_matches_cpu_float32(arch):
    """A smoke model in float32 on the card (kernels) and on the CPU
    (plain versions), same weights: prefill + 2 decode steps at 1e-3
    (float32 with TF32 off; the attention and SSD sums run in another
    order on the card)."""
    dev = _cuda()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = build_model(get_smoke_config(arch), device="cpu", seed=0).float()
    card = build_model(get_smoke_config(arch), device="cpu", seed=0).float().to(dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 512, (2, 24)))
    ops.reset_launch_counts()
    lc, cc = cpu.prefill({"tokens": toks[:, :16]}, 32)
    lg, cg = card.prefill({"tokens": toks[:, :16].to(dev)}, 32)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    for i in range(2):
        pos = torch.full((2,), 16 + i, dtype=torch.int32)
        lc, cc = cpu.decode_step(cc, toks[:, 16 + i], pos)
        lg, cg = card.decode_step(cg, toks[:, 16 + i].to(dev), pos.to(dev))
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    counts = ops.launch_counts()
    assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0
    if arch == "zamba2-1.2b":
        assert counts["mamba2_chunk_scan"] > 0


# --------------------------------------------------------------------------
# backward kernels (training): quick loop `-k backward`
# --------------------------------------------------------------------------

# Each gradient against the plain backward on the same q, k, v, out, lse
# and dout, rtol 0: an element is held to a fraction of the largest |value|
# in its row of the plain result, and no row's bar drops below that
# fraction of 2**-8 of the largest element of the three gradients (rows
# near 0, such as causal dQ's row 0). bfloat16: both sides round once
# (one ulp, 2**-7 of the row's largest, apart) and the kernel rounds P and
# dS to bfloat16 before its products (under 2**-7 more: derived and
# measured in tests/test_torch_flash_bwd_numerics.py), so the bar is two
# ulps; float32 differs by summation order and the three TF32 passes (each
# product within about 2**-22 of float32's; modelled in
# tests/test_torch_flash_bwd_f32_numerics.py).
_BWD_FRAC = {torch.float32: 2.0 ** -12, torch.bfloat16: 2.0 ** -6}
# The bf16 forward's lse sums P rounded to bfloat16 (each term within
# 2**-9), so it lies within 2**-9 of the plain one.
_LSE_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
            torch.bfloat16: dict(rtol=0.0, atol=2.0 ** -8)}


def _assert_rows_close(got, want, frac, name):
    peak = max(float(t.float().abs().max()) for t in want)
    for n, gi, wi in zip(("dq", "dk", "dv"), got, want):
        gi, wi = gi.float(), wi.float()
        assert bool(gi.isfinite().all()) and bool(wi.isfinite().all()), f"{name} {n}"
        scale = wi.abs().amax(-1, keepdim=True).clamp_min(2.0 ** -8 * peak)
        over = (gi - wi).abs() / (frac * scale)
        assert not bool((over > 1).any()), (
            f"{name} {n}: {int((over > 1).sum())} elements beyond {frac:g} of their row's "
            f"largest value, worst {float(over.max()):.3g} of its bar")


def _flash_bwd_inputs(b, h, hkv, s, d, dtype, causal, dev, seed):
    """q, k, v, out, lse (from the forward kernel) and a random dout."""

    q, k, v = _qkv((b, h, s, d), (b, hkv, s, d), dtype, dev, np.random.default_rng(seed))
    out, lse = FA.flash_attention_cuda(q, k, v, causal, return_lse=True)
    dout = torch.as_tensor(np.random.default_rng(seed + 1).normal(0, 1, (b, h, s, d))
                           .astype(np.float32), device=dev).to(dtype)
    return q, k, v, out, lse, dout


@pytest.mark.parametrize("s", [1, 63, 1000, 1024])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_attention_backward(s, group, d, causal, dtype):
    """dq, dk, dv of the backward kernel against the plain backward on the
    same inputs, the forward's out and lse against the plain forward, and
    (float32) the gradients against the plain backward of the plain
    forward; in bfloat16 that would measure the forward's rounding of
    out, which moves Dvec = rowsum(dO * O) and so whole rows of dS."""

    dev = _cuda()
    b, hkv = 1, 2
    q, k, v, out, lse, dout = _flash_bwd_inputs(b, hkv * group, hkv, s, d, dtype, causal,
                                                dev, seed=s + d + group)
    want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal)
    torch.testing.assert_close(out, want_out, **_TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **_LSE_TOL[dtype])
    ops.reset_launch_counts()
    got = FA.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal)
    assert ops.launch_counts()["flash_attention_bwd"] == FA.bwd_kernels(dtype, group)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        if name == "dv" or s > 1:  # one key: dS, so dq and dk, is 0 up to rounding
            assert bool(g.any()), f"{name} all zero"
    _assert_rows_close(got, want, _BWD_FRAC[dtype], "same inputs")
    if dtype == torch.float32:
        _assert_rows_close(got, ref.flash_attention_bwd_ref(q, k, v, want_out, want_lse,
                                                            dout, causal),
                           _BWD_FRAC[dtype], "end to end")


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_attention_backward_is_bit_equal_on_repeat(dtype, group):
    """No atomics: each gradient element is summed by one thread in a
    fixed order (bfloat16: a query group's float32 partials summed in
    head order), so two calls give the same bits."""

    dev = _cuda()
    args = _flash_bwd_inputs(4, 8 * group, 8, 1000, 64, dtype, True, dev, seed=3)
    first = FA.flash_attention_bwd_cuda(*args, True)
    second = FA.flash_attention_bwd_cuda(*args, True)
    for g1, g2 in zip(first, second):
        assert torch.equal(g1, g2)


@pytest.mark.parametrize("d", [64, 128])
def test_cuda_flash_attention_backward_f32_long_against_exact(d):
    """float32 at S=4096, causal, GQA: the gradients against those of exact
    attention (float64 autograd on the card) at the float32 row bar. The
    kernels sum dQ over up to 4,096 keys and dK, dV over up to 4,096
    queries and two heads on the tensor cores, which truncate each sum: a
    chain that grew with S would show here. The grid is small, so a block
    runs two warp groups over alternate tiles: a repeat gives the same
    bits."""

    dev = _cuda()
    b, h, hkv, s = 1, 4, 2, 4096
    q, k, v, out, lse, dout = _flash_bwd_inputs(b, h, hkv, s, d, torch.float32, True, dev,
                                                seed=d)
    got = FA.flash_attention_bwd_cuda(q, k, v, out, lse, dout, True)
    again = FA.flash_attention_bwd_cuda(q, k, v, out, lse, dout, True)
    assert all(torch.equal(g1, g2) for g1, g2 in zip(got, again))
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    scores = qd @ kd.repeat_interleave(2, 1).transpose(-1, -2) / d ** 0.5
    scores = scores.masked_fill(torch.ones(s, s, dtype=torch.bool, device=dev).triu(1),
                                float("-inf"))
    exact = torch.softmax(scores, -1) @ vd.repeat_interleave(2, 1)
    want = torch.autograd.grad(exact, (qd, kd, vd), dout.double())
    _assert_rows_close(got, want, _BWD_FRAC[torch.float32], "exact")


def test_cuda_flash_attention_backward_takes_non_contiguous_dout():

    dev = _cuda()
    q, k, v, out, lse, dout = _flash_bwd_inputs(1, 4, 2, 77, 64, torch.bfloat16, True, dev, 5)
    strided = dout.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    for g1, g2 in zip(FA.flash_attention_bwd_cuda(q, k, v, out, lse, strided, True),
                      FA.flash_attention_bwd_cuda(q, k, v, out, lse, dout, True)):
        assert torch.equal(g1, g2)


def _directional_check(loss_fn, inputs, eps, rtol, seed):
    """Central differences of ``loss_fn`` along a random direction of each
    input against the autograd gradient's projection on it."""
    rng = np.random.default_rng(seed)
    inputs = [t.detach().clone().requires_grad_() for t in inputs]
    grads = torch.autograd.grad(loss_fn(*inputs), inputs)
    for i, (t, g) in enumerate(zip(inputs, grads)):
        u = torch.as_tensor(rng.normal(0, 1, t.shape).astype(np.float32), device=t.device)
        with torch.no_grad():
            plus = [x + eps * u if j == i else x for j, x in enumerate(inputs)]
            minus = [x - eps * u if j == i else x for j, x in enumerate(inputs)]
            num = (loss_fn(*plus) - loss_fn(*minus)).double() / (2 * eps)
        ana = (g.double() * u.double()).sum()
        assert abs(float(num - ana)) <= rtol * max(abs(float(ana)), 1.0), (i, float(num),
                                                                          float(ana))


def test_cuda_flash_attention_gradient_finite_differences():
    """float32, tiny: the autograd path (forward kernel with lse, backward
    kernel) against central differences, GQA and causal."""

    dev = _cuda()
    q, k, v = _qkv((1, 4, 37, 32), (1, 2, 37, 32), torch.float32, dev, np.random.default_rng(9))
    w = torch.as_tensor(np.random.default_rng(10).normal(0, 1, q.shape).astype(np.float32),
                        device=dev)
    ops.reset_launch_counts()
    _directional_check(lambda q, k, v: (ops.flash_attention(q, k, v, True) * w).sum(),
                       [q, k, v], eps=1e-2, rtol=2e-3, seed=11)
    counts = ops.launch_counts()
    assert counts["flash_attention"] > 0
    assert counts["flash_attention_bwd"] == FA.bwd_kernels(torch.float32, 2)


def _scan_bwd_inputs(c, h, f, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    decay = torch.as_tensor(rng.uniform(0.3, 1.0, (c, h)).astype(np.float32), device=dev)
    mk = lambda *sh: torch.as_tensor(rng.normal(0, 1, sh).astype(np.float32),  # noqa: E731
                                     device=dev).to(dtype)
    states, _ = ref.mamba2_chunk_scan_ref(decay, mk(c, h, f))
    return decay, states, mk(c, h, f), mk(h, f)


@pytest.mark.parametrize("grads", ["both", "states_only", "final_only"])
@pytest.mark.parametrize("c,h,f", [(8, 256, 4096), (3, 5, 7), (1, 16, 64), (16, 8, 20000),
                                   (6, 9, 33), (1, 8, 20000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mamba2_chunk_scan_backward(c, h, f, dtype, grads):
    """g_inc equal to the plain backward (the same rounded multiply, then
    add, on a float32 carry); g_decay within float32 summation order."""
    from repro_torch.kernels import mamba2_scan as MS

    dev = _cuda()
    decay, states, g_states, g_final = _scan_bwd_inputs(c, h, f, dtype, dev, seed=c + h + f)
    g_states = None if grads == "final_only" else g_states
    g_final = None if grads == "states_only" else g_final
    ops.reset_launch_counts()
    got = MS.mamba2_chunk_scan_bwd_cuda(decay, states, g_states, g_final)
    assert ops.launch_counts()["mamba2_chunk_scan_bwd"] == 1
    want = ref.mamba2_chunk_scan_bwd_ref(decay, states, g_states, g_final)
    assert got[0].dtype == torch.float32 and got[1].dtype == dtype
    torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=0.0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-3)


def test_cuda_mamba2_chunk_scan_backward_is_bit_equal_on_repeat():
    from repro_torch.kernels import mamba2_scan as MS

    dev = _cuda()
    args = _scan_bwd_inputs(8, 256, 4096, torch.float32, dev, seed=1)
    first, second = (MS.mamba2_chunk_scan_bwd_cuda(*args) for _ in range(2))
    for g1, g2 in zip(first, second):
        assert torch.equal(g1, g2)


def test_cuda_mamba2_chunk_scan_backward_on_two_streams_is_bit_equal():
    """Calls on two streams, one after the other, each bit-equal to a
    call on the default stream: every launch leaves its stream's
    counters at 0, so the next call's last block merges again."""
    from repro_torch.kernels import mamba2_scan as MS

    dev = _cuda()
    args = _scan_bwd_inputs(8, 256, 4096, torch.float32, dev, seed=2)
    want = MS.mamba2_chunk_scan_bwd_cuda(*args)
    torch.cuda.synchronize()
    for stream in (torch.cuda.Stream(dev), torch.cuda.Stream(dev)):
        with torch.cuda.stream(stream):
            got = [MS.mamba2_chunk_scan_bwd_cuda(*args) for _ in range(2)]
        stream.synchronize()
        for g in got:
            for a, b in zip(g, want):
                assert torch.equal(a, b)
    assert all(not cnt.any() for cnt, _ in MS._workspaces._by_key.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mamba2_chunk_scan_backward_one_device_launch_per_call(dtype):
    """g_decay merges inside the one launch (no zero-fill, no second
    kernel): the profiler sees no device kernel but the backward's, at
    most one per call, in the 16-byte-vector instantiation at the
    training shape. (It drops a short kernel's record now and then,
    never adds one: the count is held from above, the wrapper's from
    both sides.)"""
    from repro_torch.kernels import mamba2_scan as MS

    dev = _cuda()
    args = _scan_bwd_inputs(8, 256, 4096, dtype, dev, seed=3)
    call = lambda: MS.mamba2_chunk_scan_bwd_cuda(*args)  # noqa: E731
    call()  # builds the kernel, makes the workspace
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    names = _device_kernel_names(call, calls=10, tries=5)
    assert ops.launch_counts()["mamba2_chunk_scan_bwd"] == 50
    assert 0 < len(names) <= 10, names
    assert all("mamba2_scan_bwd_kernel<" in n for n in names), names
    assert MS.last_bwd_plan.vec == 16 // args[1].element_size()


def test_cuda_mamba2_chunk_scan_gradient_finite_differences():
    dev = _cuda()
    rng = np.random.default_rng(4)
    decay = torch.as_tensor(rng.uniform(0.3, 1.0, (6, 9)).astype(np.float32), device=dev)
    inc = torch.as_tensor(rng.normal(0, 1, (6, 9, 33)).astype(np.float32), device=dev)
    ws = torch.as_tensor(rng.normal(0, 1, (6, 9, 33)).astype(np.float32), device=dev)
    wf = torch.as_tensor(rng.normal(0, 1, (9, 33)).astype(np.float32), device=dev)

    def loss(decay, inc):
        states, final = ops.mamba2_chunk_scan(decay, inc)
        return (states * ws).sum() + (final * wf).sum()

    ops.reset_launch_counts()
    _directional_check(loss, [decay, inc], eps=1e-2, rtol=2e-3, seed=12)
    counts = ops.launch_counts()
    assert counts["mamba2_chunk_scan"] > 0 and counts["mamba2_chunk_scan_bwd"] == 1


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen1.5-4b"])
def test_cuda_smoke_train_gradients_match_cpu_float32(arch):
    """One loss and gradient of a trainable smoke model in float32 on the
    card (forward and backward kernels, remat) and on the CPU (plain
    versions), same weights: loss at 1e-5, each gradient within 1e-3 of
    its tensor's norm (float32, TF32 off; sums in another order)."""
    import copy

    dev = _cuda()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.train import loss_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    cpu = build_model(cfg, device="cpu", seed=0, trainable=True, act_dtype=torch.float32)
    card = copy.deepcopy(cpu).to(dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64)))
    ops.reset_launch_counts()
    lc, _, gc_ = loss_and_grads(cpu, {"tokens": toks})
    lg, _, gg = loss_and_grads(card, {"tokens": toks.to(dev)})
    counts = ops.launch_counts()
    assert counts["flash_attention"] > 0 and counts["flash_attention_bwd"] > 0
    if arch == "zamba2-1.2b":
        assert counts["mamba2_chunk_scan"] > 0 and counts["mamba2_chunk_scan_bwd"] > 0
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    for name, g in gc_.items():
        err = float((gg[name].cpu() - g).abs().max())
        assert err <= 1e-3 * max(float(g.norm()), 1e-6), (name, err)


def test_two_ranks_on_the_card_equal_one_rank(tmp_path):
    """Two ranks share the card on mesh (1, 2) (``gloo``: every collective
    staged through host memory): one float32 step of smoke qwen1.5 equals
    one rank's on the card (``chip_smoke.py`` phase 10 (b) at smoke size):
    loss 1e-5 relative, gradients 1e-4 of their norm, each updated weight
    within 2e-6 plus what the two clipped gradients' difference can move
    Adam's first step (``tests/test_torch_train.py``'s bound)."""
    _cuda()
    import _torch_dist_jobs as J

    toks = torch.as_tensor(np.random.default_rng(5).integers(0, 512, (2, 64)))
    lr = 1e-3
    res = J.spawn("card_step", 2, tmp_path, dict(arch="qwen1.5-4b", tokens=toks, lr=lr),
                  timeout=300)
    got, want = res["sharded"], res["one"]
    assert res["launches"]["flash_attention"] > 0 and res["launches"]["flash_attention_bwd"] > 0
    assert res["staged"]["all_reduce_sum"] > 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    norm = float(torch.stack([g.norm() for g in want["grads"].values()]).norm())
    clip = min(1.0, 1.0 / norm)
    eps = 1e-8
    for k, w in want["grads"].items():
        assert float((got["grads"][k] - w).abs().max()) <= 1e-4 * max(float(w.norm()), 1e-6), k
        a, b = (got["grads"][k] * clip).double(), (w * clip).double()
        drift = (a - b).abs() * eps / (torch.minimum(a.abs(), b.abs()) + eps) ** 2
        bound = 2e-6 + lr * torch.where(a.sign() != b.sign(), torch.full_like(drift, 2.0), drift)
        assert not bool(((got["new"][k] - want["new"][k]).abs().double() > bound).any()), k
