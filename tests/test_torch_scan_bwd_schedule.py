"""The schedule of ``csrc/mamba2_scan.cu``'s backward on the CPU.

The CUDA kernel runs the scan's adjoint in one launch: the host picks
its instantiation and grid (:func:`MS.bwd_plan`, called here as the
wrapper calls it); block (s, h) owns span s of head h's row, each of
its ``BWD_THREADS`` threads ``k`` vectors of ``vec`` elements, vector k
at offset ``s * span + (k * threads + t) * vec``. A thread walks the
chunks backwards with its float32 carry in registers, writes g_inc,
sums its elements' ``lam * states`` with fmaf in a fixed order (vector
k, then element v), the warp reduces those sums by a shuffle butterfly,
lane 0 writes the warp's partial, and the last block of a head merges
each chunk's partials in (split, warp) order (see the source's header).

:func:`walk` is a plain numpy model of that arithmetic in float32. The
tests hold it to the port's plain backward (g_inc bit-equal, g_decay at
the card's bars, rtol 1e-4, atol 1e-3) and, through ``jax.vjp`` of the
JAX package's plain scan, to the JAX package (rtol and atol 1e-5, as
``tests/test_torch_train.py`` holds the plain backward). They check
that the plan covers every (h, f) exactly once, takes 16-byte vectors
only where rows are 16-byte aligned, and sizes the workspace; that the
header's constants are the wrapper's; and that the chunk loop has no
barrier and the kernel no float atomics.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build, ref
from repro_torch.kernels import mamba2_scan as MS

F32 = np.float32
SMS = 132  # H100 SXM's SM count
_SOURCE = (_build.CSRC / "mamba2_scan.cu").read_text()
_C = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", _SOURCE)}

#: (C, H, F): the training shape (zamba2-1.2B: 4 x 64 heads, 64 x 64
#: state), odd rows (F=7, 33: not 16-byte aligned), one chunk, and a
#: long row whose last span is partial.
SHAPES = [(8, 256, 4096), (3, 5, 7), (1, 16, 64), (16, 8, 20000), (6, 9, 33)]
GRADS = ["both", "states_only", "final_only", "none"]
DTYPES = [torch.float32, torch.bfloat16]


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def _fma(a, b, c):
    """``fmaf`` in float32: the product is exact in double, then one
    rounding of the sum to double and one to float32 (a double rounding
    that can differ from fmaf's single one in the last bit, rarely;
    g_decay is held at rtol 1e-4)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(F32)


def _chains(a: np.ndarray, p) -> np.ndarray:
    """(H, F) -> (H, splits, threads, k * vec): each thread's elements in
    the order it sums them (vector k, then element v); the masked tail
    as zeros (fmaf(0, 0, x) is x)."""
    h = a.shape[0]
    a = np.pad(a, ((0, 0), (0, p.splits * p.span - p.f)))
    a = a.reshape(h, p.splits, p.k, p.threads, p.vec).transpose(0, 1, 3, 2, 4)
    return a.reshape(h, p.splits, p.threads, p.k * p.vec)


def walk(decay, states, g_states, g_final, p):
    """The kernel's arithmetic on CPU tensors (decay (C, H) float32,
    states and gradients in one type, gradients possibly None) ->
    (g_decay (C, H) float32 numpy, g_inc (C, H, F) tensor of the states'
    type, the partials (C, H, splits, warps))."""
    c, h, f = states.shape
    x = states.float().numpy()
    gs = None if g_states is None else g_states.float().numpy()
    lam = np.zeros((h, f), F32) if g_final is None else g_final.float().numpy().copy()
    d = decay.numpy().astype(F32)
    g_inc = torch.empty_like(states)
    partials = np.zeros((c, h, p.splits, p.warps), F32)
    lanes = np.arange(32)
    for i in reversed(range(c)):
        g_inc[i] = torch.from_numpy(lam).to(states.dtype)
        ls, xs = _chains(lam, p), _chains(x[i], p)
        part = np.zeros(ls.shape[:3], F32)
        for j in range(ls.shape[3]):
            part = _fma(ls[..., j], xs[..., j], part)
        part = part.reshape(h, p.splits, p.warps, 32)
        for off in (16, 8, 4, 2, 1):  # the butterfly: every lane ends with the sum
            part = part + part[..., lanes ^ off]
        partials[i] = part[..., 0]
        # a rounded multiply, then a rounded add (of 0 where g_states is null)
        lam = d[i][:, None] * lam + (F32(0) if gs is None else gs[i])
    g_decay = np.zeros((c, h), F32)
    flat = partials.reshape(c, h, -1)
    for i in range(flat.shape[2]):  # (s, w) order
        g_decay = g_decay + flat[..., i]
    return g_decay, g_inc, partials


def _inputs(c, h, f, dtype, grads, seed):
    """Seeded inputs as the card tests make them: states from the plain
    forward in ``dtype``."""
    rng = np.random.default_rng(seed)
    decay = torch.as_tensor(rng.uniform(0.3, 1.0, (c, h)).astype(F32))
    mk = lambda *sh: torch.as_tensor(rng.normal(0, 1, sh).astype(F32)).to(dtype)  # noqa: E731
    states, _ = ref.mamba2_chunk_scan_ref(decay, mk(c, h, f))
    g_states, g_final = mk(c, h, f), mk(h, f)
    if grads in ("final_only", "none"):
        g_states = None
    if grads in ("states_only", "none"):
        g_final = None
    return decay, states, g_states, g_final


# --------------------------------------------------------------------------
# the model against the plain backward and the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("grads", GRADS)
@pytest.mark.parametrize("c,h,f", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_model_matches_plain_backward(c, h, f, dtype, grads):
    """g_inc bit-equal to the plain backward (the same float32 carry, the
    same rounded multiply, then add); g_decay within the card's bars."""
    args = _inputs(c, h, f, dtype, grads, seed=c + h + f)
    p = MS.bwd_plan(c, h, f, dtype)
    g_decay, g_inc, _ = walk(*args, p)
    want_decay, want_inc = ref.mamba2_chunk_scan_bwd_ref(*args)
    assert g_inc.dtype == dtype and torch.equal(g_inc, want_inc)
    np.testing.assert_allclose(g_decay, want_decay.numpy(), rtol=1e-4, atol=1e-3)
    if grads == "none":
        assert not g_decay.any() and not g_inc.any()


@pytest.mark.parametrize("c,h,f", [(1, 3, 5), (4, 6, 33), (9, 16, 64)])
@pytest.mark.parametrize("outputs", ["both", "states", "final"])
def test_model_matches_jax_vjp(c, h, f, outputs):
    """The model against ``jax.vjp`` of the JAX package's plain scan, at
    the shapes and bars of the plain backward's own test."""
    rng = np.random.default_rng(19 + c * h * f)
    decay = rng.uniform(0.3, 1.0, (c, h)).astype(F32)
    inc = rng.normal(0, 1, (c, h, f)).astype(F32)
    gs = rng.normal(0, 1, (c, h, f)).astype(F32) * (outputs != "final")
    gf = rng.normal(0, 1, (h, f)).astype(F32) * (outputs != "states")
    _, vjp = jax.vjp(jref.mamba2_chunk_scan_ref, jnp.asarray(decay), jnp.asarray(inc))
    want = vjp((jnp.asarray(gs), jnp.asarray(gf)))
    td = torch.as_tensor(decay)
    states, _ = ref.mamba2_chunk_scan_ref(td, torch.as_tensor(inc))
    g_decay, g_inc, _ = walk(td, states, None if outputs == "final" else torch.as_tensor(gs),
                             None if outputs == "states" else torch.as_tensor(gf),
                             MS.bwd_plan(c, h, f, torch.float32))
    for name, a, w in (("g_decay", g_decay, want[0]), ("g_inc", g_inc.numpy(), want[1])):
        np.testing.assert_allclose(a, np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


def test_model_partials_are_the_sums_over_each_warps_elements():
    """Each partial is its warp's share of the row: at the training shape
    a warp owns the elements ``span * s + (k * threads + 32 w + lane) *
    vec + v``, and the (s, w) merge adds all of them."""
    c, h, f = 2, 3, 4096
    args = _inputs(c, h, f, torch.float32, "both", seed=5)
    p = MS.bwd_plan(c, h, f, torch.float32)
    _, g_inc, partials = walk(*args, p)
    prod = (g_inc.double() * args[1].double()).numpy()  # lam * states, chunk by chunk
    e = np.arange(p.splits * p.span).reshape(p.splits, p.k, p.warps, 32, p.vec)
    owner = np.broadcast_to(np.arange(p.warps)[None, None, :, None, None], e.shape)
    for s in range(p.splits):
        for w in range(p.warps):
            idx = e[s][owner[s] == w]
            np.testing.assert_allclose(partials[:, :, s, w], prod[:, :, idx].sum(-1),
                                       rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("c,h,f", SHAPES + [(2, 3, 1), (2, 3, 1024), (2, 3, 1025)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_covers_every_element_once(c, h, f, dtype, aligned):
    """The grid the C side launches (``splits * h`` blocks, block b on
    head b // splits, span b % splits) reaches every (h, f) exactly once;
    no unmasked vector crosses its row's end; 16-byte vectors only where
    rows are 16-byte aligned; the workspace is one counter per head and
    one partial per (chunk, head, split, warp)."""
    p = MS.bwd_plan(c, h, f, dtype, aligned=aligned)
    wide = 16 // torch.empty((), dtype=dtype).element_size()
    assert p.vec == (wide if aligned and f % wide == 0 else 1)
    assert p.k * p.vec == MS.BWD_ELEMS and p.threads == MS.BWD_THREADS
    assert p.span == p.threads * p.k * p.vec
    assert (p.splits - 1) * p.span < f <= p.splits * p.span
    hits = np.zeros((h, f), np.int64)
    b = np.arange(p.blocks)
    head, s = b // p.splits, b % p.splits
    t, k = np.arange(p.threads), np.arange(p.k)
    start = (s[:, None, None] * p.span + (k[None, :, None] * p.threads + t[None, None, :]) * p.vec)
    inside = start < f
    assert np.all(start[inside] + p.vec <= f), "a vector crosses the end of its row"
    for v in range(p.vec):
        e = start + v
        np.add.at(hits, (np.broadcast_to(head[:, None, None], e.shape)[inside], e[inside]), 1)
    assert np.all(hits == 1)
    assert p.counters == h and p.partials == c * h * p.splits * p.warps
    if (c, h, f) == (8, 256, 4096):
        assert (p.splits, p.blocks) == (4, 1024)
        assert p.vec == (wide if aligned else 1)


def test_plan_fills_the_card_once_at_the_training_shape():
    """At the training shape the grid is one wave of the blocks the
    launch bounds ask for on each SM, and a block's threads fit an SM
    that many times (2,048 threads an SM on Hopper)."""
    for dtype in DTYPES:
        p = MS.bwd_plan(8, 256, 4096, dtype)
        assert p.blocks <= _C["BWD_MIN_BLOCKS"] * SMS
    assert _C["BWD_MIN_BLOCKS"] * MS.BWD_THREADS <= 2048


def test_header_constants_are_the_wrappers():
    assert (_C["BWD_THREADS"], _C["BWD_ELEMS"]) == (MS.BWD_THREADS, MS.BWD_ELEMS)
    assert MS.BWD_THREADS % 32 == 0 and MS.BWD_ELEMS % 8 == 0
    assert [p.name for p in _build._sources("mamba2_scan")] == ["mamba2_scan.cu"]


def test_kernel_has_no_barrier_in_its_chunk_loop_and_no_float_atomics():
    """The barriers sit at the merge only; the one atomic bumps an int32
    counter."""
    body = _SOURCE[_SOURCE.index("mamba2_scan_bwd_kernel(const"):_SOURCE.index("int launch_bwd(")]
    loop = body[body.index("for (int c = C - 1; c >= 0; --c)"):body.index("// The merge")]
    assert "__syncthreads" not in loop and "atomic" not in loop
    assert body.count("__syncthreads()") == 2
    assert re.findall(r"atomic\w+\(([^,]+),", body) == ["counters + h"]
    assert "extern __shared__" not in body


def test_workspace_is_kept_per_stream_and_grown():
    """The wrapper's workspace: one zeroed int32 counter per head and a
    float32 partial per (chunk, head, split, warp), grown when a plan
    needs more, the same tensors handed back while they suffice, one
    pair per stream (on the CPU here: the allocation logic only)."""
    dev = torch.device("cpu")
    ws = type(MS._workspaces)()
    small, large = MS.bwd_plan(2, 3, 100, torch.float32), MS.bwd_plan(8, 256, 4096, torch.float32)
    cnt, part = ws.get(dev, 1, small.partials, small.counters)
    assert cnt.dtype == torch.int32 and not cnt.any() and cnt.numel() == small.counters
    assert part.dtype == torch.float32 and part.numel() == small.partials
    assert all(a is b for a, b in zip(ws.get(dev, 1, small.partials, small.counters),
                                      (cnt, part)))
    cnt2, part2 = ws.get(dev, 1, large.partials, large.counters)
    assert cnt2.numel() >= large.counters and part2.numel() >= large.partials
    assert not cnt2.any()
    assert ws.get(dev, 2, small.partials, small.counters)[0] is not cnt2


def test_backward_wrapper_takes_no_cpu_tensors():
    """No fallback: the wrapper launches the kernel or raises."""
    decay = torch.ones(2, 3)
    states = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        MS.mamba2_chunk_scan_bwd_cuda(decay, states, None, None)
