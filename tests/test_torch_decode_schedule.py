"""The schedule of ``csrc/decode_attention.cu`` on the CPU.

The CUDA kernel computes a whole decode attention in one launch: the
host picks the splits of the cache length (:func:`DA.plan`, called here
as the wrapper calls it); one block per (split, KV head, chunk of query
heads, batch row) streams its split in warp tiles, each key slot of a
warp keeps its own online softmax (updated once per 4 or 8 keys), the
slots merge by a shuffle butterfly, the warps in order, and the last
block of a (batch, KV head, chunk) merges the splits in split order
(see the source's header). :func:`schedule_model` is a plain numpy model
of that arithmetic order in float32. The tests hold it to the port's
plain version and to the JAX package's ``decode_attention_pallas``
(interpret mode) at 3e-5, over groups 1/4/7/12, head dims 32/64/128,
ragged cache lengths and lengths 0, 1 and S (and beyond S, clamped), for both kernels;
and check the plan's arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ref

NEG = np.float32(-1.0e30)
LOG2E = np.float32(1.4426950408889634)
CHUNKS = 8  # 16-byte chunks a lane copies per warp tile, as in the source


class _State:
    """One key slot's (or warp's, or split's) running max, sum and
    accumulator, per query head."""

    def __init__(self, heads: int, d: int):
        self.m = np.full(heads, NEG, np.float32)
        self.l = np.zeros(heads, np.float32)
        self.acc = np.zeros((heads, d), np.float32)


def _merge(a: _State, b: _State) -> _State:
    """The kernel's ``merge``: a's terms first."""
    out = _State(*a.acc.shape)
    out.m = np.maximum(a.m, b.m)
    ea, eb = np.exp2(a.m - out.m), np.exp2(b.m - out.m)
    out.l = a.l * ea + b.l * eb
    out.acc = a.acc * ea[:, None] + b.acc * eb[:, None]
    return out


def _merge_in_order(states) -> _State:
    """The kernel's merge of warps (and of splits): one max over all,
    then the sums in order."""
    out = _State(*states[0].acc.shape)
    out.m = np.max([s.m for s in states], axis=0).astype(np.float32)
    for s in states:
        e = np.exp2(s.m - out.m)
        out.l = out.l + s.l * e
        out.acc = out.acc + s.acc * e[:, None]
    return out


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.as_tensor(a).bfloat16().float().numpy()


def _split_cuda_cores(qg, kk, vv, k0, k1, p, d):
    """float32 (``decode_kernel``): each key slot of each warp keeps its
    own online softmax over the keys of its warp's tiles, updated once
    per ``sub`` keys; the slots merge by the shuffle butterfly, the
    warps in order. q arrives scaled by scale * log2(e)."""
    tpk = d // 4            # lanes per key (4 floats per 16-byte chunk)
    kpw = 32 // tpk         # key slots per warp
    tile = CHUNKS * kpw
    assert tile == p.tile_keys
    sub = CHUNKS // 2 if p.heads * 4 > 32 else CHUNKS
    ntile = -(-(k1 - k0) // tile)
    warps = []
    for w in range(DA.WARPS):
        slots = []
        for slot in range(kpw):
            st = _State(len(qg), d)
            for i in range(w, ntile, DA.WARPS):
                key0 = k0 + i * tile + slot
                for c0 in range(0, CHUNKS, sub):
                    keys = [key0 + (c0 + j) * kpw for j in range(sub)]
                    keys = [key for key in keys if key < k1]
                    sc = qg @ kk[keys].T if keys else np.zeros((len(qg), 0))
                    mt = np.maximum(st.m, sc.max(axis=1) if keys else NEG)
                    alpha = np.exp2(st.m - mt)
                    st.m = mt.astype(np.float32)
                    st.l = st.l * alpha
                    st.acc = st.acc * alpha[:, None]
                    for j, key in enumerate(keys):
                        pj = np.exp2(sc[:, j] - st.m)
                        st.l = st.l + pj
                        st.acc = st.acc + pj[:, None] * vv[key][None, :]
            slots.append(st)
        bit = 1
        while bit < kpw:  # the shuffle butterfly over slot bits
            slots = [_merge(slots[i], slots[i ^ bit]) for i in range(kpw)]
            bit <<= 1
        warps.append(slots[0])
    return _merge_in_order(warps)


def _split_tensor_cores(qg, kk, vv, k0, k1, p, c):
    """bfloat16 (``decode_tc_kernel``): each warp keeps one online
    softmax per head over its tiles (the tile's max at once), scores
    scaled by ``c`` after the product, the sum from float32 P, and P
    rounded to bfloat16 for P V; the warps merge in order."""
    tile = p.tile_keys
    ntile = -(-(k1 - k0) // tile)
    warps = []
    for w in range(DA.WARPS):
        st = _State(len(qg), qg.shape[1])
        for i in range(w, ntile, DA.WARPS):
            keys = np.arange(k0 + i * tile, min(k0 + (i + 1) * tile, k1))
            sc = (qg @ kk[keys].T) * c
            mt = np.maximum(st.m, sc.max(axis=1))
            alpha = np.exp2(st.m - mt)
            st.m = mt.astype(np.float32)
            pt = np.exp2(sc - st.m[:, None])
            st.l = st.l * alpha + pt.sum(axis=1)
            st.acc = st.acc * alpha[:, None] + _bf16(pt) @ vv[keys]
        warps.append(st)
    return _merge_in_order(warps)


def schedule_model(q, k, v, lengths, itemsize: int = 4, sm_count: int = 132):
    """Numpy model of the kernel: ``(out, plan)``, out (B, Hq, D) float32.
    ``itemsize`` 4 models the float32 kernel, 2 the bfloat16 one (the
    inputs are then bfloat16 values held in float32)."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    p = DA.plan(b, hq, hkv, s, d, itemsize, sm_count)
    group = hq // hkv
    c = np.float32(1.0 / np.sqrt(d)) * LOG2E
    out = np.zeros((b, hq, d), np.float32)
    for bi in range(b):
        ln = int(min(max(int(lengths[bi]), 0), s))
        for hk in range(hkv):
            for hc in range(p.head_chunks):
                h0 = hk * group + hc * p.heads
                gn = min(p.heads, group - hc * p.heads)
                if ln == 0:
                    continue  # zeros
                qg = q[bi, h0:h0 + gn]
                kk, vv = k[bi, hk], v[bi, hk]
                nact = -(-ln // p.split_keys)
                splits = []
                for sp in range(nact):
                    k0, k1 = sp * p.split_keys, min((sp + 1) * p.split_keys, ln)
                    if itemsize == 4:
                        splits.append(_split_cuda_cores(qg * c, kk, vv, k0, k1, p, d))
                    else:
                        splits.append(_split_tensor_cores(qg, kk, vv, k0, k1, p, c))
                res = splits[0] if nact == 1 else _merge_in_order(splits)
                out[bi, h0:h0 + gn] = res.acc / res.l[:, None]
    return out, p


def _tol(v, itemsize):
    """float32: 3e-5 (summation order). bfloat16: P is rounded to
    bfloat16 (relative error <= 2**-8) before P V, so an output may move
    by up to 2**-8 of the largest |v|."""
    if itemsize == 4:
        return dict(rtol=3e-5, atol=3e-5)
    return dict(rtol=0.0, atol=2.0**-8 * float(np.abs(v).max()))


def _inputs(b, hq, hkv, s, d, itemsize, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    if itemsize == 2:  # bfloat16 inputs, held exactly in float32
        q, k, v = (torch.as_tensor(a).bfloat16().float().numpy() for a in (q, k, v))
    return q, k, v


def _pallas(q, k, v, lengths, block_k):
    return np.asarray(jops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(lengths), block_k=block_k,
                                            interpret=True))


def _plain(q, k, v, lengths):
    return ref.decode_attention_ref(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                    torch.as_tensor(lengths)).numpy()


# (S, Pallas block_k dividing S, lengths): a cache length no tile divides,
# and one the kernel's tiles do, with lengths 0, 1, S and inside a tile.
_CACHES = {
    "ragged": (300, 300, [300, 131, 1, 0]),
    "tiled": (512, 128, [512, 65, 1, 300]),
}


@pytest.mark.parametrize("cache", list(_CACHES))
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (8, 2), (7, 1)])
def test_schedule_model_matches_plain_and_pallas(hq, hkv, d, itemsize, cache):
    s, bk, lengths = _CACHES[cache]
    lengths = np.array(lengths, np.int32)
    q, k, v = _inputs(len(lengths), hq, hkv, s, d, itemsize, seed=hq * d + s)
    got, p = schedule_model(q, k, v, lengths, itemsize)
    assert p.splits > 1  # the split merge is exercised
    tol = _tol(v, itemsize)
    np.testing.assert_allclose(got, _pallas(q, k, v, lengths, bk), **tol)
    live = lengths > 0  # the plain version gives NaN for a length of 0
    np.testing.assert_allclose(got[live], _plain(q, k, v, lengths)[live], **tol)
    assert not got[~live].any()


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("hq,hkv,d,itemsize,heads,chunks", [
    (24, 2, 64, 4, 8, 2),     # float32, group 12: two chunks of 8 heads
    (10, 2, 32, 4, 8, 1),     # float32, group 5: one chunk of 8, 3 padded
    (40, 2, 64, 2, 16, 2),    # bfloat16, group 20: 16 heads, then 4
    (24, 2, 32, 2, 12, 1),    # bfloat16, group 12: one chunk
])
def test_schedule_model_head_chunks_and_one_split(hq, hkv, d, itemsize, heads, chunks, sm_count):
    """Groups cut into chunks of query heads; one SM gives few splits,
    some sequences with a single one (written without the split merge)."""
    lengths = np.array([97, 1, 400, 333], np.int32)
    q, k, v = _inputs(4, hq, hkv, 400, d, itemsize, seed=hq + sm_count)
    got, p = schedule_model(q, k, v, lengths, itemsize, sm_count)
    assert (p.heads, p.head_chunks) == (heads, chunks)
    tol = _tol(v, itemsize)
    np.testing.assert_allclose(got, _plain(q, k, v, lengths), **tol)
    np.testing.assert_allclose(got, _pallas(q, k, v, lengths, 400), **tol)


def test_schedule_model_clamps_lengths():
    """Lengths past S attend to all of S; a negative length gives zeros."""
    s = 130
    lengths = np.array([s + 7, -3], np.int32)
    q, k, v = _inputs(2, 4, 4, s, 64, 4, seed=9)
    got, _ = schedule_model(q, k, v, lengths)
    want = _plain(q, k, v, np.array([s, 1], np.int32))
    np.testing.assert_allclose(got[0], want[0], rtol=3e-5, atol=3e-5)
    assert not got[1].any()
    np.testing.assert_allclose(got, _pallas(q, k, v, lengths, s), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("b,hq,hkv,s,d,itemsize", [
    (4, 32, 32, 2048, 64, 2),      # zamba2-1.2B decode, bf16
    (4, 32, 8, 16384, 128, 2),     # mistral-nemo-12b heads at 16k, bf16
    (2, 56, 8, 4096, 128, 2),      # yi-34b heads
    (2, 40, 10, 1000, 128, 4),     # phi3-medium heads, float32
    (1, 64, 1, 77, 32, 4),         # one KV head, 8 chunks of 8
])
def test_plan_covers_the_cache_and_fills_the_card(b, hq, hkv, s, d, itemsize):
    p = DA.plan(b, hq, hkv, s, d, itemsize, 132)
    group = hq // hkv
    if itemsize == 2:  # the rows of one mma
        assert p.heads == min(group, DA.MMA_ROWS)
    else:
        assert p.heads in DA.HEADS_PER_BLOCK and p.heads >= min(group, 8)
    assert p.heads * p.head_chunks >= group > (p.head_chunks - 1) * p.heads
    assert p.tile_keys * d * itemsize == DA.TILE_BYTES
    rnd = DA.WARPS * p.tile_keys
    assert p.split_keys % rnd == 0 and p.split_keys >= rnd
    assert p.splits * p.split_keys >= s > (p.splits - 1) * p.split_keys
    if s >= 2048:  # a long cache: at least 2 blocks per SM
        assert p.blocks >= 2 * 132
    assert p.counters == b * hkv * p.head_chunks
    assert p.partials == p.counters * p.splits * p.heads * (d + 2)


def test_plan_of_the_phase_1_shapes():
    """The two shapes ``chip_smoke.py`` times: 4 splits of 512 keys for
    zamba2's decode, 16 splits of 1024 keys for the long GQA decode."""
    p = DA.plan(4, 32, 32, 2048, 64, 2, 132)
    assert (p.heads, p.head_chunks, p.tile_keys, p.split_keys, p.splits) == (1, 1, 32, 512, 4)
    p = DA.plan(4, 32, 8, 16384, 128, 2, 132)
    assert (p.heads, p.head_chunks, p.tile_keys, p.split_keys, p.splits) == (4, 1, 16, 1024, 16)
