"""Serving on a mesh for every family, and the long-context layout.

* The merge of partial decode results (``launch/spmd.merge_partials``)
  alone: a cache cut at seeded boundaries into 2-4 chunks, each chunk
  through the plain decode with its log-sum-exp, merged as the ranks
  merge them, against the whole plain decode (float32, 1e-6) and the
  JAX package's ``decode_attention_ref`` (``tests/test_torch_lm_kernels.py``'s
  3e-5). Empty chunks, and lengths that end exactly on a boundary.
* Serving on ``gloo`` ranks spawned on the CPU (one 4-rank spawn,
  ``tests/_torch_dist_jobs.py``): smoke qwen1.5 and zamba2 at batch 1
  on (2, 1), and zamba2 on (2, 2), where the data axes split the KV
  caches' sequence; smoke dbrx (MoE: every rank routes the whole batch,
  its capacity that of one rank) at batch 1 on (2, 1); zamba2, xLSTM and
  whisper at batch 2 on (1, 2) and (2, 1). Every rank prefills the
  global batch and keeps its rows and its chunk of the caches (the
  layout of ``init_caches``), then greedy decode steps: float32 logits
  within 1e-5 of one rank's, and the same tokens (one rank decodes each
  data rank's rows as that rank batches them), the model back in the
  training layout after each case; and the int8 KV cache in the
  long-context layout, a chain from empty caches. One rank is the oracle for the reason ``tests/test_torch_distributed.py``
  gives; one rank is held to the reference by ``tests/test_torch_models.py``.
"""

import numpy as np
import pytest
import torch

import _torch_dist_jobs as J
from repro.kernels import ref as jref
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.launch.spmd import merge_partials
from repro_torch.train import make_serve_step
from test_torch_distributed import _state
from test_torch_train import _embeds


def _stacked_all_reduce(t, op):
    """``Comm.all_reduce`` over ranks stacked on dim 0 (every rank's
    result, as each rank would hold it)."""
    red = t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)
    return red.expand_as(t)


def _chunked_decode(q, k, v, lengths, bounds):
    """Each chunk ``[bounds[j], bounds[j + 1])`` of the cache through the
    plain decode with its lse (its valid length clamped as a rank clamps
    it), merged."""
    outs, lses = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        local = (lengths - a).clamp(0, b - a).to(torch.int32)
        o, lse = ops.decode_attention(q, k[:, :, a:b].contiguous(), v[:, :, a:b].contiguous(),
                                      local, return_lse=True)
        outs.append(o)
        lses.append(lse)
    return merge_partials(torch.stack(outs), torch.stack(lses), _stacked_all_reduce)[0]


@pytest.mark.parametrize("chunks", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_merged_chunks_equal_the_whole_decode(chunks, seed):
    rng = np.random.default_rng(100 * chunks + seed)
    b, hq, hkv, s, d = 5, 8, 2, 96, 64
    cuts = np.sort(rng.choice(np.arange(1, s), chunks - 1, replace=False))
    bounds = [0, *cuts.tolist(), s]
    # past every chunk but the first, on a boundary (the next chunk
    # empty), one key into a chunk, the whole cache, random
    lengths = np.array([1, bounds[1], bounds[-2] + 1, s, rng.integers(2, s)], np.int32)
    q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    qt, kt, vt = (torch.as_tensor(x) for x in (q, k, v))
    lt = torch.as_tensor(lengths)
    got = _chunked_decode(qt, kt, vt, lt, bounds)
    whole = ref.decode_attention_ref(qt, kt, vt, lt)
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)
    want = jref.decode_attention_ref(q, k, v, lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


def test_plain_decode_lse_and_empty_rows():
    """``return_lse``: the natural-log log-sum-exp of the scaled scores;
    a row with no key gives out 0 and lse -inf, and the merge weighs it
    0 (all-empty rows merge to 0)."""
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.normal(0, 1, (2, 4, 32)).astype(np.float32))
    k = torch.as_tensor(rng.normal(0, 1, (2, 4, 40, 32)).astype(np.float32))
    v = torch.as_tensor(rng.normal(0, 1, (2, 4, 40, 32)).astype(np.float32))
    lengths = torch.tensor([0, 23], dtype=torch.int32)
    out, lse = ref.decode_attention_ref(q, k, v, lengths, return_lse=True)
    assert bool((out[0] == 0).all()) and bool(torch.isneginf(lse[0]).all())
    scores = torch.einsum("hd,hsd->hs", q[1], k[1, :, :23]) / np.sqrt(32)
    torch.testing.assert_close(lse[1], torch.logsumexp(scores, -1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out[1], ref.decode_attention_ref(q, k, v, lengths)[1])
    empty = merge_partials(torch.stack([out[:1], out[:1]]), torch.stack([lse[:1], lse[:1]]),
                           _stacked_all_reduce)
    assert bool((empty == 0).all())


# --------------------------------------------------------------------------
# serving on gloo ranks
# --------------------------------------------------------------------------

LONG = dict(batch=1, prompt=12, steps=8, max_len=32)   # decode crosses 16, ends on it once
ROWS = dict(batch=2, prompt=16, steps=8, max_len=24)
CASES = ([dict(arch=a, mesh=m, **LONG) for a, m in
          (("qwen1.5-4b", (2, 1)), ("zamba2-1.2b", (2, 1)), ("zamba2-1.2b", (2, 2)),
           ("dbrx-132b", (2, 1)))]
         + [dict(arch=a, mesh=m, **ROWS) for a in ("zamba2-1.2b", "xlstm-125m", "whisper-small")
            for m in ((1, 2), (2, 1))])
for _c in CASES:
    _c["key"] = f"{_c['arch']}-{'x'.join(map(str, _c['mesh']))}-b{_c['batch']}"
ARCHS = sorted({c["arch"] for c in CASES})


def _inputs(arch, batch):
    """The whole batch's prompt tokens (and whisper's encoder frames)."""
    cfg = get_smoke_config(arch)
    toks = np.random.default_rng(61).integers(0, cfg.vocab_size, (batch, 16))
    out = {"tokens": torch.as_tensor(toks)}
    embeds = _embeds(arch, batch)
    if embeds is not None:
        out["embeds"] = torch.as_tensor(embeds)
    return out


#: The int8 KV cache (``attention_options(kv_quant=True)``) in the
#: long-context layout: a decode chain from empty caches on teacher-forced
#: tokens, past the ranks' boundary at 16.
INT8 = dict(arch="qwen1.5-4b", mesh=(2, 1), max_len=32,
            tokens=torch.as_tensor(np.random.default_rng(62).integers(0, 512, 20),
                                   dtype=torch.int32))


@pytest.fixture(scope="module")
def serve_mesh_run(tmp_path_factory):
    states = {a: _state(a)[0] for a in ARCHS}
    inputs = {(c["arch"], c["batch"]): _inputs(c["arch"], c["batch"]) for c in CASES}
    args = dict(cases=CASES, states=states, inputs=inputs, int8=INT8)
    return J.spawn("serve_mesh", 4, tmp_path_factory.mktemp("serve_mesh"), args), states, inputs


def _rows(tree, groups, g):
    """Rows group ``g`` of ``groups`` of every cache leaf (batch first)."""
    if isinstance(tree, dict):
        return {k: _rows(v, groups, g) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rows(v, groups, g) for v in tree]
    return tree.chunk(groups, 0)[g].clone()


def _one_rank(c, states, inputs):
    """One rank's prefill of the whole batch, then its greedy decode of
    each group of rows that a data rank decodes, as that rank batches
    them (a float32 product over 1 row and over 2 rounds differently, and
    xLSTM's exponential gates carry that past 1e-5)."""
    model = J._model(get_smoke_config(c["arch"]), states[c["arch"]], trainable=False)
    batch = dict(inputs[c["arch"], c["batch"]])
    batch["tokens"] = batch["tokens"][:, :c["prompt"]]
    logits, whole = model.prefill(batch, c["max_len"])
    groups = c["mesh"][0] if c["batch"] % c["mesh"][0] == 0 else 1
    step = make_serve_step(model)
    seqs, toks = [], []
    for g in range(groups):
        caches = _rows(whole, groups, g)
        mine = logits.chunk(groups, 0)[g]
        lengths = torch.full((mine.shape[0],), c["prompt"], dtype=torch.int32)
        seq, greedy = [mine], []
        for _ in range(c["steps"]):
            nxt = seq[-1].argmax(-1).to(torch.int32)
            greedy.append(nxt)
            _, mine, caches, lengths = step(caches, nxt, lengths)
            seq.append(mine)
        seqs.append(torch.stack(seq))
        toks.append(torch.stack(greedy))
    return torch.cat(seqs, 1), torch.cat(toks, 1)


@pytest.mark.parametrize("case", CASES, ids=[c["key"] for c in CASES])
def test_serving_on_a_mesh_equals_one_rank(serve_mesh_run, case):
    res, states, inputs = serve_mesh_run
    got = res[case["key"]]
    assert got["layout"], "shard_caches gave another layout than init_caches"
    assert got["long"] == (case["batch"] % case["mesh"][0] != 0)
    assert got["rows_split"] == (not got["long"])
    assert got["reset"], "the serving layout outlived the case"
    logits, toks = _one_rank(case, states, inputs)
    torch.testing.assert_close(got["logits"], logits, rtol=1e-5, atol=1e-5)
    assert torch.equal(got["tokens"], toks)



def test_int8_cache_in_the_long_context_layout_equals_one_rank(serve_mesh_run):
    """The int8 KV cache takes the same merge through the float32 kernel:
    20 teacher-forced steps from empty caches on (2, 1), the second
    rank's chunk empty for the first 16, against one rank's int8 chain."""
    from repro_torch.models.attention import attention_options

    res, states, _ = serve_mesh_run
    got = res["int8"]
    assert got["long"] and got["int8"]
    model = J._model(get_smoke_config(INT8["arch"]), states[INT8["arch"]], trainable=False)
    with attention_options(kv_quant=True):
        caches = model.init_caches(1, INT8["max_len"])
        step = make_serve_step(model)  # one rank: no layout
        lengths, seq = torch.zeros((1,), dtype=torch.int32), []
        for t in INT8["tokens"]:
            _, logits, caches, lengths = step(caches, t[None], lengths)
            seq.append(logits)
    torch.testing.assert_close(got["logits"], torch.stack(seq), rtol=1e-5, atol=1e-5)
