"""The plain reference against the port's numpy (``cpu``) path and its
``gpu`` variants on the CPU, on small tiles of both traffic mixes."""

import numpy as np
import pytest
import torch

from benchkit.spec import load_module
from kinds.wsi_tiles import make_traffic
from conftest import TINY_TILE, tiny

from repro_torch.app.pipeline import run_tile

#: The numpy path sums in float64 as the reference does; the ``gpu``
#: variants sum in float32 (the std column cancels: ~6e-5 measured).
CPU_BAR, ACCEL_BAR = 1e-6, 1e-3


compare = load_module("compare", "wsi").compare


@pytest.fixture(scope="module")
def reference():
    return load_module("reference", "wsi")


@pytest.mark.parametrize("name", ["wsi4k-fine.cerebrum", "wsi4k-fused.cerebrum"])
def test_reference_matches_the_port(reference, name):
    cell = tiny(name)
    tile = make_traffic(cell.traffic, 20261018, TINY_TILE).tile(0)
    want = reference.run_tile(tile, "cpu")
    assert 0 < want["n_objects"] <= reference.MAX_OBJECTS
    numpy_path = compare(run_tile(tile, "cpu"), want)
    accel = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in run_tile(tile, "gpu", device="cpu").items()}
    accel_path = compare(accel, want)
    for numbers, bar in ((numpy_path, CPU_BAR), (accel_path, ACCEL_BAR)):
        assert numbers["n_objects"] == 0 and numbers["labels"] == 0, numbers
        feats = {k: v for k, v in numbers.items() if k.startswith("feat_")}
        assert len(feats) == 5 and max(feats.values()) < bar, numbers


def test_reference_outputs(reference):
    cell = tiny("wsi4k-fine.cerebrum")
    tile = make_traffic(cell.traffic, 3, TINY_TILE).tile(1)
    out = reference.run_tile(tile, "cpu")
    n = out["n_objects"]
    assert out["objects"].dtype == np.int32 and out["objects"].max() == n
    assert out["feat_pixel"].shape == (reference.MAX_OBJECTS, 3)
    assert out["feat_haralick"].shape == (4,)
    # Every kept object has an area; the rows past n_objects are empty.
    assert (out["feat_morph"][:n, 0] > 0).all() and not out["feat_morph"][n:].any()


# The zamba2 reference against the port's prefill-then-decode on the
# smoke configuration, on the harness's seeded weights.

def _served(cell, model, seed: int, batch: int = 2):
    """The port's prefill then greedy decode of ``batch`` seeded prompts:
    each request's logits at every step and its served tokens."""
    from kinds.serve import make_prompts
    from repro_torch.train import make_prefill_step, make_serve_step

    tr = cell.traffic
    prompts = make_prompts(dict(tr, requests=batch), seed, cell.config["vocab_size"])
    with torch.no_grad():
        logits, caches = make_prefill_step(model, tr["max_len"])(
            {"tokens": torch.as_tensor(prompts).long()})
        got, toks = [logits.float()], [logits.argmax(-1)]
        lengths = torch.full((batch,), tr["prompt_len"], dtype=torch.int32)
        tok, step = toks[0].to(torch.int32), make_serve_step(model)
        for _ in range(tr["max_new"] - 1):
            tok, logits, caches, lengths = step(caches, tok.long(), lengths)
            got.append(logits.float())
            toks.append(tok.long())
    return prompts, torch.stack(got, 1).numpy(), torch.stack(toks, 1).numpy()


def _port_model(cell, seed: int):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model, make_plan

    drv = load_module("drivers", "lm_serve")
    ref = load_module("reference", "zamba2")
    pc = get_smoke_config(cell.config["arch"])
    return Model(pc, make_plan(pc), drv._nest(ref.make_weights(cell.config, seed, "cpu")))


def test_zamba2_weights_are_the_ports_tree():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cell = tiny("zamba2-1.2b.serve")
    ours = _port_model(cell, 3).state_dict()
    port = build_model(get_smoke_config("zamba2-1.2b"), device="cpu").state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in ours.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in port.items()}


@pytest.mark.parametrize("precision, bar", [("float32", 1e-4), ("bfloat16", 0.2)])
def test_zamba2_reference_matches_the_port(precision, bar):
    # In float32 the two differ by rounding alone; as served (bfloat16),
    # within the cell's limit (set on the card at the published widths).
    cell = tiny("zamba2-1.2b.serve")
    ref = load_module("reference", "zamba2")
    cmp = load_module("compare", "logits").compare
    model = _port_model(cell, 11)
    if precision == "float32":
        model = model.float()
    plen, new = cell.traffic["prompt_len"], cell.traffic["max_new"]
    prompts, logits, served = _served(cell, model, 11)
    steps = cell.limits["check_steps"]
    for j in range(len(prompts)):
        want = ref.run_sample({"config": cell.config, "seed": 11, "rows": list(range(plen - 1, plen - 1 + new)),
                               "tokens": np.concatenate([prompts[j], served[j][:-1]])}, "cpu")
        numbers = cmp({"steps": steps, "logits": logits[j][steps], "served": served[j]}, want)
        assert numbers["logits"] < bar and numbers["token_gap"] < bar, numbers
        if precision == "bfloat16":
            assert numbers["logits"] < cell.limits["limits"]["logits"]
