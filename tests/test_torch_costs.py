"""``repro_torch.launch.costs`` against the reference's ``repro.launch.costs``.

The analytic model is a copy: every (arch x shape) cell, at ``tp`` 1 and
16, with and without ``causal_skip`` and ``kv_quant``, gives the
reference's numbers float for float. Then the counterpart of
``tests/test_costs.py``'s check of the model against a count of the
program: there, XLA's cost analysis of a one-layer train step; here,
``torch.utils.flop_counter.FlopCounterMode`` over the port's train step
of the same one-layer config (forward, the rematerialised forward and
the backward, on the CPU), which must land within 0.5-2x.
"""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import costs as jcosts
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, get_config
from repro_torch.launch import costs
from repro_torch.models import build_model
from repro_torch.models.config import reduced
from repro_torch.optim import AdamW
from repro_torch.train import TrainState, make_train_step

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


def _fields(c):
    return (c.flops, c.bytes, c.flops_by, c.bytes_by)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_cost_equals_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for tp in (1, 16):
        for causal_skip in (False, True):
            for kv_quant in (False, True):
                kw = dict(tp=tp, causal_skip=causal_skip, kv_quant=kv_quant)
                got = costs.cell_cost(cfg, SHAPES[shape], **kw)
                want = jcosts.cell_cost(jcfg, JSHAPES[shape], **kw)
                assert _fields(got) == _fields(want), (arch, shape, kw)


def test_hlo_cost_analysis_is_not_ported():
    assert not hasattr(costs, "hlo_cost_analysis")
    assert costs.__all__ == ["CellCost", "cell_cost"]


def _tiny(arch="mistral_nemo_12b", **kw):
    base = dict(n_layers=1, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                vocab_size=1024)
    base.update(kw)
    return reduced(get_config(arch), **base)


@pytest.mark.parametrize("b,s", [(2, 256), (4, 512)])
def test_train_flops_match_the_counted_step_single_layer(b, s):
    cfg = _tiny()
    model = build_model(cfg, device="cpu", seed=0, trainable=True, act_dtype=torch.float32)
    opt = AdamW()
    params = dict(model.named_parameters())
    step = make_train_step(model, opt)
    state = TrainState(params, opt.init(params))
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        step(state, {"tokens": toks})
    counted = counter.get_total_flops()
    analytic = costs.cell_cost(cfg, ShapeSpec("t", s, b, "train"), tp=1).flops
    assert counted > 0
    ratio = analytic / counted
    assert 0.5 < ratio < 2.0, f"analytic/counted = {ratio:.2f}"
