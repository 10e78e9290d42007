"""The port's dry run (``repro_torch.launch.dryrun``) on the production meshes.

One subprocess (the ``fake`` process group of 256 or 512 ranks lives in
it, not in a test worker) runs the CLI on one cell of each kind and
family at 16x16 and on ``long_500k`` of zamba2 and xLSTM at 2x16x16:
full-width models on the ``meta`` device, one step each. Each record:
no error; this rank's parameter bytes equal the sum of the chunk sizes
that the reference's ``param_specs`` gives at that mesh (float32 masters
for training, bfloat16 where serving stores a weight so); each of these
cells fits 80 GB a rank; collective bytes where the mesh splits
anything; the analytic terms of ``launch/costs.py`` on the H100's rates.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest

from repro.configs import get_config
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsharding
from repro.models import build_model as jax_build_model
from repro.models.plan import make_plan as jax_make_plan
from repro_torch.launch.costs_h100 import H100_SXM
from repro_torch.models.layers import BF16_WEIGHTS

ROOT = Path(__file__).resolve().parents[1]
CELLS = [  # (arch, shape, multi-pod): each kind, each family
    ("qwen1p5_4b", "train_4k", False),       # dense
    ("zamba2_1p2b", "prefill_32k", False),   # hybrid
    ("dbrx_132b", "decode_32k", False),      # moe
    ("whisper_small", "prefill_32k", False),  # audio
    ("pixtral_12b", "decode_32k", False),    # vlm
    ("zamba2_1p2b", "long_500k", True),      # long context: the caches' sequence over data
    ("xlstm_125m", "long_500k", True),       # ssm
]
MESHES = {False: ({"data": 16, "model": 16}, ("data", "model")),
          True: ({"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model"))}

RUN = textwrap.dedent(
    """
    import json, sys
    from repro_torch.launch import dryrun

    out = sys.argv[1]
    for arch, shape, mp in json.loads(sys.argv[2]):
        dryrun.main(["--arch", arch, "--shape", shape, "--out", out]
                    + (["--multi-pod"] if mp else []))
    """
)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "results.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", RUN, str(out), json.dumps(CELLS)], env=env,
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {(r["arch"], r["shape"], r["mesh"]): r for r in json.loads(out.read_text())}


def _reference_param_bytes(arch, multi_pod, trainable):
    """The sum over the reference's leaves of this rank's chunk, at the
    port's storage type."""
    shape, axes = MESHES[multi_pod]
    mesh = SimpleNamespace(shape=shape, axis_names=axes)
    cfg = get_config(arch)
    ax = jmesh.axes_for(mesh)
    plan = jax_make_plan(cfg, tp=shape["model"], dp_axes=ax.data, tp_axis=ax.model)
    shapes = jax_build_model(cfg, plan).init_shapes()
    specs = jsharding.param_specs(shapes, cfg, ax, mesh)
    total = 0
    flat_specs = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    for (path, leaf), spec in zip(jax.tree_util.tree_flatten_with_path(shapes)[0], flat_specs):
        parts = 1
        for part in spec:
            for a in (part if isinstance(part, tuple) else (part,)):
                parts *= shape[a] if a else 1
        name = str(getattr(path[-1], "key", path[-1]))
        item = 2 if not trainable and name in BF16_WEIGHTS else 4
        total += math.prod(leaf.shape) // parts * item
    return total


@pytest.mark.parametrize("arch,shape,mp", CELLS, ids=[f"{a}-{s}" for a, s, _ in CELLS])
def test_dry_run_cell(records, arch, shape, mp):
    mesh = "2x16x16" if mp else "16x16"
    rec = records[arch, shape, mesh]
    assert "error" not in rec, rec.get("error")
    assert rec["chips"] == (512 if mp else 256) and rec["fsdp"] == "gather"
    assert rec["param_bytes"] == _reference_param_bytes(arch, mp, shape == "train_4k")
    assert rec["argument_size_in_bytes"] >= rec["param_bytes"] > 0
    assert rec["peak_live_bytes"] == rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
    assert rec["fits_hbm"], f"{rec['peak_live_bytes']:.4g} bytes a rank"
    assert rec["coll_bytes_per_device"] == sum(rec["coll_by_kind"].values()) > 0
    assert rec["coll_by_kind"].get("all_gather", 0) > 0  # the FSDP gathers over data
    n = rec["chips"]
    assert rec["compute_term_s"] == rec["flops_global"] / (n * H100_SXM.peak_flops)
    assert rec["memory_term_s"] == rec["bytes_global"] / (n * H100_SXM.mem_bw)
    assert rec["dominant"] in ("compute", "memory", "collective")
    if shape == "long_500k" and arch == "zamba2_1p2b":
        # the sequence-split merge: one max and one sum per shared attention
        assert rec["coll_by_kind"]["all_reduce_max"] > 0
