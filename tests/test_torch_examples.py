"""The port's examples and paper-figure benches against the reference's:
``examples/{quickstart,wsi_cluster,serve_lm}_torch.py`` run (on the CPU
where they would use the card), ``wsi_cluster_torch.py`` prints what
``examples/wsi_cluster.py`` prints, and ``benchmarks/torch_paper_figs``
gives the rows of ``benchmarks/paper_figs`` wherever both run the
calibrated simulator."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _run(script: str, *args: str, timeout: float = 240) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    return subprocess.run([sys.executable, str(EXAMPLES / script), *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_quickstart_torch_on_the_cpu_completes_every_stage():
    out = _run("quickstart_torch.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "completed: True  stages: 8/8"
    assert lines[1].startswith("nuclei per tile: [")
    n_objs = eval(lines[1].split(": ", 1)[1])  # noqa: S307 - a printed list of ints
    assert len(n_objs) == 4 and all(n > 0 for n in n_objs)
    assert [ln.split(" accel")[0] for ln in lines[2:]] == ["worker 0", "worker 1"]


def test_wsi_cluster_torch_prints_what_the_reference_prints():
    args = ("--tiles", "200", "--nodes", "8")
    got, want = _run("wsi_cluster_torch.py", *args), _run("wsi_cluster.py", *args)
    assert got.returncode == 0 and want.returncode == 0, (got.stderr, want.stderr)
    assert got.stdout == want.stdout
    assert "completed: True" in got.stdout


def test_serve_lm_torch_on_the_cpu_serves_every_request():
    out = _run("serve_lm_torch.py", "--device", "cpu", "--requests", "4", "--batch", "2",
               "--prompt-len", "8", "--max-new", "3")
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("4 requests -> 12 tokens at ")
    assert "PATS roofline estimates: prefill " in out.stdout


@pytest.mark.parametrize("bench", ["fig8", "fig9", "table2", "fig13"])
def test_paper_fig_rows_equal_the_reference(bench):
    from benchmarks import paper_figs, torch_paper_figs

    assert torch_paper_figs.ALL_BENCHES[bench]() == paper_figs.ALL_BENCHES[bench]()


def test_fig7_calibrated_rows_equal_the_reference():
    from benchmarks import paper_figs, torch_paper_figs

    got = torch_paper_figs.bench_fig7_op_speedups(measure=False)
    assert got == paper_figs.bench_fig7_op_speedups(measure=False)
    assert len(got) == 15


def test_fig7_measured_rows_on_the_cpu():
    from benchmarks import torch_paper_figs

    rows = torch_paper_figs.bench_fig7_op_speedups(device="cpu", size=64)
    measured = [r for r in rows if r[0].endswith("/measured_ratio")]
    assert [r[0].split("/")[1] for r in measured] == [
        r[0].split("/")[1] for r in rows if r[0].endswith("/speedup_calibrated")]
    for name, ratio, derived in measured:
        assert ratio > 0 and "device=cpu" in derived, name


def test_torch_paper_figs_cli_prints_rows():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-m", "benchmarks.torch_paper_figs", "--only",
                          "fig7,fig10", "--device", "cpu", "--size", "64"],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "name,value,derived"
    assert sum(ln.startswith("fig7/") for ln in lines) == 29
    assert any(ln.startswith("fig10/") for ln in lines)
