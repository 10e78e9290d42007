"""The benchmark loads neither JAX nor the JAX package: no file under
``bench/`` imports them, the reference imports nothing of the port, and
a run driven on the CPU ends with none of them in ``sys.modules``
(top-level names compared whole: the port's name begins with the JAX
package's)."""

import ast
import subprocess
import sys

import pytest

from benchkit.guard import FORBIDDEN
from benchkit.spec import BENCH


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_stands_alone():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert set(_imports(path)) <= {"__future__", "math", "numpy", "torch"}, path


RUN = """
import sys, time
t0 = time.perf_counter()
sys.path[:0] = [{tests!r}]
from conftest import tiny
import run as bench_run
from benchkit.guard import forbidden_modules
result, _ = bench_run.run_cell(tiny({cell!r}), 11, 3.0, True, "cpu", t0)
print(result["correct"], forbidden_modules(), sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "repro", "repro_torch"}}))
"""


@pytest.mark.parametrize("cell", ["wsi4k-fine.cerebrum", "zamba2-1.2b.serve"])
def test_a_run_loads_no_jax(cell):
    out = subprocess.run([sys.executable, "-c", RUN.format(tests=str(BENCH / "tests"), cell=cell)],
                         capture_output=True, text=True, timeout=600, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-2] == "True [] ['repro_torch']", out.stdout[-2000:]
