"""The port stands alone: no module under ``src/repro_torch`` (nor
``chip_smoke.py``, the port's examples and its paper-figure bench)
imports JAX or the JAX package, the copied runtime
modules are byte-identical to their originals (but for the repairs in
``REPAIRED``), and the entry points
that default to the card raise where there is none."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
PORT_SCRIPTS = [
    *(ROOT / "examples" / f"{m}_torch.py" for m in ("quickstart", "wsi_cluster", "serve_lm")),
    ROOT / "benchmarks" / "torch_paper_figs.py",
]
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", *PORT_SCRIPTS]
FORBIDDEN = {"jax", "jaxlib", "repro"}

COPIED = [
    *(f"core/{m}.py" for m in ("workflow", "variants", "calibration", "cost_model",
                               "scheduling", "worker", "manager", "simulator",
                               "network")),
    *(f"staging/{p.name}" for p in sorted((REF / "staging").glob("*.py"))),
    *(f"telemetry/{m}.py" for m in ("metrics", "tracing", "export", "recorder")),
    *(f"transport/{m}.py" for m in ("bus", "inproc", "socketbus", "endpoint")),
    *(f"serving/{p.name}" for p in sorted((REF / "serving").glob("*.py"))),
    "app/tiles.py",
    "data/ledger.py",
    "models/config.py",
    *(f"configs/{p.name}" for p in sorted((REF / "configs").glob("*.py"))
      if p.name != "__init__.py"),
]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch, repro_torch.app, repro_torch.core, repro_torch.staging\n"
        "import repro_torch.telemetry, repro_torch.transport\n"
        "import repro_torch.faults, repro_torch.serving, repro_torch.transport.endpoint\n"
        "import repro_torch.transport.demo, repro_torch.app.pipeline\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "import repro_torch.models, repro_torch.configs, repro_torch.train\n"
        "import repro_torch.launch.serve, repro_torch.launch.costs_h100\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.ckpt\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.launch.mesh, repro_torch.launch.sharding\n"
        "import repro_torch.launch.spmd, repro_torch.launch.elastic\n"
        "import repro_torch.launch.costs, repro_torch.launch.dryrun\n"
        "import repro_torch.core.simulator, repro_torch.core.network\n"
        "import chip_smoke\n"
        "import runpy\n"
        f"for p in {[str(p) for p in PORT_SCRIPTS]!r}:\n"
        "    runpy.run_path(p, run_name='imported')\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and"
        " (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


#: Copies that carry a repair the reference lacks: the port's file is the
#: reference's with exactly this text added, once.
REPAIRED = {
    # ``SocketBus.close`` wakes the accept thread that holds the handlers.
    "transport/socketbus.py": (
        "            # On Linux, close() alone does not wake a thread blocked in\n"
        "            # accept(), and that thread's loop holds the handlers (a\n"
        "            # ManagerEndpoint and its Manager, with every stage output):\n"
        "            # shutdown() makes accept() fail, so the loop returns.\n"
        "            try:\n"
        "                self._listener.shutdown(socket.SHUT_RDWR)\n"
        "            except OSError:\n"
        "                pass\n",
        "            if self._accept_thread not in (None, threading.current_thread()):\n"
        "                self._accept_thread.join(timeout=5.0)\n",
    ),
    # ``worker_main`` outlasts its threads before the interpreter finalizes.
    "transport/endpoint.py": (
        "        # A thread still inside a torch call when the interpreter\n"
        "        # finalizes is ended as it re-takes the GIL, within C++ that\n"
        "        # cannot unwind, and the process aborts: outlast every thread.\n"
        "        deadline = time.monotonic() + 30.0\n"
        "        for thread in threading.enumerate():\n"
        "            if thread is not threading.current_thread():\n"
        "                thread.join(timeout=max(0.0, deadline - time.monotonic()))\n",
    ),
    # A traced runtime's lane spans (``telemetry/lanes.py``): built with
    # the tracer, told when a lane takes and ends its ops, closed at stop.
    # The release of a finished chunk's outputs (``core/release.py``):
    # ``DeviceMemory.discard``, the counters, ``release_ops``.
    "core/worker.py": (
        "from .release import tensor_bytes\n",
        "from ..telemetry.lanes import LaneTrace, record_release\n",
        "\n"
        "    def discard(self, uid: int) -> Any:\n"
        "        \"\"\"Remove ``uid``'s entry, not an eviction: its value, or None.\"\"\"\n"
        "        return self._store.pop(uid, None)\n",
        "        # Finished chunks' op outputs dropped (release_ops), and the\n"
        "        # tensor bytes they held.\n"
        "        self.released_chunks = c(\"released_chunks\")\n"
        "        self.released_bytes = c(\"released_bytes\")\n",
        "        # Lane tracing (telemetry/lanes.py): queue waits, the lanes\n"
        "        # between ops, gc pauses; built only with a tracer.\n"
        "        self._lanes_trace = LaneTrace(self) if tracer is not None else None\n",
        "        if self._lanes_trace is not None:\n"
        "            self._lanes_trace.close()\n",
        "            \"released_chunks\": int(self.released_chunks),\n"
        "            \"released_bytes\": int(self.released_bytes),\n",
        "\n"
        "    def release_ops(self, chunk: Any, uids: list[int]) -> int:\n"
        "        \"\"\"Drop every reference this runtime holds to the outputs of op\n"
        "        instances ``uids``, whose chunk the Manager saw finish (no lease\n"
        "        can read them again; ``core/release.py``): host tier, lanes'\n"
        "        device memory, the chained maps.  Returns the tensor bytes\n"
        "        dropped; a ``release`` span where traced.\"\"\"\n"
        "        ts, t0 = time.time(), time.perf_counter()\n"
        "        held: list[Any] = []\n"
        "        with self._lock:\n"
        "            for uid in uids:\n"
        "                key = op_key(uid)\n"
        "                if key in self.store:\n"
        "                    held.append(self.store.get(key))\n"
        "                    self.store.unpin(key)\n"
        "                    self.store.discard(key)\n"
        "                for lane in self._lanes:\n"
        "                    if lane.memory is not None and uid in lane.memory:\n"
        "                        held.append(lane.memory.discard(uid))\n"
        "                self._device_only.pop(uid, None)\n"
        "                held.append(self._host_chained.pop(uid, None))\n"
        "            released = any(v is not None for v in held)\n"
        "            nbytes = tensor_bytes(held)\n"
        "            if released:\n"
        "                self.released_chunks += 1\n"
        "                self.released_bytes += nbytes\n"
        "        del held\n"
        "        if released and self.tracer is not None:\n"
        "            record_release(self.tracer, ts, time.perf_counter() - t0, chunk, nbytes)\n"
        "        return nbytes\n",
        "            if self._lanes_trace is not None:\n"
        "                self._lanes_trace.started(lane, ois)\n",
        "        if self._lanes_trace is not None:\n"
        "            self._lanes_trace.ended(ts_wall + elapsed, t0 + elapsed)\n",
    ),
    # A traced Manager's ``wait:lease``: stamped as a stage instance
    # enters the pending queue, recorded at its lease. The release of a
    # finished chunk's outputs after its completion hook
    # (``core/release.py``).
    "core/manager.py": (
        "from .release import result_of\n",
        "from ..telemetry.lanes import mark_pending, record_lease_wait\n",
        "        if self.tracer is not None:  # wait:lease starts (telemetry/lanes.py)\n"
        "            mark_pending(si)\n",
        "        if completed is not None:  # after the hook: it sees the outputs whole\n"
        "            self._release_finished(si.chunk.chunk_id, completed)\n"
        "\n"
        "    def _release_finished(self, chunk: Any, uid: int) -> None:\n"
        "        \"\"\"Release the outputs of the stage instances linked to ``uid``\n"
        "        (``core/release.py``) once all are done and none is pending,\n"
        "        leased or twinned: each keeps only its result, and every worker\n"
        "        that can release (in-process) drops its references to their op\n"
        "        outputs, which leave the placement directory.\"\"\"\n"
        "        with self._lock:\n"
        "            group = self._finished_group_locked(uid)\n"
        "            if not group:\n"
        "                return\n"
        "            clones = [c for c, p in self._clone_map().items() if p in group]\n"
        "            op_uids = [\n"
        "                oi.uid\n"
        "                for g in group + clones\n"
        "                for oi in self.cw.stage_instances[g].op_instances\n"
        "            ]\n"
        "            for g in group:\n"
        "                outputs = self._stage_outputs.get(g)\n"
        "                if outputs is None:\n"
        "                    continue\n"
        "                stage = self.cw.stage_instances[g].stage\n"
        "                kept = {n: result_of(stage.op(n), v) for n, v in outputs.items()}\n"
        "                self._stage_outputs[g] = {\n"
        "                    n: v for n, v in kept.items() if v is not None\n"
        "                }\n"
        "            for wid, st in self._workers.items():\n"
        "                release = getattr(st.runtime, \"release_ops\", None)\n"
        "                if release is None:\n"
        "                    continue\n"
        "                release(chunk, op_uids)\n"
        "                for u in op_uids:\n"
        "                    if wid in self.directory.holders(op_key(u)):\n"
        "                        self.directory.evict(wid, op_key(u))\n"
        "\n"
        "    def _finished_group_locked(self, uid: int) -> list[int]:\n"
        "        \"\"\"The stage instances linked to ``uid`` by dependencies, when\n"
        "        every one is done and none (nor a twin of one) is pending or\n"
        "        leased; else an empty list.\"\"\"\n"
        "        group, stack = {uid}, [uid]\n"
        "        while stack:\n"
        "            si = self.cw.stage_instances[stack.pop()]\n"
        "            if si.uid not in self._stage_done:\n"
        "                return []\n"
        "            for u in si.deps | si.dependents:\n"
        "                if u not in group:\n"
        "                    group.add(u)\n"
        "                    stack.append(u)\n"
        "        clones_of = self._clone_map()\n"
        "        busy = [p.uid for p in self._pending]\n"
        "        busy += [u for w in self._workers.values() for u in w.leases]\n"
        "        if any(clones_of.get(u, u) in group for u in busy):\n"
        "            return []\n"
        "        return sorted(group)\n",
        "        if self.tracer is not None:  # wait:lease ends (telemetry/lanes.py)\n"
        "            record_lease_wait(self.tracer, ctx, si, wid)\n",
    ),
}


@pytest.mark.parametrize("rel", COPIED)
def test_runtime_copy_is_byte_identical(rel):
    port = (PORT / rel).read_text()
    for added in REPAIRED.get(rel, ()):
        assert port.count(added) == 1, (rel, added)
        port = port.replace(added, "")
    assert port == (REF / rel).read_text(), rel


def test_card_entry_points_raise_without_a_card():
    """Decided here, not at import: with no card, ``device="cuda"`` (the
    default) raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.app import register_variants, run_tile, synth_tile
    from repro_torch.app.pipeline import wsi_registry_cuda
    from repro_torch.app.segmentation import rbc_detection_accel
    from repro_torch.core import VariantRegistry

    with pytest.raises(RuntimeError, match="cuda"):
        register_variants(VariantRegistry())
    with pytest.raises(RuntimeError, match="cuda"):
        register_variants(VariantRegistry(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        wsi_registry_cuda()  # a spawned worker's factory: no CPU fallback
    tile = synth_tile(0, size=32, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        run_tile(tile, "accel")
    with pytest.raises(RuntimeError, match="cuda"):
        rbc_detection_accel(np.zeros((8, 8, 3), np.uint8))


def test_chip_smoke_fails_without_a_card(tmp_path):
    """``chip_smoke.py`` exits non-zero with no result line, both here
    (no card) and alone in a directory without the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_lm_entry_points_raise_without_a_card():
    """``serve_requests()`` and ``build_model`` default to the card and
    raise without one; nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import build_model

    with pytest.raises(RuntimeError, match="cuda"):
        serve_requests()
    with pytest.raises(RuntimeError, match="cuda"):
        serve_requests(arch="zamba2-1.2b", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_smoke_config("zamba2-1.2b"), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_smoke_config("qwen1.5-4b"))


@pytest.mark.parametrize("script", ["quickstart_torch.py", "serve_lm_torch.py"])
def test_examples_raise_without_a_card(script):
    """With no ``--device`` the examples run on the card, and without one
    they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "RuntimeError: device 'cuda' requested" in out.stderr
    assert "completed" not in out.stdout and "requests ->" not in out.stdout


def test_configs_match_reference():
    """The port's config registry resolves every architecture to the
    reference's configuration (its ``__init__`` differs from the
    reference's in one import line, so it is not in ``COPIED``)."""
    import dataclasses

    from repro.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch import configs as port_configs

    assert port_configs.ARCH_IDS == ARCH_IDS
    for arch in [*ARCH_IDS, "zamba2-1.2b", "qwen1.5-4b"]:
        assert dataclasses.asdict(port_configs.get_config(arch)) == dataclasses.asdict(
            get_config(arch))
        assert dataclasses.asdict(port_configs.get_smoke_config(arch)) == dataclasses.asdict(
            get_smoke_config(arch))


def test_training_entry_points_raise_without_a_card():
    """``run_training()``, ``build_model(..., trainable=True)`` and the
    loader's default ``device_put`` default to the card and raise
    without one; nothing trains on the CPU unless asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import ChunkLedger, PrefetchLoader, TokenChunkSource
    from repro_torch.launch.train import run_training
    from repro_torch.models import build_model

    with pytest.raises(RuntimeError, match="cuda"):
        run_training()
    with pytest.raises(RuntimeError, match="cuda"):
        run_training(arch="zamba2-1.2b", steps=1, batch=1, seq=31, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_smoke_config("zamba2-1.2b"), trainable=True)
    with pytest.raises(RuntimeError, match="cuda"):
        PrefetchLoader(ChunkLedger(2), TokenChunkSource(16, 4, 1))


def test_every_model_module_is_checked():
    """The model zoo's modules, the MoE and xLSTM ones included, are among
    the sources checked for JAX and ``repro`` imports."""
    for name in ("attention", "moe", "xlstm", "transformer", "convert", "model"):
        assert PORT / "models" / f"{name}.py" in SOURCES, name


def test_every_launch_module_is_checked():
    """The launchers beyond one card are among the sources checked for
    JAX and ``repro`` imports."""
    for name in ("mesh", "sharding", "spmd", "elastic", "costs", "dryrun"):
        assert PORT / "launch" / f"{name}.py" in SOURCES, name


def test_every_reference_module_has_a_counterpart():
    """Every module of the JAX package has one of the same path in the
    port (the port adds its own: the build, the device helpers, the
    multi-rank step, the H100 lane)."""
    ref = {p.relative_to(REF) for p in REF.rglob("*.py")}
    port = {p.relative_to(PORT) for p in PORT.rglob("*.py")}
    assert ref <= port, sorted(map(str, ref - port))


def test_mesh_entry_points_raise_without_a_process_group():
    """``make_mesh`` and ``make_production_mesh`` need a process group
    from the caller; without one they raise instead of running on one
    rank unasked."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 2), ("data", "model"), "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), ("data", "model"))
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError, match="process group"):
            make_production_mesh(multi_pod=multi_pod)
