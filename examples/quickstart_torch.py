"""Quickstart of the PyTorch/CUDA port: the hierarchical-pipeline
middleware on a hybrid node (the port of ``examples/quickstart.py``).

Runs the paper's WSI analysis application — segmentation + feature
pipelines with CPU (numpy) and accelerator (PyTorch) function
variants — over two Workers, each with one CPU lane and one ``gpu``
lane, under the PATS scheduler and data-locality assignment, then
prints the per-operation device profile (the paper's Fig 10). The
``gpu`` variants run on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.app import build_workflow, register_variants, synth_tile  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ConcreteWorkflow,
    DataChunk,
    LaneSpec,
    Manager,
    ManagerConfig,
    VariantRegistry,
    WorkerRuntime,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the gpu variants (raises if absent)")
    args = ap.parse_args()

    # 1. Abstract workflow (logical stages) + function variants.
    registry = VariantRegistry()
    register_variants(registry, device=args.device)  # cpu + gpu impls per op
    abstract = build_workflow()          # segmentation -> features DAG

    # 2. Concrete workflow: replicate the pipeline over data chunks.
    tiles = [synth_tile(i, size=128, seed=7) for i in range(4)]
    chunks = [DataChunk(i, payload=t) for i, t in enumerate(tiles)]
    concrete = ConcreteWorkflow.replicate(abstract, chunks)

    # 3. Workers: one CPU lane + one accelerator lane each, PATS + DL.
    workers = []
    for wid in range(2):
        w = WorkerRuntime(
            wid,
            lanes=(LaneSpec("cpu", 0), LaneSpec("gpu", 0)),
            policy="pats",
            locality=True,
            variant_registry=registry,
        )
        w.start()
        workers.append(w)

    # 4. Demand-driven Manager with a window of 2 leases per worker.
    manager = Manager(concrete, ManagerConfig(window=2))
    for w in workers:
        manager.register_worker(w)
    ok = manager.run(timeout=600)
    done, total = manager.progress()
    print(f"completed: {ok}  stages: {done}/{total}")

    # 5. Results + the PATS device profile.
    feat_stages = [
        si for si in concrete.stage_instances.values()
        if si.stage.name == "features"
    ]
    n_objs = []
    for si in feat_stages:
        out = manager.stage_outputs(si.uid)
        if out:  # skip backup-task clone instances
            n_objs.append(out["morphometry"]["n_objects"])
    print(f"nuclei per tile: {n_objs}")
    for w in workers:
        prof = w.stats()["profile"]
        gpu_frac = {
            op: round(k.get("gpu", 0) / max(sum(k.values()), 1), 2)
            for op, k in sorted(prof.items())
        }
        print(f"worker {w.worker_id} accel fraction by op: {gpu_frac}")
        w.stop()


if __name__ == "__main__":
    main()
