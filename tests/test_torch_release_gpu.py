"""The release of a finished tile on the card (``core/release.py``): the
port's in-process main path, one ``gpu`` lane (PATS, locality, tiles
leased in order as the benchmark's cells lease them), 12 tiles of
1024². The allocator's count after a tile's release does not grow with
the tiles processed. No JAX here: the card's machine has none."""

import pytest
import torch

from repro_torch.app import build_workflow, register_variants, synth_tile
from repro_torch.core import (
    ConcreteWorkflow,
    DataChunk,
    LaneSpec,
    Manager,
    ManagerConfig,
    VariantRegistry,
    WorkerRuntime,
)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_card_memory_stays_flat_over_tiles(fused):
    """``memory_allocated`` right after tile 12's release is within one
    tile's planes (the bytes a release drops) of its value right after
    tile 4's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tiles = [synth_tile(i, size=1024, seed=3) for i in range(12)]
    reg = register_variants(VariantRegistry(), device="cuda")
    cw = ConcreteWorkflow.replicate(
        build_workflow(fused=fused), [DataChunk(i, payload=t) for i, t in enumerate(tiles)])
    for si in cw.stage_instances.values():
        si.deadline = float(si.chunk.chunk_id)
    rt = WorkerRuntime(0, lanes=(LaneSpec("gpu", 0),), policy="pats", locality=True,
                       variant_registry=reg)
    after: list[int] = []
    release = rt.release_ops

    def counted(chunk, uids):
        nbytes = release(chunk, uids)
        after.append(torch.cuda.memory_allocated())
        return nbytes

    rt.release_ops = counted
    mgr = Manager(cw, ManagerConfig(window=2, backup_tasks=False, heartbeat_timeout=60.0))
    mgr.register_worker(rt)
    rt.start()
    try:
        assert mgr.run(timeout=600.0), rt.errors[:3]
    finally:
        rt.stop()
    stats = rt.stats()
    assert stats["released_chunks"] == len(after) == len(tiles)
    planes = stats["released_bytes"] / stats["released_chunks"]
    print({"fused": fused, "after": after, "planes": planes})
    assert abs(after[11] - after[3]) <= planes
