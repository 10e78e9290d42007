"""Paper-scale scenario on the port's simulator (the port of
``examples/wsi_cluster.py``): 100-node hybrid cluster, full optimization
stack, with a node failure and a straggler injected mid-run.

Reproduces the shape of the paper's §V-H experiment (scaled dataset)
and demonstrates the beyond-paper fault tolerance.

    PYTHONPATH=src python examples/wsi_cluster_torch.py [--tiles 4606]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import SimConfig, run_simulation  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=36848 // 8)
    ap.add_argument("--nodes", type=int, default=100)
    args = ap.parse_args()

    healthy = SimConfig(
        n_nodes=args.nodes, policy="pats", window=15,
        locality=True, prefetch=True,
    )
    r = run_simulation(args.tiles, healthy)
    print(
        f"[healthy]   {args.tiles} tiles on {args.nodes} nodes: "
        f"{r.makespan:.0f}s = {r.tiles_per_second:.1f} tiles/s "
        f"(io wait {r.io_wait:.0f}s aggregate)"
    )

    faulty = SimConfig(
        n_nodes=args.nodes, policy="pats", window=15,
        locality=True, prefetch=True,
        fail_node_at=(3, 10.0),            # node 3 dies at t=10s
        heartbeat_timeout=2.0,
        straggler_factor={7: 6.0},         # node 7 is 6x slow
        backup_tasks=True,
    )
    r2 = run_simulation(args.tiles, faulty)
    print(
        f"[1 dead + 1 straggler] {r2.makespan:.0f}s = "
        f"{r2.tiles_per_second:.1f} tiles/s; re-leased "
        f"{r2.recovered_leases} leases, duplicated {r2.duplicated_leases} "
        f"backup tasks; completed: {r2.completed_ok}"
    )
    print(
        f"fault overhead: {r2.makespan / r.makespan - 1:+.1%} makespan "
        f"with 2/{args.nodes} nodes degraded"
    )


if __name__ == "__main__":
    main()
