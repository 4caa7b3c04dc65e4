"""`block_grid_mapping` debug CLI: print the Worst-Fit-First bin packing
of the given block costs (the port of sdpb_tpu/cli/block_grid_mapping.py,
after the reference's block_grid_mapping/main.cxx:6-51).

    python -m sdpb_tpu_torch.cli.block_grid_mapping PROCS_PER_NODE NUM_NODES COST...
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3:
        print("Need at least 3 arguments: procs_per_node, num_nodes, costs...",
              file=sys.stderr)
        return 1
    procs_per_node, num_nodes = int(argv[0]), int(argv[1])
    costs = sorted(((int(c), i) for i, c in enumerate(argv[2:])),
                   reverse=True)

    from ..parallel.planner import compute_block_grid_mapping

    mapping = compute_block_grid_mapping(procs_per_node, num_nodes, costs)
    cost_by_index = {i: c for c, i in costs}
    for node, maps in enumerate(mapping):
        for m in maps:
            entries = ",".join(f"({i},{cost_by_index[i]})"
                               for i in m.block_indices)
            print(f"{node} {m.num_procs}: "
                  f"{m.cost / m.num_procs if m.num_procs else 0}, {{{entries}}}")
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
