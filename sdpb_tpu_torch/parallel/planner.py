"""Block planning (the port's copy of sdpb_tpu/parallel/planner.py):

1. `compute_block_grid_mapping`: the reference's Worst-Fit-First bin
   packing of blocks onto nodes and process groups
   (compute_block_grid_mapping.cxx:1-46), for the `block_grid_mapping`
   debug CLI.  Integer arithmetic throughout, "to make sure that the
   results are the same on different processers" (:61-66).
2. `block_cost_heuristic`: the reference's RAM-proportional cost estimate
   2*B_band + 5*psd + 2*schur + 2*bilinear (read_block_costs.cxx:69-87),
   which the timing run reads.
3. `plan_block_slots` and `plan_block_order`: the LPT placement of a
   bucket's blocks over the ranks of a run of several processes, so that
   the contiguous equal split of the bucket's batch (parallel/mesh.py)
   gives each rank a comparable total cost.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple


@dataclass
class BlockMap:
    """A group of processes owning one big block or several small ones
    (Block_Map.hxx:5-28).  num_procs > 1 and len(block_indices) > 1 are
    mutually exclusive."""

    num_procs: int = 0
    cost: int = 0
    block_indices: List[int] = field(default_factory=list)

    def avg_less_than(self, other: "BlockMap") -> bool:
        # sort by average cost without division (Block_Map.hxx:23-27)
        return self.cost * other.num_procs < other.cost * self.num_procs


def compute_block_grid_mapping(procs_per_node: int, num_nodes: int,
                               block_costs: Sequence[Tuple[int, int]]
                               ) -> List[List[BlockMap]]:
    """block_costs: (cost, index) sorted descending by cost.
    Returns per-node lists of BlockMaps."""
    total_cost = sum(c for c, _ in block_costs)
    num_procs = procs_per_node * num_nodes
    available = [procs_per_node] * num_nodes
    result: List[List[BlockMap]] = [[] for _ in range(num_nodes)]

    # big blocks: cost > average -> own group of floor(cost*P/total) procs,
    # placed on the node with the most free procs (Worst Fit First)
    split = 0
    while (split < len(block_costs)
           and num_procs * block_costs[split][0] > total_cost):
        split += 1

    remaining_cost, remaining_procs = total_cost, num_procs
    for cost, index in block_costs[:split]:
        node = max(range(num_nodes), key=lambda n: available[n])
        procs = min(available[node],
                    max(1, cost * num_procs // total_cost))
        result[node].append(BlockMap(procs, cost, [index]))
        available[node] -= procs
        remaining_cost -= cost
        remaining_procs -= procs

    # hand leftover procs to the costliest existing group per spare proc
    if remaining_procs != num_procs:
        required = (remaining_cost * num_procs + (total_cost - 1)) // total_cost
        extra = remaining_procs - required
        while extra > 0:
            best = None
            best_node = None
            for node in range(num_nodes):
                if available[node] > 0 and result[node]:
                    # exact integer comparison like Block_Map::operator<
                    top = None
                    for m in result[node]:
                        if top is None or top.avg_less_than(m):
                            top = m
                    if best is None or best.avg_less_than(top):
                        best = top
                        best_node = node
            if best is None:
                break
            best.num_procs += 1
            available[best_node] -= 1
            extra -= 1

    # small blocks: round-robin to the least-loaded single-proc group
    pools: List[List[BlockMap]] = [
        [BlockMap(1, 0, []) for _ in range(available[n])]
        for n in range(num_nodes)]
    for cost, index in block_costs[split:]:
        best = None
        for node in range(num_nodes):
            for m in pools[node]:
                if best is None or m.cost < best.cost:
                    best = m
        if best is None:
            raise RuntimeError("INTERNAL ERROR: Unable to find any "
                               "free processors for remaining blocks")
        best.cost += cost
        best.block_indices.append(index)
    for node in range(num_nodes):
        result[node].extend(pools[node])
    return result


def block_cost_heuristic(dim: int, num_points: int, h_even: int, h_odd: int,
                         dual_dim: int) -> int:
    """RAM-proportional cost estimate of a block (the reference's
    read_block_costs.cxx:69-87)."""
    schur_size = num_points * dim * (dim + 1) // 2
    psd = (dim * h_even) ** 2 + (dim * h_odd) ** 2
    bilinear = (dim * num_points) ** 2 * (2 if h_odd else 1)
    B_band = schur_size * dual_dim
    return 2 * B_band + 5 * psd + 2 * schur_size ** 2 + 2 * bilinear


def _lpt_chunks(costs: Sequence, n_devices: int) -> List[List[int]]:
    """Longest processing time first: each block, most costly first, to
    the least loaded device that has fewer than ceil(B/n) blocks (the
    first such device on a tie)."""
    cap = -(-len(costs) // n_devices)
    loads = [0] * n_devices
    chunks: List[List[int]] = [[] for _ in range(n_devices)]
    for idx in sorted(range(len(costs)), key=lambda i: -costs[i]):
        d = min((d for d in range(n_devices) if len(chunks[d]) < cap),
                key=lambda d: loads[d])
        chunks[d].append(idx)
        loads[d] += costs[idx]
    return chunks


def plan_block_slots(costs: Sequence, n_devices: int) -> list:
    """Slots of length n_devices * ceil(B/n): device d's contiguous range
    of ceil(B/n) slots holds its LPT blocks, then None (padding) for what
    it lacks, inside its own range."""
    cap = -(-len(costs) // n_devices)
    return [s for chunk in _lpt_chunks(costs, n_devices)
            for s in chunk + [None] * (cap - len(chunk))]


def plan_block_order(costs: Sequence, n_devices: int) -> List[int]:
    """A permutation of range(B) whose split into n_devices equal
    contiguous chunks balances the total cost (the devices' LPT chunks,
    device-major)."""
    return [s for chunk in _lpt_chunks(costs, n_devices) for s in chunk]
