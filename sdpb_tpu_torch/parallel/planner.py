"""Block costs for the timing run (the port's copy of
block_cost_heuristic from sdpb_tpu/parallel/planner.py; the slot planner
for several devices is not ported)."""
from __future__ import annotations


def block_cost_heuristic(dim: int, num_points: int, h_even: int, h_odd: int,
                         dual_dim: int) -> int:
    """RAM-proportional cost estimate of a block (the reference's
    read_block_costs.cxx:69-87)."""
    schur_size = num_points * dim * (dim + 1) // 2
    psd = (dim * h_even) ** 2 + (dim * h_odd) ** 2
    bilinear = (dim * num_points) ** 2 * (2 if h_odd else 1)
    B_band = schur_size * dual_dim
    return 2 * B_band + 5 * psd + 2 * schur_size ** 2 + 2 * bilinear
