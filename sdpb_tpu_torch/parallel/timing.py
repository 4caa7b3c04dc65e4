"""The timing run (the port's copy of sdpb_tpu/parallel/timing.py, one
device): the reference's two throwaway iterations that measure block
costs (src/sdpb/main.cxx:50-91), here deciding the bucketing policy.

Merging blocks of near shapes ("quantized") pads them and wastes work;
keeping shapes apart ("exact") makes more, smaller batches and more
launches.  Which is faster depends on the card and the problem, so each
candidate is timed over 2 iterations and the fastest kept.  The record,
with a per-block cost table (the winner's seconds per iteration split by
the reference's RAM heuristic), is persisted as `block_timings.json` in
the checkpoint directory, key for key as the JAX package writes it, so
each package reads the other's; a run that finds it measures nothing.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import mpmath

TIMINGS_FILE = "block_timings.json"

# the bucketing policies the timing run measures: (shape_policy, quant)
CANDIDATES: List[Tuple[str, int]] = [("quantized", 8), ("exact", 0)]


def _time_iterations(sdp, params, n_timed: int = 2) -> float:
    """Steady seconds per iteration of the path the solve runs: replays of
    the chunked loop's iteration (solver/graphs.py::ChunkRunner, one
    iteration a chunk, each ended by the host copy of its row), the
    warm-up, capture and instantiate not counted; on the CPU the eager
    iteration after one warm-up.  The StepConfig is the JAX package's
    (sdpb_tpu/parallel/timing.py:44-84), its factor held to the port's
    cap.  The runner is closed before the next candidate's is built, so
    two graph pools never coexist."""
    from ..solver.graphs import ChunkRunner
    from ..solver.params import refinement_passes
    from ..solver.solve import initial_factor_limbs
    from ..solver.state import initial_state
    from ..solver.step import CARRY_START, StepConfig
    from ..utils.strings import str_to_limbs, str_to_scaled_limbs

    K, scaled = sdp.b.K, sdp.b.scaled

    def parse(s):
        return str_to_scaled_limbs(s, K) if scaled else str_to_limbs(s, K)

    state = initial_state(sdp, parse(params.initial_matrix_scale_primal),
                          parse(params.initial_matrix_scale_dual))
    _, factor_cap = initial_factor_limbs(params, K, scaled)
    factor_limbs = min(factor_cap, max(2, (K + 2) // 2))
    cfg = StepConfig(
        total_psd_rows=sdp.total_psd_rows, factor_limbs=factor_limbs,
        n_refine=refinement_passes(K, factor_limbs, scaled),
        gamma=float(mpmath.mpf(params.step_length_reduction)),
        feasible_beta_limbs=parse(params.feasible_centering_parameter),
        infeasible_beta_limbs=parse(params.infeasible_centering_parameter),
        primal_error_threshold=1e-10, dual_error_threshold=1e-10,
        max_complementarity=1e30,
        duality_gap_threshold_limbs=parse(params.duality_gap_threshold))
    runner = ChunkRunner(sdp, cfg, state, CARRY_START, 1, params.max_iterations)
    try:
        if runner.graphs is None:
            runner.run()
        t0 = time.time()
        for _ in range(n_timed):
            runner.run()
        return (time.time() - t0) / n_timed
    finally:
        runner.close()


def timing_run(host_sdp, params, device, scaled_limbs: int = 0, verbosity: int = 1,
               print_fn=print) -> dict:
    """Time each of CANDIDATES over 2 iterations on `device` and split the
    winner's seconds per iteration over the blocks; returns the record
    that save_timings persists."""
    from ..models.sdp import build_device_sdp
    from .planner import block_cost_heuristic

    measured = []
    for policy, quant in CANDIDATES:
        sdp = build_device_sdp(host_sdp, device, scaled_limbs=scaled_limbs, quant=quant,
                               shape_policy=policy)
        secs = _time_iterations(sdp, params)
        measured.append({"policy": policy, "quant": quant, "s_per_iteration": secs,
                         "num_buckets": len(sdp.buckets)})
        del sdp
        if verbosity >= 1:
            print_fn(f"timing run: {policy:9s} quant={quant}: {secs * 1e3:.1f} ms/iteration "
                     f"({measured[-1]['num_buckets']} buckets)")
    best = min(measured, key=lambda r: r["s_per_iteration"])

    # the measured seconds split over the blocks by the reference's RAM
    # heuristic (read_block_costs.cxx:69-87), as the JAX package does
    heur = {b.index: block_cost_heuristic(b.dim, b.num_points, b.bases_even.shape[1],
                                          b.bases_odd.shape[1], host_sdp.dual_dim)
            for b in host_sdp.blocks}
    scale = best["s_per_iteration"] / (sum(heur.values()) or 1.0)
    block_costs: Dict[str, float] = {str(idx): h * scale for idx, h in heur.items()}
    return {"version": 1, "measured": measured,
            "chosen": {"policy": best["policy"], "quant": best["quant"]},
            "block_costs": block_costs}


def bucketing(record: Optional[dict]) -> Tuple[str, int]:
    """(shape_policy, quant) a timing record chose; quantized 8 without
    one."""
    if record is None:
        return "quantized", 8
    return record["chosen"]["policy"], int(record["chosen"]["quant"])


def load_timings(ck_dir) -> Optional[dict]:
    path = Path(ck_dir) / TIMINGS_FILE
    if not path.exists():
        return None
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def save_timings(ck_dir, record: dict) -> None:
    ck = Path(ck_dir)
    ck.mkdir(parents=True, exist_ok=True)
    tmp = ck / (TIMINGS_FILE + ".tmp")
    tmp.write_text(json.dumps(record, indent=1))
    os.replace(tmp, ck / TIMINGS_FILE)
