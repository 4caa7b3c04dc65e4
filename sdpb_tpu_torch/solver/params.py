"""Solver parameters, flag for flag with the reference's Solver_Parameters
(the port's copy of sdpb_tpu/solver/params.py).

Numeric parameters are decimal strings, parsed exactly into MP limbs or
mpmath values where they are used.  `precision` is in bits of significand
and maps to the limb count of the chosen representation.
"""
from __future__ import annotations

import sys
from dataclasses import asdict, dataclass


@dataclass
class SolverParameters:
    precision: int = 96
    find_primal_feasible: bool = False
    find_dual_feasible: bool = False
    detect_primal_feasible_jump: bool = False
    detect_dual_feasible_jump: bool = False
    max_iterations: int = 500
    max_runtime: int = sys.maxsize
    checkpoint_interval: int = 3600
    duality_gap_threshold: str = "1e-30"
    primal_error_threshold: str = "1e-30"
    dual_error_threshold: str = "1e-30"
    initial_matrix_scale_primal: str = "1e20"
    initial_matrix_scale_dual: str = "1e20"
    feasible_centering_parameter: str = "0.1"
    infeasible_centering_parameter: str = "0.3"
    step_length_reduction: str = "0.7"
    min_primal_step: str = "0"
    min_dual_step: str = "0"
    max_complementarity: str = "1e100"
    checkpoint_dir: str = ""
    initial_checkpoint_dir: str = ""
    # Cholesky factor precision in limbs of the mixed-precision solves;
    # 0 sizes it from Omega and the gap threshold and heals upward
    factor_limbs: int = 0
    # relative Schur solve residual above which the factor counts as
    # under-sized (heal below the cap, warn at it); "0" disables the guard
    kkt_residual_threshold: str = "1e-2"

    def to_dict(self):
        return asdict(self)
