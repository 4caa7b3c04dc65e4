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


# Bits that a scaled (float32-limb) Cholesky factor carries, whatever its
# limb count above 7: the scaled product drops a limb ~190 bits below its
# leading one, so rsqrt's Newton steps, and the factor built on them, stall
# near 2^-188 at Kf = 8 and 9 alike
# (tests/test_torch_kernels.py::test_scaled_rsqrt_and_factor_stall_near_2_pow_minus_188).
SCALED_FACTOR_BITS = 188


def refinement_passes(K: int, factor_limbs: int, scaled: bool) -> int:
    """Refinement passes of a mixed-precision solve that factors at
    `factor_limbs` and solves at K limbs: none where the factor has every
    limb, else the working bits over the bits the factor really carries,
    rounded up.  A classic factor carries 53 bits a limb, which gives the
    JAX package's ceil(K / Kf); a scaled one (one word, two or three words)
    24 a limb but at most SCALED_FACTOR_BITS, so that a wide 2 x 9 run at
    400 bits takes 3 passes and three words of 9 at 640 bits take 4, where
    ceil(K / Kf) gives 2 and 3 and leaves the solves short of the
    precision."""
    if K <= factor_limbs:
        return 0
    if not scaled:
        return -(-K // factor_limbs)
    return -(-(24 * K) // min(24 * factor_limbs, SCALED_FACTOR_BITS))
