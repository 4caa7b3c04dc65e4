"""Shared CLI plumbing (the port's copy of the option parsing of
sdpb_tpu/cli/common.py): paramFile layering and the camelCase solver
options of the reference's boost::program_options.  Every option can come
from a --paramFile of key=value lines; the command line overrides it.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..solver.params import SolverParameters


def read_param_file(path) -> dict:
    """key=value per line; '#' comments; whitespace tolerated."""
    out = {}
    for raw in Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" not in line:
            raise ValueError(f"Invalid paramFile line: {raw!r}")
        key, val = line.split("=", 1)
        out[key.strip()] = val.strip()
    return out


def add_solver_options(parser: argparse.ArgumentParser) -> None:
    d = SolverParameters()
    g = parser.add_argument_group("Solver parameters")
    g.add_argument("--precision", type=int, default=d.precision,
                   help="Working precision in bits (rounded up to a limb "
                        "multiple of the representation's base type).")
    g.add_argument("--findPrimalFeasible", action="store_true")
    g.add_argument("--findDualFeasible", action="store_true")
    g.add_argument("--detectPrimalFeasibleJump", action="store_true")
    g.add_argument("--detectDualFeasibleJump", action="store_true")
    g.add_argument("--maxIterations", type=int, default=d.max_iterations)
    g.add_argument("--maxRuntime", type=int, default=d.max_runtime)
    g.add_argument("--checkpointInterval", type=int, default=d.checkpoint_interval)
    g.add_argument("--dualityGapThreshold", default=d.duality_gap_threshold)
    g.add_argument("--primalErrorThreshold", default=d.primal_error_threshold)
    g.add_argument("--dualErrorThreshold", default=d.dual_error_threshold)
    g.add_argument("--initialMatrixScalePrimal", default=d.initial_matrix_scale_primal)
    g.add_argument("--initialMatrixScaleDual", default=d.initial_matrix_scale_dual)
    g.add_argument("--feasibleCenteringParameter", default=d.feasible_centering_parameter)
    g.add_argument("--infeasibleCenteringParameter", default=d.infeasible_centering_parameter)
    g.add_argument("--stepLengthReduction", default=d.step_length_reduction)
    g.add_argument("--minPrimalStep", default=d.min_primal_step)
    g.add_argument("--minDualStep", default=d.min_dual_step)
    g.add_argument("--maxComplementarity", default=d.max_complementarity)
    g.add_argument("--factorLimbs", type=int, default=d.factor_limbs,
                   help="Cholesky factor precision in limbs of the "
                        "mixed-precision solver (0 = auto-size from Omega "
                        "and the gap threshold + self-heal upward).")
    g.add_argument("--kktResidualThreshold",
                   default=d.kkt_residual_threshold,
                   help="Relative Schur solve-residual above which the "
                        "solver treats the factor as under-sized and "
                        "self-heals (0 disables).")


def solver_params_from_args(args) -> SolverParameters:
    return SolverParameters(
        precision=args.precision,
        find_primal_feasible=args.findPrimalFeasible,
        find_dual_feasible=args.findDualFeasible,
        detect_primal_feasible_jump=args.detectPrimalFeasibleJump,
        detect_dual_feasible_jump=args.detectDualFeasibleJump,
        max_iterations=args.maxIterations,
        max_runtime=args.maxRuntime,
        checkpoint_interval=args.checkpointInterval,
        duality_gap_threshold=args.dualityGapThreshold,
        primal_error_threshold=args.primalErrorThreshold,
        dual_error_threshold=args.dualErrorThreshold,
        initial_matrix_scale_primal=args.initialMatrixScalePrimal,
        initial_matrix_scale_dual=args.initialMatrixScaleDual,
        feasible_centering_parameter=args.feasibleCenteringParameter,
        infeasible_centering_parameter=args.infeasibleCenteringParameter,
        step_length_reduction=args.stepLengthReduction,
        min_primal_step=args.minPrimalStep,
        min_dual_step=args.minDualStep,
        max_complementarity=args.maxComplementarity,
        factor_limbs=args.factorLimbs,
        kkt_residual_threshold=args.kktResidualThreshold,
    )


def parse_with_param_file(parser: argparse.ArgumentParser, argv=None):
    """Two-pass parse: --paramFile values become defaults, CLI wins."""
    argv = list(sys.argv[1:] if argv is None else argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--paramFile", "-p", default=None)
    known, _ = pre.parse_known_args(argv)
    if known.paramFile:
        by_flag = {}
        for a in parser._actions:
            for s in a.option_strings:
                by_flag[s.lstrip("-")] = a
        defaults = {}
        for key, val in read_param_file(known.paramFile).items():
            action = by_flag.get(key)
            if action is None:
                raise SystemExit(f"Unknown option in paramFile: {key}")
            if isinstance(action, argparse._StoreTrueAction):
                defaults[action.dest] = val.lower() in ("1", "true", "yes")
            elif action.type is int:
                defaults[action.dest] = int(val)
            else:
                defaults[action.dest] = val
        parser.set_defaults(**defaults)
    return parser.parse_args(argv)
