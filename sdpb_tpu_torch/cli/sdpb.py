"""`sdpb` on one PyTorch device: solve a preprocessed SDP.

    python -m sdpb_tpu_torch.cli.sdpb -s sdp.zip --precision 216 \
        [--arithmetic classic|scaled] [--device cuda|cpu]

Same solver flags and the same output files as the JAX package's CLI
(sdpb_tpu/cli/sdpb.py).  `--arithmetic` picks the representation, which the
JAX CLI picks by platform: classic float64 limbs (the default; any
precision) or scaled float32 limbs with an int32 exponent per element: up
to 9 limbs (216 bits) one scaled word, 10-18 limbs (--precision 209-424,
covering the reference's default 400) the wide representation of two
words of Kg limbs.  More than 18 scaled limbs (three words) are refused.
The device defaults to `cuda` and is never chosen silently: without CUDA
the run stops unless `--device cpu` is given.  Checkpoints are not written
yet, and resuming one or running several processes is refused.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from .common import add_solver_options, parse_with_param_file, solver_params_from_args

_REFUSED = ("initialCheckpointDir", "coordinator", "numProcesses", "processId")
# two scaled words of at most 9 limbs: the wide GEMM kernel takes G = 2
MAX_WIDE_LIMBS = 18


def limbs_for_precision(precision_bits: int, mant_bits: int = 53) -> int:
    """Limbs of `mant_bits` for `precision_bits` of significand (8 guard
    bits; sdpb_tpu/utils/platform.py:50-60)."""
    return max(2, -(-(precision_bits + 8) // mant_bits))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdpb", description="SDPB on PyTorch: semidefinite program solver")
    p.add_argument("--sdpDir", "-s", required=True,
                   help="Directory or zip containing preprocessed SDP data files.")
    p.add_argument("--paramFile", "-p", default=None,
                   help="Optional key=value file; command line overrides it.")
    p.add_argument("--outDir", "-o", default=None,
                   help="Output directory (default: sdpDir + '_out').")
    p.add_argument("--checkpointDir", "-c", default=None,
                   help="Checkpoint directory (accepted; no checkpoint is "
                        "written yet).")
    p.add_argument("--noFinalCheckpoint", action="store_true",
                   help="Accepted; no checkpoint is written yet.")
    p.add_argument("--writeSolution", default="x,y",
                   help="Comma-separated list among x,y,X,Y.")
    p.add_argument("--procsPerNode", type=int, default=0,
                   help="Accepted for reference compatibility.")
    p.add_argument("--procGranularity", type=int, default=1,
                   help="Accepted for reference compatibility.")
    p.add_argument("--verbosity", type=int, default=1,
                   help="0 -> no output, 1 -> regular output, 2 -> debug")
    p.add_argument("--device", default="cuda",
                   help="torch device to solve on (default cuda; 'cpu' only "
                        "when asked for by name).")
    p.add_argument("--arithmetic", choices=("classic", "scaled"), default="classic",
                   help="MP representation: classic float64 limbs (any "
                        "precision) or scaled float32 limbs with an int32 "
                        "exponent per element (one word up to 216 bits, two "
                        "words up to 424).")
    for name in _REFUSED:
        p.add_argument(f"--{name}", default=None, help=argparse.SUPPRESS)
    add_solver_options(p)
    return p


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: CUDA is not available "
                         f"(pass --device cpu to solve on the CPU)")
    return device


def run(argv=None):
    """Parse, solve and write the solution; returns the SolveResult."""
    args = parse_with_param_file(build_parser(), argv)
    for name in _REFUSED:
        if getattr(args, name) is not None:
            raise SystemExit(f"--{name} is not supported by the PyTorch port "
                             f"yet (no checkpoints, one process, one device)")
    params = solver_params_from_args(args)
    scaled_limbs = 0
    if args.arithmetic == "scaled":
        scaled_limbs = limbs_for_precision(params.precision, 24)
        if scaled_limbs > MAX_WIDE_LIMBS:
            raise SystemExit(
                f"--precision {params.precision} needs {scaled_limbs} scaled "
                f"float32 limbs; the port's wide representation holds at most "
                f"{MAX_WIDE_LIMBS} (two words, --precision 424), three words "
                f"are not ported (ROADMAP B7).  Use --arithmetic classic.")
    device = resolve_device(args.device)

    from ..io.sdp_zip import read_sdp
    from ..io.solution import WriteSolution, mp_str, save_solution
    from ..models.sdp import build_device_sdp
    from ..solver.solve import run_solver
    from ..utils.timers import Timers

    sdp_path = args.sdpDir
    base = sdp_path[:-4] if sdp_path.endswith(".zip") else sdp_path
    out_dir = Path(args.outDir or (base + "_out"))
    write_solution = WriteSolution.parse(args.writeSolution)
    verbosity = args.verbosity
    if scaled_limbs:
        K = -(-(24 * scaled_limbs) // 53) + 1      # float64 host limbs
        mant_bits, K_dev = 24, scaled_limbs
    else:
        K = limbs_for_precision(params.precision)
        mant_bits, K_dev = 53, K
    if verbosity >= 1:
        print("SDPB PyTorch solver")
        print(f"SDP directory   : {sdp_path}")
        print(f"out directory   : {out_dir}")
        if scaled_limbs > 9:
            from ..ops.mpwide import wide_config
            G, Kg = wide_config(scaled_limbs)
            print(f"precision       : {params.precision} bits ({G} words × {Kg} "
                  f"scaled float32 limbs)")
        elif scaled_limbs:
            print(f"precision       : {params.precision} bits ({scaled_limbs} "
                  f"scaled float32 limbs + exponent)")
        else:
            print(f"precision       : {params.precision} bits ({K} x float64 limbs)")
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(f"device          : {device} ({name})")

    timers = Timers()
    with timers.scope("read_sdp"):
        host = read_sdp(sdp_path, K, np.float64)
    sdp = build_device_sdp(host, device, scaled_limbs=scaled_limbs)
    result = run_solver(sdp, params, verbosity=verbosity, timers=timers)

    if verbosity >= 1:
        print(f"-----{result.terminate_reason}-----")
        nd = int(mant_bits * K_dev * 0.30103) + 1
        print(f"primalObjective = {mp_str(result.primal_objective, nd)}")
        print(f"dualObjective   = {mp_str(result.dual_objective, nd)}")
        print(f"dualityGap      = {mp_str(result.duality_gap, nd)}")
        print(f"primalError     = {mp_str(result.primal_error, nd)}")
        print(f"dualError       = {mp_str(result.dual_error, nd)}")
        print("checkpoint      : not written (checkpoints are not ported yet)")
    save_solution(out_dir, result, sdp, write_solution, verbosity=verbosity)
    if verbosity >= 2:
        print(timers.to_json())
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
