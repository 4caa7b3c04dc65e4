"""`outer_limits` on one PyTorch device: the cutting-plane optimizer over
function blocks (the port of sdpb_tpu/cli/outer_limits.py; the reference's
outer_limits/main.cxx).

    python -m sdpb_tpu_torch.cli.outer_limits --functions functions.json \
        --points points.json --out out.json --precision 216 \
        --dualityGapThreshold 1e-10 [--dualityGapReduction 1024] \
        [--meshThreshold 0.001] [--useSVD true] [--device cuda|cpu] \
        + the shared solver options

The flags and out.json are the JAX CLI's.  Each round's SDP is solved in
classic float64 limbs, as there, but on the card by default: the JAX CLI
always solves on the CPU; here the CPU is used only when asked for, by
--device cpu (or --platform cpu).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import mpmath

from .common import add_solver_options, parse_with_param_file, solver_params_from_args
from .sdpb import resolve_device


def build_parser():
    p = argparse.ArgumentParser(
        prog="outer_limits", description="Cutting-plane SDP optimizer")
    p.add_argument("--functions", required=True,
                   help="JSON or NSV file with SDP functions")
    p.add_argument("--points", required=True,
                   help="JSON or NSV file with initial points")
    p.add_argument("--out", "-o", default="out.json")
    p.add_argument("--paramFile", "-p", default=None)
    p.add_argument("--checkpointDir", "-c", default=None)
    p.add_argument("--dualityGapReduction", default="1024")
    p.add_argument("--meshThreshold", default="0.001")
    p.add_argument("--useSVD", default="true")
    p.add_argument("--verbosity", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="torch device to solve on (default cuda; 'cpu' only "
                        "when asked for by name).")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto",
                   help="'cpu' solves on the CPU (--device cpu); 'auto' keeps "
                        "--device.")
    add_solver_options(p)
    return p


def read_points(path) -> list:
    """points JSON {"points": [[...]]} with .nsv recursion
    (read_points.cxx)."""
    from ..convert.pmp import read_nsv_paths

    path = Path(path)
    if path.suffix == ".nsv":
        out = []
        for sub in read_nsv_paths(path):
            out.extend(read_points(sub))
        return out
    doc = json.loads(path.read_text())
    return [[mpmath.mpf(v) for v in block] for block in doc["points"]]


def run(argv=None, rounds=None) -> dict:
    """Parse, optimize and write out.json; returns its document.  `rounds`
    as compute_optimal's."""
    args = parse_with_param_file(build_parser(), argv)
    params = solver_params_from_args(args)
    device = resolve_device(args.device, args.platform)

    from ..tools.functions import read_functions_json
    from ..tools.outer_limits import compute_optimal

    with mpmath.workprec(params.precision):
        objectives, normalization, functions = read_functions_json(args.functions)
        initial_points = read_points(args.points)
        weights, y = compute_optimal(
            functions, initial_points, objectives, normalization, params,
            duality_gap_reduction=mpmath.mpf(args.dualityGapReduction),
            mesh_threshold=mpmath.mpf(args.meshThreshold),
            use_svd=str(args.useSVD).lower() in ("1", "true", "yes"),
            verbosity=args.verbosity, checkpoint_dir=args.checkpointDir,
            device=device, rounds=rounds)

        optimal = mpmath.fsum(o * w for o, w in zip(objectives, weights))
        ndigits = int(params.precision * 0.30103) + 1

        def s(v):
            return mpmath.nstr(v, ndigits, strip_zeros=False,
                               min_fixed=1, max_fixed=0)

        out = {
            "optimal": s(optimal),
            "y": [s(w) for w in weights],
            "options": {k: str(v) for k, v in vars(args).items()},
        }
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=2))
        if args.verbosity >= 1:
            print(f"optimal = {s(optimal)}")
            print(f"wrote {args.out}")
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
