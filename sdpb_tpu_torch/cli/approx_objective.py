"""`approx_objective` on one PyTorch device: the linear and quadratic
objective of perturbed SDPs from one solved SDP (the port of
sdpb_tpu/cli/approx_objective.py; the reference's approx_objective/main.cxx).

    python -m sdpb_tpu_torch.cli.approx_objective --sdp sdp.zip \
        --newSdp new.zip --precision 216 [--solutionDir sdp_out] [--linear] \
        [--writeSolverState] [--arithmetic classic|scaled] [--device cuda|cpu]

Needs the solution written with --writeSolution=x,y,X,Y (the X/Y state
rebuilds the frozen Schur solver).  Prints a JSON array of {path,
objective, d_objective, dd_objective}, as the JAX CLI does.  --newSdp is a
zip, a directory, or an .nsv list of them.  The representation and the
device come from the flags of the port's sdpb CLI: classic float64 limbs
by default (on the card up to --precision 681), --arithmetic scaled for
float32 limbs with an exponent (one word up to --precision 208, two words
up to 424, three up to 640), on the card unless
--device cpu (or --platform cpu) asks for the CPU.  The JAX CLI picks the
representation by platform and runs on the CPU unless told otherwise.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import mpmath
import numpy as np

from .sdpb import check_precision, limbs_for_precision, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="approx_objective")
    p.add_argument("--sdp", required=True)
    p.add_argument("--newSdp", required=True,
                   help="Perturbed SDP (zip/dir), or .nsv list of them")
    p.add_argument("--precision", type=int, required=True)
    p.add_argument("--solutionDir", default=None,
                   help="Default: sdp path with '_out' appended")
    p.add_argument("--linear", action="store_true",
                   help="Only compute the linear approximation")
    p.add_argument("--writeSolverState", action="store_true",
                   help="Serialize the frozen Schur solver (S-Cholesky, "
                        "S^-1 B, Q) into solutionDir/solver_state.npz so "
                        "later invocations skip the rebuild")
    p.add_argument("--procsPerNode", type=int, default=0,
                   help="Accepted for reference compatibility.")
    p.add_argument("--arithmetic", choices=("classic", "scaled"), default="classic",
                   help="MP representation, as the sdpb CLI's.")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' only when asked "
                        "for by name).")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto",
                   help="'cpu' runs on the CPU (--device cpu); 'auto' keeps "
                        "--device.")
    return p


def _mpf(v) -> mpmath.mpf:
    """The exact value of an MP scalar (classic, scaled or wide)."""
    from ..utils.strings import limbs_to_mpf, scaled_limbs_to_mpf, wide_limbs_to_mpf

    if hasattr(v, "words"):
        return wide_limbs_to_mpf([(w.limbs.cpu().numpy(), int(w.exp)) for w in v.words])
    if v.scaled:
        return scaled_limbs_to_mpf(v.limbs.cpu().numpy(), int(v.exp))
    return limbs_to_mpf(v.limbs.cpu().numpy())


def run(argv=None, timings: dict = None) -> list:
    """Parse, approximate and return the results (main prints them).
    `timings`, when given, receives the seconds of the frozen solver's
    setup (or load) and of each new SDP, and the warning printed when the
    representation is too narrow for the quadratic term at the solution's
    duality gap (None when it is not)."""
    import time

    import torch

    args = build_parser().parse_args(argv)
    scaled_limbs = check_precision(args.arithmetic, args.precision, args.device,
                                   args.platform)
    device = resolve_device(args.device, args.platform)

    from ..io.sdp_zip import read_sdp
    from ..models.sdp import build_device_sdp
    from ..ops.mpfloat import MAX_SCALED_K
    from ..solver.checkpoint import load_text_checkpoint
    from ..solver.params import refinement_passes
    from ..tools.approx_objective import (approx_objective, duality_gap,
                                          load_reference_solver_state, load_solver_state,
                                          quadratic_precision_warning, save_solver_state,
                                          sdp_delta_buckets, setup_frozen_schur,
                                          stage_host_mp, working_bits)

    if scaled_limbs:
        K = -(-(24 * scaled_limbs) // 53) + 1      # float64 host limbs
    else:
        K = limbs_for_precision(args.precision)
    base = args.sdp[:-4] if args.sdp.endswith(".zip") else args.sdp
    solution_dir = Path(args.solutionDir or (base + "_out"))
    timings = {} if timings is None else timings

    host_old = read_sdp(args.sdp, K, np.float64)
    sdp = build_device_sdp(host_old, device, scaled_limbs=scaled_limbs)
    state = load_text_checkpoint(solution_dir, sdp, verbosity=0)

    # the frozen Schur solver factors S at the SOLVED point, where cond(S)
    # ~ 1/gap^2 is largest: full factor precision (at most 9 limbs scaled
    # and wide, where the factorizations stay on one scaled word and the
    # refinement recovers the rest)
    K_dev = sdp.b.K
    factor_limbs = min(K_dev, MAX_SCALED_K) if scaled_limbs else K
    n_refine = max(1, refinement_passes(K_dev, factor_limbs, bool(scaled_limbs)))

    frozen = None
    state_path = solution_dir / "solver_state.npz"
    timings["warning"] = None
    if not args.linear:
        gap = float(_mpf(duality_gap(sdp, state)))
        timings["warning"] = quadratic_precision_warning(working_bits(sdp), gap)
        if timings["warning"]:
            print(f"approx_objective: warning: {timings['warning']}", file=sys.stderr)
        t0 = time.time()
        loaded = load_solver_state(state_path, device)
        if loaded is not None and loaded[1] == factor_limbs:
            frozen = loaded[0]
            timings["frozen"] = "npz"
        else:
            # the reference's --writeSolverState text blocks
            frozen = load_reference_solver_state(solution_dir, sdp, factor_limbs, n_refine)
            timings["frozen"] = "reference text"
        if frozen is None:
            frozen = setup_frozen_schur(sdp, state, factor_limbs, n_refine)
            timings["frozen"] = "setup"
            if args.writeSolverState:
                save_solver_state(state_path, frozen, factor_limbs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings["frozen_s"] = time.time() - t0

    new_paths = [args.newSdp]
    if args.newSdp.endswith(".nsv"):
        from ..convert.pmp import read_nsv_paths

        new_paths = [str(s) for s in read_nsv_paths(args.newSdp)]

    ndigits = int(args.precision * 0.30103) + 1

    def s(v) -> str:
        return mpmath.nstr(_mpf(v), ndigits, strip_zeros=False, min_fixed=1, max_fixed=0)

    results = []
    timings["new_sdp_s"] = []
    for path in new_paths:
        t0 = time.time()
        host_new = read_sdp(path, K, np.float64)
        d_cs, d_Bs = sdp_delta_buckets(sdp, host_old, host_new, scaled_limbs)
        d_const = stage_host_mp(host_new.objective_const - host_old.objective_const,
                                scaled_limbs, device)
        d_b = stage_host_mp(host_new.b - host_old.b, scaled_limbs, device)
        total, d_obj, dd_obj = approx_objective(
            sdp, state, frozen, d_const, d_b, d_cs, d_Bs, factor_limbs, n_refine,
            quadratic=not args.linear)
        results.append({
            "path": str(path),
            "objective": s(total),
            "d_objective": s(d_obj),
            "dd_objective": s(dd_obj),
        })
        timings["new_sdp_s"].append(time.time() - t0)
    return results


def main(argv=None) -> int:
    print(json.dumps(run(argv), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
