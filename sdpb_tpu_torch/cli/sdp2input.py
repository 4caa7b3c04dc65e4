"""`sdp2input`: PMP (JSON, Mathematica or NSV) -> sdp.zip (the port of
sdpb_tpu/cli/sdp2input.py, after the reference's sdp2input/main.cxx).

It reads a polynomial matrix program with its normalization, eliminates the
normalization into the objective, samples each matrix at rescaled-Laguerre
points with damped-rational scalings and bilinear bases orthonormal for the
measure, and writes SDPB input files.  Host mpmath only; the values go out
through K = max(2, ceil(precision / 53)) float64 limbs.

    python -m sdpb_tpu_torch.cli.sdp2input -i pmp.json -o sdp.zip \
        --precision 400 [--outputFormat bin|json] [--procs N]
"""
from __future__ import annotations

import argparse
import sys

import mpmath
import numpy as np


def convert(input_path, output_path, precision: int,
            block_format: str = "bin", command: str = "",
            procs: int = 1) -> int:
    from ..convert.dual_constraint_group import assemble_sdp
    from ..convert.pmp import read_pmp_input, reduce_pmp
    from ..io.sdp_zip import write_sdp

    with mpmath.workprec(precision):
        objective, normalization, matrices = read_pmp_input(input_path)
        if not objective or not normalization:
            raise ValueError("PMP input must define objective and normalization")
        objective_const, b, pvms = reduce_pmp(objective, normalization, matrices)
        K = max(2, -(-precision // 53))
        sdp = assemble_sdp(objective_const, b, pvms, K, np.float64, procs=procs)
        write_sdp(output_path, sdp, command=command,
                  block_format=block_format, precision=precision)
    return len(pvms)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="sdp2input", description="PMP -> SDPB input converter")
    p.add_argument("--input", "-i", required=True,
                   help="PMP file: .json, .m (Mathematica), or .nsv list")
    p.add_argument("--output", "-o", required=True,
                   help="Output sdp.zip (or directory)")
    p.add_argument("--precision", type=int, required=True,
                   help="Working precision in bits")
    p.add_argument("--outputFormat", choices=["bin", "json"], default="bin")
    p.add_argument("--procs", type=int, default=1,
                   help="Sample blocks in a pool of spawned processes (the "
                        "reference deals blocks round-robin to MPI ranks); the "
                        "output is the same for any count")
    p.add_argument("--debug", action="store_true")
    args = p.parse_args(argv)
    n = convert(args.input, args.output, args.precision, args.outputFormat,
                command="sdp2input " + " ".join(sys.argv[1:]),
                procs=args.procs)
    print(f"wrote {n} blocks to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
