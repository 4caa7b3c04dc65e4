"""`sdp2functions`: JSON or NSV PMP -> functions JSON for outer_limits
(the port of sdpb_tpu/cli/sdp2functions.py; the reference's
sdp2functions/main.cxx + write_functions.cxx: polynomials evaluated at
Chebyshev zeros on [0, 6*max_terms]).  Host mpmath only.

    python -m sdpb_tpu_torch.cli.sdp2functions -i pmp.json -o functions.json \
        --precision 216
"""
from __future__ import annotations

import argparse
import sys

import mpmath


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sdp2functions")
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--precision", type=int, required=True)
    args = p.parse_args(argv)

    from ..convert.pmp import read_pmp_input
    from ..tools.functions import write_functions_json

    with mpmath.workprec(args.precision):
        objective, normalization, matrices = read_pmp_input(args.input)
        blocks = []
        for mat in matrices:
            rows = len(mat.polynomials)
            cols = len(mat.polynomials[0])
            max_terms = max(len(p_.coefficients) for row in mat.polynomials
                            for pv in row for p_ in pv)
            max_delta = mpmath.mpf(6 * max_terms)
            blocks.append((rows, cols,
                           (lambda m: lambda r, c: m.polynomials[r][c])(mat),
                           max_delta))
        ndigits = int(args.precision * 0.30103) + 1
        write_functions_json(args.output, objective, normalization, blocks,
                             ndigits)
    print(f"wrote {len(blocks)} function blocks to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
