"""`pvm2functions`: XML PVM -> functions JSON for outer_limits (the port of
sdpb_tpu/cli/pvm2functions.py, after the reference's pvm2functions/: the
polynomials evaluated at Chebyshev zeros on [0, 8*max(sample_points)]; the
normalization implicitly (1, 0, ...)).  Host mpmath only.

    python -m sdpb_tpu_torch.cli.pvm2functions -i pvm.xml -o functions.json \
        --precision 216
"""
from __future__ import annotations

import argparse
import sys

import mpmath


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pvm2functions")
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--precision", type=int, required=True)
    args = p.parse_args(argv)

    from ..convert.pmp import read_nsv_paths
    from ..convert.xml_input import read_pvm_xml
    from ..tools.functions import write_functions_json

    files = ([str(f) for f in read_nsv_paths(args.input)]
             if str(args.input).endswith(".nsv") else [args.input])

    with mpmath.workprec(args.precision):
        objective = None
        matrices = []
        for f in files:
            obj, mats = read_pvm_xml(f)
            if obj:
                objective = obj
            matrices.extend(mats)
        if objective is None:
            raise ValueError("no objective found")
        normalization = [mpmath.mpf(0)] * len(objective)
        normalization[0] = mpmath.mpf(1)
        blocks = []
        for mat in matrices:
            max_delta = 8 * max(mpmath.mpf(x) for x in mat.sample_points)
            blocks.append((mat.rows, mat.cols,
                           (lambda m: lambda r, c: m.elt(r, c))(mat),
                           max_delta))
        ndigits = int(args.precision * 0.30103) + 1
        write_functions_json(args.output, objective, normalization, blocks,
                             ndigits)
    print(f"wrote {len(blocks)} function blocks to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
