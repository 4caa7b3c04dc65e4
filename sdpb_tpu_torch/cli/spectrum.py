"""`spectrum`: the operator spectrum of a solved SDP (the port of
sdpb_tpu/cli/spectrum.py, after the reference's spectrum/main.cxx and
handle_arguments.cxx).  It reads x_<i>.txt and y.txt as the sdpb CLI
writes them (--writeSolution x,y).  Host mpmath only.

    python -m sdpb_tpu_torch.cli.spectrum --input pmp.json|pvm.xml \
        --solution out_dir --threshold 1e-10 --format PMP|PVM \
        --output spectrum.json --precision 768 [--meshThreshold 0.001] \
        [--lambda true|false]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import mpmath


def _read_x_vectors(solution_dir: Path, num_blocks: int):
    """x_<i>.txt as flat mpmath vectors (after read_x.cxx)."""
    xs = []
    for i in range(num_blocks):
        tokens = (solution_dir / f"x_{i}.txt").read_text().split()
        h, w = int(tokens[0]), int(tokens[1])
        if w != 1:
            raise ValueError(f"x_{i}.txt: a {h} x {w} matrix, expected one column")
        xs.append([mpmath.mpf(t) for t in tokens[2:2 + h]])
    return xs


def _read_y(solution_dir: Path):
    tokens = (solution_dir / "y.txt").read_text().split()
    h = int(tokens[0])
    return [mpmath.mpf(t) for t in tokens[2:2 + h]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="spectrum", description="Operator spectrum extraction")
    p.add_argument("--input", required=True,
                   help="PMP (.json/.m/.nsv) or PVM (.xml) input")
    p.add_argument("--solution", required=True,
                   help="Directory with x_<i>.txt and y.txt")
    p.add_argument("--threshold", required=True,
                   help="Zero-detection threshold")
    p.add_argument("--meshThreshold", default="0.001")
    p.add_argument("--format", required=True, choices=["PVM", "PMP"])
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--precision", type=int, required=True)
    p.add_argument("--lambda", dest="need_lambda", default="true",
                   help="Compute OPE coefficients (true/false)")
    args = p.parse_args(argv)

    from ..tools.spectrum import (compute_spectrum_pmp, compute_spectrum_pvm,
                                  write_spectrum_json)

    need_lambda = str(args.need_lambda).lower() in ("1", "true", "yes")
    solution = Path(args.solution)

    with mpmath.workprec(args.precision):
        threshold = mpmath.mpf(args.threshold)
        mesh_threshold = mpmath.mpf(args.meshThreshold)
        y = _read_y(solution)

        if args.format == "PMP":
            from ..convert.pmp import read_pmp_input

            objective, normalization, matrices = read_pmp_input(args.input)
            xs = _read_x_vectors(solution, len(matrices))
            zeros = compute_spectrum_pmp(normalization, y, matrices, xs,
                                         threshold, mesh_threshold, need_lambda)
        else:
            from ..convert.xml_input import read_pvm_xml

            _, matrices = read_pvm_xml(args.input)
            xs = _read_x_vectors(solution, len(matrices))
            zeros = compute_spectrum_pvm(y, matrices, xs, threshold,
                                         mesh_threshold, need_lambda)

        ndigits = int(args.precision * 0.30103) + 1
        write_spectrum_json(args.output, zeros, ndigits)
    print(f"wrote spectrum for {len(zeros)} blocks to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
