"""Polynomial Matrix Program (PMP) input for the tools that drive the
solver (the port's copy of the readers of sdpb_tpu/convert/pmp.py):

  * NSV, null-separated file lists, recursive, entries relative to the
    list's directory (read_nsv_file_list.cxx:11-36);
  * the JSON PMP of docs/sdp2input_schema.json: objective, normalization,
    PositiveMatrixWithPrefactorArray[{DampedRational, polynomials}];
  * the index of the largest |normalization| component
    (max_normalization_index.hxx:5-16).

The Mathematica reader and the PMP -> SDP conversion are not ported; a
`.m` input is refused.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

import mpmath

from .poly import DampedRational, Polynomial, PositiveMatrixWithPrefactor


def read_nsv_paths(path) -> List[Path]:
    """Null-separated file list; entries resolve relative to the list's
    directory; .nsv entries recurse."""
    path = Path(path)
    out: List[Path] = []
    for entry in path.read_bytes().split(b"\0"):
        name = entry.decode().strip()
        if not name:
            continue
        sub = Path(name)
        if not sub.is_absolute():
            sub = path.parent / sub
        if sub.suffix == ".nsv":
            out.extend(read_nsv_paths(sub))
        else:
            out.append(sub)
    return out


def _poly_from_strings(coeffs) -> Polynomial:
    return Polynomial([mpmath.mpf(c) for c in coeffs])


def read_pmp_json(path) -> Tuple[List, List, List[PositiveMatrixWithPrefactor]]:
    """One JSON file -> (objective, normalization, matrices).  objective /
    normalization may be absent in continuation files (empty lists)."""
    data = json.loads(Path(path).read_text())
    objective = [mpmath.mpf(s) for s in data.get("objective", [])]
    normalization = [mpmath.mpf(s) for s in data.get("normalization", [])]
    matrices = []
    for entry in data.get("PositiveMatrixWithPrefactorArray", []):
        dr = entry["DampedRational"]
        damped = DampedRational(
            constant=mpmath.mpf(dr["constant"]),
            base=mpmath.mpf(dr["base"]),
            poles=[mpmath.mpf(p) for p in dr.get("poles", [])],
        )
        polys = [[[_poly_from_strings(p) for p in pv] for pv in row]
                 for row in entry["polynomials"]]
        matrices.append(PositiveMatrixWithPrefactor(
            damped_rational=damped, polynomials=polys))
    return objective, normalization, matrices


def read_pmp_input(path) -> Tuple[List, List, List[PositiveMatrixWithPrefactor]]:
    """Dispatch by extension (.nsv recursion, .json), with the reference's
    negative-pole validation (read_input.cxx:20-66)."""
    path = Path(path)
    if path.suffix == ".nsv":
        objective, normalization, matrices = [], [], []
        for sub in read_nsv_paths(path):
            o, n, m = read_pmp_input(sub)
            if o:
                objective = o
            if n:
                normalization = n
            matrices.extend(m)
    elif path.suffix == ".json":
        objective, normalization, matrices = read_pmp_json(path)
    elif path.suffix == ".m":
        raise ValueError(f"{path}: the Mathematica PMP reader is not ported to "
                         f"PyTorch (ROADMAP A18); write the PMP as JSON")
    else:
        raise ValueError(f"Unknown PMP input extension: {path}")
    for mat in matrices:
        for pole in mat.damped_rational.poles:
            # the reference rejects only strictly positive poles
            # (read_input.cxx:56-64); a pole at zero is legal
            if pole > 0:
                raise ValueError(
                    f"All poles must be negative, found: {pole}")
    return objective, normalization, matrices


def max_normalization_index(normalization) -> int:
    """Index of the largest |n_i|."""
    return max(range(len(normalization)), key=lambda i: abs(normalization[i]))
