"""Polynomial Matrix Program (PMP) input and the PMP -> PVM reduction of
sdp2input (the port's copy of sdpb_tpu/convert/pmp.py):

  * NSV, null-separated file lists, recursive, entries relative to the
    list's directory (read_nsv_file_list.cxx:11-36);
  * the JSON PMP of docs/sdp2input_schema.json: objective, normalization,
    PositiveMatrixWithPrefactorArray[{DampedRational, polynomials}], and
    the Mathematica `.m` PMP (convert/mathematica.py);
  * rescaled-Laguerre sample points x_k = (4k-1)^2 pi^2 /
    (-64 n log(3-2 sqrt(2))) (sample_points.cxx:9-25), and the sample
    scalings, the damped rational at the points (sample_scalings.cxx);
  * the bilinear basis orthonormal for the damped-rational measure on
    [0, inf): Hankel Gram matrix of the monomial moments -> Cholesky ->
    inverse (bilinear_basis.cxx:46-91).  The moments come from quadrature
    at the working precision, not the reference's expint recursions: the
    same integrals, robust for clustered poles;
  * the normalization eliminated into the component of largest
    |normalization| (write_output.cxx:22-36, 88-135).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

import mpmath

from .poly import (DampedRational, Polynomial, PolynomialVectorMatrix,
                   PositiveMatrixWithPrefactor)


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
    """Dispatch by extension (.nsv recursion, .json, .m Mathematica), with
    the reference's negative-pole validation (read_input.cxx:20-66)."""
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
        from .mathematica import read_pmp_mathematica

        objective, normalization, matrices = read_pmp_mathematica(path)
    else:
        raise ValueError(f"Unknown PMP input extension: {path}")
    for mat in matrices:
        for pole in mat.damped_rational.poles:
            # the reference rejects only strictly positive poles
            # (read_input.cxx:56-64); a pole at zero is legal: it enters the
            # sample scalings (x_k > 0) but not the bilinear basis' measure
            # (precompute.cxx:19-23)
            if pole > 0:
                raise ValueError(
                    f"All poles must be negative, found: {pole}")
    return objective, normalization, matrices


def sample_points(num_points: int) -> List[mpmath.mpf]:
    """Rescaled Laguerre: x_k = (4k-1)^2 * pi^2 / (-64 n log(rho)),
    rho = 3 - 2 sqrt(2) (sample_points.cxx:9-25)."""
    rho = 3 - 2 * mpmath.sqrt(2)
    constant = -mpmath.pi ** 2 / (64 * num_points * mpmath.log(rho))
    return [mpmath.mpf((4 * k - 1) ** 2) * constant for k in range(num_points)]


def sample_scalings(points, damped: DampedRational) -> List[mpmath.mpf]:
    return [damped(x) for x in points]


def _moment(damped: DampedRational, m: int) -> mpmath.mpf:
    """integral_0^inf x^m * constant * base^x / prod(x - p_i) dx by adaptive
    quadrature, split at the decay scale.  base < 1 and poles < 0 make the
    integrand smooth with exponential decay; callers drop the poles >= 0
    first (bilinear_basis)."""
    logb = mpmath.log(damped.base)
    if logb >= 0:
        raise ValueError("DampedRational base must be < 1 for convergence")

    def f(x):
        num = mpmath.power(damped.base, x) * mpmath.power(x, m)
        den = mpmath.mpf(1)
        for p in damped.poles:
            den *= (x - p)
        return num / den

    scale = (m + 1) / (-logb)
    val = mpmath.quad(f, [0, scale, 10 * scale, mpmath.inf])
    return damped.constant * val


def _moments_batch(damped: DampedRational, max_m: int) -> List[mpmath.mpf]:
    """The moments 0..max_m from one sweep of shared quadrature nodes: the
    weight w(x) = constant * base^x / prod(x - p_i) is evaluated once on
    tanh-sinh nodes over segments that double in length, and each moment is
    a weighted power sum over the same nodes.  Two node degrees must agree
    to the working precision; where they do not, every moment falls back
    to adaptive quadrature (_moment)."""
    logb = mpmath.log(damped.base)
    if logb >= 0:
        raise ValueError("DampedRational base must be < 1 for convergence")
    from mpmath.calculus.quadrature import TanhSinh

    scale = 1 / (-logb)
    # segments resolving both the region near 0 and the exponential tail of
    # the highest moment (its peak at m * scale)
    edges = [mpmath.mpf(0)]
    top = (max_m + 1) * scale * 8
    seg = scale / 4
    while edges[-1] < top:
        edges.append(min(edges[-1] + seg, top))
        seg *= 2

    def weight(x):
        den = mpmath.mpf(1)
        for p in damped.poles:
            den *= (x - p)
        return mpmath.exp(x * logb) / den

    prec = mpmath.mp.prec

    def sweep(degree):
        ts = TanhSinh(mpmath.mp)
        nodes = ts.calc_nodes(degree, prec + 20)
        moments = [mpmath.mpf(0)] * (max_m + 1)
        for a, b in zip(edges[:-1], edges[1:]):
            half = (b - a) / 2
            mid = (b + a) / 2
            for t, w in nodes:
                x = mid + half * t
                ww = w * half * weight(x)
                pw = ww
                moments[0] += pw
                for m in range(1, max_m + 1):
                    pw *= x
                    moments[m] += pw
        return moments

    with mpmath.workprec(prec + 20):
        lo = sweep(5)
        hi = sweep(6)
        ok = all(
            abs(a - b) <= mpmath.mpf(2) ** (-prec) * (abs(b) + mpmath.mpf(2) ** -prec)
            for a, b in zip(lo, hi))
        if ok:
            return [damped.constant * v for v in hi]
    return [_moment(damped, m) for m in range(max_m + 1)]


def bilinear_basis(damped: DampedRational, half_max_degree: int) -> List[Polynomial]:
    """Polynomials q_0..q_{half_max_degree} orthonormal for the measure:
    the Gram-Hankel matrix H[r][c] = moment(r+c), H = L L^T, and q_m's
    coefficients column m of L^{-T} (bilinear_basis.cxx:46-91)."""
    # poles >= 0 are left out of the measure, not of the sample scalings
    # (precompute.cxx:19-23)
    measure = DampedRational(
        constant=damped.constant, base=damped.base,
        poles=[p for p in damped.poles if p < 0])
    if measure.is_constant():
        return [Polynomial([1 / mpmath.sqrt(measure.constant)])]

    n = half_max_degree + 1
    table = _moments_batch(measure, 2 * half_max_degree)
    H = mpmath.matrix(n, n)
    for r in range(n):
        for c in range(n):
            H[r, c] = table[r + c]
    R = mpmath.cholesky(H)  # lower L with H = L L^T
    basis = []
    for m_idx in range(n):
        # back-substitute L^T q = e_{m_idx}
        q = [mpmath.mpf(0)] * n
        for i in range(n - 1, -1, -1):
            s = mpmath.mpf(1) if i == m_idx else mpmath.mpf(0)
            for j in range(i + 1, n):
                s -= R[j, i] * q[j]
            q[i] = s / R[i, i]
        # deg(q_m) = m: the trailing zeros go
        basis.append(Polynomial(q[: m_idx + 1]))
    return basis


def max_normalization_index(normalization) -> int:
    """Index of the largest |n_i| (max_normalization_index.hxx:5-16)."""
    return max(range(len(normalization)), key=lambda i: abs(normalization[i]))


def reduce_pmp(objective, normalization,
               matrices: List[PositiveMatrixWithPrefactor]):
    """Eliminate the normalization constraint n.y' = 1 by solving for the
    max-|n| component (write_output.cxx:22-36, 88-135).

    Returns (objective_const, dual_objective_b, [PolynomialVectorMatrix])
    with the sample points, scalings and bilinear bases filled in."""
    max_index = max_normalization_index(normalization)
    objective_const = objective[max_index] / normalization[max_index]
    b = [objective[i] - normalization[i] * objective_const
         for i in range(len(normalization)) if i != max_index]

    pvms = []
    for mat in matrices:
        max_degree = max(p.degree for row in mat.polynomials
                         for pv in row for p in pv)
        points = sample_points(max_degree + 1)
        rows = len(mat.polynomials)
        cols = len(mat.polynomials[0])
        # elements in elt(r, c) = elements[r + c * rows] order
        flat = [None] * (rows * cols)
        for r in range(rows):
            for c in range(cols):
                pv = mat.polynomials[r][c]
                const = _poly_scale(pv[max_index], 1 / normalization[max_index])
                vec = [const]
                for i in range(len(normalization)):
                    if i != max_index:
                        vec.append(_poly_axpy(pv[i], -normalization[i], const))
                flat[r + c * rows] = vec
        pvms.append(PolynomialVectorMatrix(
            rows=rows, cols=cols, elements=flat, sample_points=points,
            sample_scalings=sample_scalings(points, mat.damped_rational),
            bilinear_basis=bilinear_basis(mat.damped_rational, max_degree // 2)))
    return objective_const, b, pvms


def _poly_scale(p: Polynomial, s) -> Polynomial:
    return Polynomial([c * s for c in p.coefficients])


def _poly_axpy(p: Polynomial, a, q: Polynomial) -> Polynomial:
    """p + a*q with ragged coefficient lists (write_output.cxx:105-132)."""
    n = max(len(p.coefficients), len(q.coefficients))
    out = []
    for i in range(n):
        cp = p.coefficients[i] if i < len(p.coefficients) else mpmath.mpf(0)
        cq = q.coefficients[i] if i < len(q.coefficients) else mpmath.mpf(0)
        out.append(cp + a * cq)
    return Polynomial(out)
