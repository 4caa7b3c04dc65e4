"""Spectrum extraction: operator locations (zeros of the optimal functional)
and OPE coefficients (lambda) from a solved SDP (the port's copy of
sdpb_tpu/tools/spectrum.py; host mpmath, after the reference's spectrum/):
  * weights from (normalization, y) — fill_weights.hxx:6-20
  * per block, the y-weighted polynomial matrix is scanned on an adaptive
    Mesh over [0, 6*max_terms] (compute_spectrum_pmp.cxx:74-96; factor 6 =
    limiting scale of Laguerre roots); matrix blocks are reduced to their
    smallest eigenvalue (eval_summed.cxx)
  * zeros: quadratic-fit minima below threshold*f'' (get_zeros.cxx)
  * --lambda: least-squares fit of the x vector at the zeros via Lagrange
    interpolation + SVD pseudoinverse (compute_lambda.cxx:30-160); each
    zero's lambda = sqrt(lambda_max) * top eigenvector of the fitted
    Lambda matrix, dropped when the matrix has no nonnegative eigenvalue
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import mpmath

from ..convert.pmp import max_normalization_index, sample_points, sample_scalings
from ..convert.poly import Polynomial, PolynomialVectorMatrix, PositiveMatrixWithPrefactor
from .mesh import Mesh, get_zeros


@dataclass
class Zero:
    zero: mpmath.mpf
    Lambda: Optional[List] = None


@dataclass
class Zeros:
    zeros: List[Zero] = field(default_factory=list)
    error: Optional[mpmath.mpf] = None


def fill_weights(y: List, max_index: int, normalization: List) -> List:
    """weights with dot(normalization, weights) = 1 (fill_weights.hxx:6-20)."""
    weights = [mpmath.mpf(0)] * len(normalization)
    weights[max_index] = mpmath.mpf(1)
    for block_row in range(len(y)):
        index = block_row + (0 if block_row < max_index else 1)
        weights[index] = y[block_row]
        weights[max_index] -= weights[index] * normalization[index]
    weights[max_index] /= normalization[max_index]
    return weights


def _min_eig_sym(M: mpmath.matrix) -> mpmath.mpf:
    if M.rows == 1:
        return M[0, 0]
    E, _ = mpmath.eigsy(M)
    return min(E[i] for i in range(M.rows))


def _summed_scan(rows: int, summed, prefactor, max_delta, block_scale,
                 mesh_threshold, threshold):
    """Mesh-scan prefactor(x) * lambda_min(sum_n w_n M_n(x)) for zeros."""
    eps = mpmath.mpf(2) ** (1 - mpmath.mp.prec)
    block_epsilon = block_scale * eps

    if rows == 1:
        def fn(x):
            return prefactor(x) * summed[0][0](x)
    else:
        def fn(x):
            M = mpmath.matrix(rows, rows)
            for r in range(rows):
                for c in range(r + 1):
                    v = summed[r][c](x)
                    M[r, c] = v
                    M[c, r] = v
            return prefactor(x) * _min_eig_sym(M)

    mesh = Mesh.create(mpmath.mpf(0), max_delta, fn, mesh_threshold, block_epsilon)
    return get_zeros(mesh, threshold)


def _sum_polynomials(rows, cols, get_pv, weights, max_terms):
    """summed[r][c](x) = sum_n weights[n] * P^{rc}_n(x); returns (summed as
    callables of Polynomial type, block_scale)."""
    block_scale = mpmath.mpf(0)
    summed = []
    for r in range(rows):
        row_out = []
        for c in range(cols):
            coeffs = [mpmath.mpf(0)] * max_terms
            for n, poly in enumerate(get_pv(r, c)):
                for ci, cf in enumerate(poly.coefficients):
                    product = weights[n] * cf
                    block_scale = max(block_scale, abs(product))
                    coeffs[ci] += product
            row_out.append(Polynomial(coeffs))
        summed.append(row_out)
    return summed, block_scale


def compute_spectrum_pmp(normalization, y, matrices: List[PositiveMatrixWithPrefactor],
                         x_vectors, threshold, mesh_threshold,
                         need_lambda: bool) -> List[Zeros]:
    max_index = max_normalization_index(normalization)
    weights = fill_weights(y, max_index, normalization)
    out = []
    for bi, block in enumerate(matrices):
        max_terms = max(len(p.coefficients) for row in block.polynomials
                        for pv in row for p in pv)
        max_delta = mpmath.mpf(6 * max_terms)
        rows = len(block.polynomials)
        summed, scale = _sum_polynomials(
            rows, len(block.polynomials[0]),
            lambda r, c: block.polynomials[r][c], weights, max_terms)
        zero_vector = _summed_scan(rows, summed, block.damped_rational,
                                   max_delta, scale, mesh_threshold, threshold)
        zb = Zeros()
        if need_lambda:
            pts = sample_points(max_terms)
            scl = sample_scalings(pts, block.damped_rational)
            compute_lambda(pts, scl, rows, x_vectors[bi], zero_vector, zb)
        else:
            zb.zeros = [Zero(z) for z in zero_vector]
        out.append(zb)
    return out


def compute_spectrum_pvm(y, matrices: List[PolynomialVectorMatrix], x_vectors,
                         threshold, mesh_threshold, need_lambda: bool) -> List[Zeros]:
    """PVM variant: normalization is implicitly (1, 0, ...) and there is no
    damped-rational prefactor (compute_spectrum_pvm.cxx)."""
    normalization = [mpmath.mpf(0)] * (len(y) + 1)
    normalization[0] = mpmath.mpf(1)
    weights = fill_weights(y, 0, normalization)
    one = lambda x: mpmath.mpf(1)
    out = []
    for bi, block in enumerate(matrices):
        max_terms = max(len(p.coefficients) for pv in block.elements for p in pv)
        max_delta = mpmath.mpf(6 * max_terms)
        rows = block.rows
        summed, scale = _sum_polynomials(
            rows, block.cols, lambda r, c: block.elt(r, c), weights, max_terms)
        zero_vector = _summed_scan(rows, summed, one, max_delta, scale,
                                   mesh_threshold, threshold)
        zb = Zeros()
        if need_lambda:
            pts = [mpmath.mpf(p) for p in block.sample_points[:max_terms]]
            scl = [mpmath.mpf(s) for s in block.sample_scalings[:max_terms]]
            compute_lambda(pts, scl, rows, x_vectors[bi], zero_vector, zb)
        else:
            zb.zeros = [Zero(z) for z in zero_vector]
        out.append(zb)
    return out


def compute_lambda(samples, scalings, num_rows, x_vec, zero_vector,
                   zb: Zeros) -> None:
    """Lagrange interpolation + SVD pseudoinverse fit of the x vector at
    the zeros (compute_lambda.cxx:30-160)."""
    n_pts = len(samples)
    n_pairs = num_rows * (num_rows + 1) // 2
    block_size = len(x_vec) // n_pairs

    # x_scaled[index, pair] = x[pair*block_size + index] * scaling[index]
    x_scaled = [[x_vec[rc * block_size + i] * scalings[i]
                 for rc in range(n_pairs)] for i in range(block_size)]
    error_matrix = [row[:] for row in x_scaled]

    if not zero_vector:
        zb.error = mpmath.sqrt(
            mpmath.fsum(v * v for row in error_matrix for v in row))
        return

    nz = len(zero_vector)
    interp = mpmath.matrix(n_pts, nz)
    for pi in range(n_pts):
        for zi in range(nz):
            prod = mpmath.mpf(1)
            for pj in range(n_pts):
                if pj != pi:
                    prod *= (zero_vector[zi] - samples[pj]) / (samples[pi] - samples[pj])
            interp[pi, zi] = prod

    # pseudoinverse via SVD: pinv = V S^{-1} U^T  -> roots_fit [nz, n_pts]
    U, S, V = mpmath.svd_r(interp)
    eps = mpmath.mpf(2) ** (1 - mpmath.mp.prec)
    tol = max(n_pts, nz) * eps * max(S[i] for i in range(S.rows))
    rank = sum(1 for i in range(S.rows) if S[i] > tol)
    roots_fit = mpmath.matrix(nz, n_pts)
    for zi in range(nz):
        for pi in range(n_pts):
            acc = mpmath.mpf(0)
            for k in range(rank):
                acc += V[k, zi] * U[pi, k] / S[k]
            roots_fit[zi, pi] = acc

    for zi in range(nz):
        Lam = mpmath.matrix(num_rows, num_rows)
        rc = 0
        for r in range(num_rows):
            for c in range(r, num_rows):
                acc = mpmath.mpf(0)
                for i in range(block_size):
                    acc += roots_fit[zi, i] * x_scaled[i][rc]
                acc *= 1 if r == c else mpmath.mpf("0.5")
                Lam[r, c] = acc
                Lam[c, r] = acc
                rc += 1
        E, Q = mpmath.eigsy(Lam)
        idx_max = max(range(num_rows), key=lambda i: E[i])
        if E[idx_max] >= 0:
            lam = [mpmath.sqrt(E[idx_max]) * Q[r, idx_max]
                   for r in range(num_rows)]
            zb.zeros.append(Zero(zero_vector[zi], lam))
            rc = 0
            for r in range(num_rows):
                for c in range(r, num_rows):
                    factor = 1 if r == c else 2
                    for i in range(block_size):
                        error_matrix[i][rc] -= (interp[i, zi] * lam[r]
                                                * lam[c] * factor)
                    rc += 1
    zb.error = mpmath.sqrt(
        mpmath.fsum(v * v for row in error_matrix for v in row))


def write_spectrum_json(path, zeros_blocks: List[Zeros], ndigits: int) -> None:
    """JSON per docs/spectrum_schema.json:
    [{"zeros": [{"zero": str, "lambda": [str]}], "error": str}]"""
    def s(v):
        return mpmath.nstr(v, ndigits, strip_zeros=False, min_fixed=1, max_fixed=0)

    out = []
    for zb in zeros_blocks:
        entry = {"zeros": [], "error": s(zb.error) if zb.error is not None else "0"}
        for z in zb.zeros:
            item = {"zero": s(z.zero)}
            if z.Lambda is not None:
                item["lambda"] = [s(v) for v in z.Lambda]
            entry["zeros"].append(item)
        out.append(entry)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(out, indent=2))
