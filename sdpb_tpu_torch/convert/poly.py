"""Host-side exact polynomial and PMP data types with mpmath coefficients
(the port's copy of sdpb_tpu/convert/poly.py).

They mirror the reference's Polynomial (Polynomial.hxx:23-70) and
Polynomial_Vector_Matrix (sdp_convert/Polynomial_Vector_Matrix.hxx), and
are used at conversion time only, never on the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import mpmath


class Polynomial:
    """p(x) = a_0 + a_1 x + ... + a_n x^n, coefficients ascending."""

    __slots__ = ("coefficients",)

    def __init__(self, coefficients=None):
        self.coefficients = list(coefficients) if coefficients else [mpmath.mpf(0)]

    @property
    def degree(self) -> int:
        return len(self.coefficients) - 1

    def __call__(self, x):
        result = self.coefficients[-1]
        for c in reversed(self.coefficients[:-1]):
            result = result * x + c
        return result

    def __repr__(self):
        return f"Polynomial({[str(c) for c in self.coefficients]})"


@dataclass
class PolynomialVectorMatrix:
    """M(x): rows x cols matrix of polynomial vectors, with sampling data.

    elements is stored flat with the reference's access convention
    elt(r, c) = elements[r + c*rows] (Polynomial_Vector_Matrix.hxx:51-53).
    """

    rows: int
    cols: int
    elements: List[List[Polynomial]] = field(default_factory=list)
    sample_points: List = field(default_factory=list)
    sample_scalings: List = field(default_factory=list)
    bilinear_basis: List[Polynomial] = field(default_factory=list)

    def elt(self, r: int, c: int) -> List[Polynomial]:
        return self.elements[r + c * self.rows]

    @property
    def num_points(self) -> int:
        return len(self.sample_points)

    @property
    def max_degree(self) -> int:
        return max(p.degree for pv in self.elements for p in pv)


@dataclass
class DampedRational:
    """constant * base^x / prod_i (x - poles[i]) (Damped_Rational.hxx:8-16)."""

    constant: mpmath.mpf
    base: mpmath.mpf
    poles: List = field(default_factory=list)

    def is_constant(self) -> bool:
        return self.base == 1 and not self.poles

    def __call__(self, x):
        num = self.constant * mpmath.power(self.base, x)
        den = mpmath.mpf(1)
        for p in self.poles:
            den *= (x - p)
        return num / den


@dataclass
class PositiveMatrixWithPrefactor:
    """DampedRational prefactor + matrix of polynomial vectors
    (Positive_Matrix_With_Prefactor.hxx:6-12)."""

    damped_rational: DampedRational
    # polynomials[r][c][n] -> Polynomial
    polynomials: List[List[List[Polynomial]]] = field(default_factory=list)
