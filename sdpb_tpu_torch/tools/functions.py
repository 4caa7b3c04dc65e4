"""Function blocks for outer_limits: Chebyshev-sampled SDP functionals
(the port's copy of sdpb_tpu/tools/functions.py).

Covers the reference's:
  * Function struct + Clenshaw evaluation with special epsilon/infinity
    sentinels (outer_limits/Function.hxx:7-15, Function/eval/eval.cxx:4-24)
  * sampled-values -> Chebyshev-coefficient conversion
    (read_function_blocks/read_json/Function_State/json_end_object.cxx:35-51)
  * the functions-JSON writer of sdp2functions (PMP; max_delta =
    6 * max_terms, polynomials only: the damped-rational prefactor is
    handled by outer_limits' own prefactor, sdp2functions/write_functions.cxx)
  * functions-JSON reader producing Function blocks
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import mpmath


@dataclass
class Function:
    max_delta: mpmath.mpf
    epsilon_value: mpmath.mpf
    infinity_value: mpmath.mpf
    chebyshev_coeffs: List = field(default_factory=list)

    def eval(self, epsilon, infinity, x):
        """epsilon/infinity are sentinel VALUES of x selecting the limits
        (eval.cxx:4-24)."""
        if x == epsilon:
            return self.epsilon_value
        if x == infinity:
            return self.infinity_value
        return chebyshev_clenshaw(self.chebyshev_coeffs, mpmath.mpf(0),
                                  self.max_delta, x)


def chebyshev_clenshaw(c: List, a, b, x):
    """Clenshaw evaluation of sum_j c_j T_j(t), t = 2(x-a)/(b-a) - 1, with
    the boost convention that c[0] contributes c[0]/2
    (chebyshev_clenshaw_recurrence.hxx)."""
    if x < a or x > b:
        raise ValueError(f"x in [a, b] required: x={x}, a={a}, b={b}")
    n = len(c)
    if n == 0:
        return mpmath.mpf(0)
    if n == 1:
        return c[0] / 2
    t = 2 * (x - a) / (b - a) - 1
    b1 = c[-1]
    b2 = mpmath.mpf(0)
    for j in range(n - 2, 0, -1):
        b1, b2 = 2 * t * b1 - b2 + c[j], b1
    return t * b1 - b2 + c[0] / 2


def values_to_coeffs(values: List) -> List:
    """Sampled values at the writer's ascending Chebyshev zeros ->
    coefficients (json_end_object.cxx:35-51)."""
    N = len(values)
    coeffs = []
    for n in range(N):
        acc = mpmath.mpf(0)
        for k in range(N):
            acc += 2 * mpmath.cos(n * mpmath.pi * (2 * (N - 1 - k) + 1)
                                  / (2 * N)) * values[k] / N
        coeffs.append(acc)
    return coeffs


def chebyshev_points(N: int, max_delta):
    """Ascending points 0.5*max_delta*(1 + cos(pi(N-i-0.5)/N))
    (sdp2functions/write_functions.cxx:45-55)."""
    return [mpmath.mpf("0.5") * max_delta
            * (1 + mpmath.cos(mpmath.pi * (N - i - mpmath.mpf("0.5")) / N))
            for i in range(N)]


def _degree_bounds(rows, cols, get_pv):
    """(max_degree, min_degree) per matrix entry, with the 2x2 limiting-
    determinant fixup (write_functions.cxx:85-108)."""
    max_deg = [0] * (rows * cols)
    min_deg = [10 ** 9] * (rows * cols)
    for r in range(rows):
        for c in range(cols):
            for poly in get_pv(r, c):
                for d, cf in enumerate(poly.coefficients):
                    if cf != 0:
                        i = r + c * rows
                        max_deg[i] = max(max_deg[i], d)
                        min_deg[i] = min(min_deg[i], d)
    if rows == 2:
        first = max_deg[0] + max_deg[3]
        second = 2 * max_deg[1]
        if first > second:
            max_deg[1] = max_deg[2] = 0
        elif first < second:
            max_deg[0] = max_deg[3] = 0
    elif rows > 2:
        raise ValueError(
            f"Too large a dimension.  Only 1x1 and 2x2 supported: {rows}")
    return max_deg, min_deg


def _functions_entry(poly, max_delta, points, max_d, min_d, s):
    inf_v = ("0" if poly.degree < max_d
             else s(poly.coefficients[max_d]))
    eps_v = ("0" if poly.degree < min_d
             else s(poly.coefficients[min_d]))
    return {
        "max_delta": s(max_delta),
        "infinity_value": inf_v,
        "epsilon_value": eps_v,
        "chebyshev_values": [s(poly(x)) for x in points],
    }


def write_functions_json(path, objective, normalization, blocks,
                         ndigits: int) -> None:
    """blocks: list of (rows, cols, get_pv(r,c) -> [Polynomial], max_delta).
    Writes the functions JSON (docs/functions_schema.json layout)."""
    def s(v):
        if isinstance(v, str):
            return v
        return mpmath.nstr(mpmath.mpf(v), ndigits, strip_zeros=False,
                           min_fixed=1, max_fixed=0)

    out_blocks = []
    for rows, cols, get_pv, max_delta in blocks:
        n_cheb = max(len(p.coefficients) for r in range(rows)
                     for c in range(cols) for p in get_pv(r, c))
        points = chebyshev_points(n_cheb, max_delta)
        max_deg, min_deg = _degree_bounds(rows, cols, get_pv)
        rows_out = []
        for r in range(rows):
            cols_out = []
            for c in range(cols):
                i = r + c * rows
                cols_out.append([
                    _functions_entry(poly, max_delta, points,
                                     max_deg[i], min_deg[i], s)
                    for poly in get_pv(r, c)])
            rows_out.append(cols_out)
        out_blocks.append(rows_out)

    doc = {
        "objective": [s(v) for v in objective],
        "normalization": [s(v) for v in normalization],
        "functions": out_blocks,
    }
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(doc, indent=1))


def read_functions_json(path):
    """-> (objective, normalization, functions[block][row][col][n] ->
    Function with chebyshev_coeffs)."""
    doc = json.loads(Path(path).read_text())
    objective = [mpmath.mpf(v) for v in doc.get("objective", [])]
    normalization = [mpmath.mpf(v) for v in doc.get("normalization", [])]
    functions = []
    for block in doc["functions"]:
        rows_out = []
        for row in block:
            cols_out = []
            for pv in row:
                fns = []
                for f in pv:
                    values = [mpmath.mpf(v) for v in f["chebyshev_values"]]
                    fns.append(Function(
                        max_delta=mpmath.mpf(f["max_delta"]),
                        epsilon_value=mpmath.mpf(f["epsilon_value"]),
                        infinity_value=mpmath.mpf(f["infinity_value"]),
                        chebyshev_coeffs=values_to_coeffs(values)))
                cols_out.append(fns)
            rows_out.append(cols_out)
        functions.append(rows_out)
    return objective, normalization, functions
