"""Mathematica PMP input (.m), the port's copy of
sdpb_tpu/convert/mathematica.py: a hand-written parser of
SDP[objective, normalization, {PositiveMatrixWithPrefactor[...] ...}]
after the reference's character-level one (read_mathematica/parse_SDP/):

  * numbers carry Mathematica precision marks (1.23`199.6) — stripped —
    and *^ exponents — mapped to e (parse_number.cxx)
  * '\\'-newline continuations and whitespace are ignored everywhere
    (is_valid_char.hxx)
  * polynomials are expressions in x: "a + b*x + c*x^2", bare "x" allowed
    (parse_polynomial.cxx)
  * DampedRational[constant, {poles}, base, x] or a plain constant
    (parse_matrix/parse_damped_rational.cxx)
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import List, Tuple

import mpmath

from .poly import DampedRational, Polynomial, PositiveMatrixWithPrefactor

_BACKTICK = re.compile(r"`[0-9.]*")


def _clean(s: str) -> str:
    """Drop whitespace/backslashes and precision marks."""
    s = "".join(c for c in s if not c.isspace() and c != "\\")
    return _BACKTICK.sub("", s)


def _number(s: str) -> mpmath.mpf:
    s = _clean(s).replace("*^", "e")
    if not s:
        raise ValueError("empty number")
    return mpmath.mpf(s)


def _match_brace(s: str, start: int) -> int:
    """Index just past the brace/bracket matching s[start]."""
    depth = 0
    for i in range(start, len(s)):
        if s[i] in "{[":
            depth += 1
        elif s[i] in "}]":
            depth -= 1
            if depth == 0:
                # mixed nesting is fine; only the depth matters
                return i + 1
    raise ValueError(f"Unbalanced '{s[start]}' at {start}")


def _split_top(s: str) -> List[str]:
    """Split a brace-free-at-top-level item list on commas."""
    items, depth, last = [], 0, 0
    for i, c in enumerate(s):
        if c in "{[":
            depth += 1
        elif c in "}]":
            depth -= 1
        elif c == "," and depth == 0:
            items.append(s[last:i])
            last = i + 1
    tail = s[last:]
    if tail.strip("") != "":
        items.append(tail)
    return [it for it in items if it != ""]


def _parse_vector(s: str) -> List[mpmath.mpf]:
    inner = s[s.index("{") + 1 : _match_brace(s, s.index("{")) - 1]
    return [_number(x) for x in _split_top(inner)]


def parse_polynomial_string(s: str) -> Polynomial:
    """Mathematica polynomial in x -> coefficient list."""
    s = _clean(s)
    coeffs = {}
    i, n = 0, len(s)
    sign = 1
    while i < n:
        c = s[i]
        if c == "+":
            i += 1
            continue
        if c == "-":
            sign = -sign
            i += 1
            continue
        num = None
        j = i
        while j < n and (s[j].isdigit() or s[j] == "."):
            j += 1
        if j > i:
            num = s[i:j]
            if s[j : j + 2] == "*^":
                k = j + 2
                if k < n and s[k] in "+-":
                    k += 1
                while k < n and s[k].isdigit():
                    k += 1
                num = num + "e" + s[j + 2 : k]
                j = k
            i = j
        deg = 0
        if i < n and s[i] == "*":
            i += 1
        if i < n and s[i] == "x":
            i += 1
            deg = 1
            if i < n and s[i] == "^":
                i += 1
                k = i
                if k < n and s[k] in "+-":
                    k += 1
                while k < n and s[k].isdigit():
                    k += 1
                deg = int(s[i:k])
                i = k
        if num is None and deg == 0:
            raise ValueError(f"Cannot parse polynomial term at '{s[i:i+20]}'")
        coeff = mpmath.mpf(num) if num is not None else mpmath.mpf(1)
        coeffs[deg] = coeffs.get(deg, mpmath.mpf(0)) + sign * coeff
        sign = 1
    max_deg = max(coeffs) if coeffs else 0
    return Polynomial([coeffs.get(d, mpmath.mpf(0)) for d in range(max_deg + 1)])


def _parse_damped_rational(s: str) -> DampedRational:
    s = s.strip()
    if not s.startswith("DampedRational["):
        # plain constant prefactor (parse_damped_rational.cxx:17-37)
        return DampedRational(constant=_number(s), base=mpmath.mpf(1), poles=[])
    inner = s[len("DampedRational[") : _match_brace(s, s.index("[")) - 1]
    parts = _split_top(inner)
    if len(parts) != 4:
        raise ValueError(f"DampedRational expects 4 arguments, got {len(parts)}")
    return DampedRational(
        constant=_number(parts[0]),
        poles=_parse_vector(parts[1]) if "{" in parts[1] else [],
        base=_number(parts[2]),
    )


def _parse_matrix(s: str) -> PositiveMatrixWithPrefactor:
    lit = "PositiveMatrixWithPrefactor["
    start = s.index(lit)
    inner = s[start + len(lit) : _match_brace(s, start + len(lit) - 1) - 1]
    parts = _split_top(inner)
    if len(parts) != 2:
        raise ValueError(
            f"PositiveMatrixWithPrefactor expects 2 arguments, got {len(parts)}")
    damped = _parse_damped_rational(parts[0])
    # polynomials: {{{poly, ...}, ...}, ...}
    rows_s = _split_top(parts[1].strip()[1:-1])
    polynomials = []
    for row_s in rows_s:
        cols_s = _split_top(row_s.strip()[1:-1])
        row = []
        for pv_s in cols_s:
            row.append([parse_polynomial_string(p)
                        for p in _split_top(pv_s.strip()[1:-1])])
        polynomials.append(row)
    return PositiveMatrixWithPrefactor(damped_rational=damped,
                                       polynomials=polynomials)


def read_pmp_mathematica(path) -> Tuple[List, List, List[PositiveMatrixWithPrefactor]]:
    text = Path(path).read_text()
    # locate SDP[ with the reference's preceding-character check
    for m in re.finditer(r"SDP\[", text):
        if m.start() == 0 or text[m.start() - 1] in " \t\n\r)":
            start = m.start()
            break
    else:
        raise ValueError(f"{path}: could not find 'SDP['")
    body = _clean(text[start + len("SDP") :])
    inner = body[1 : _match_brace(body, 0) - 1]
    parts = _split_top(inner)
    if len(parts) != 3:
        raise ValueError(f"SDP[] expects 3 arguments, got {len(parts)}")
    objective = _parse_vector(parts[0]) if "{" in parts[0] else []
    normalization = _parse_vector(parts[1]) if "{" in parts[1] else []
    matrices_inner = parts[2].strip()
    matrices = []
    if matrices_inner.startswith("{"):
        for item in _split_top(matrices_inner[1:-1]):
            if item:
                matrices.append(_parse_matrix(item))
    return objective, normalization, matrices
