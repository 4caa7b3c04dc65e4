"""Host-side exact conversions between decimal strings and MP limb arrays
(the port's copy of sdpb_tpu/utils/strings.py: classic, scaled and wide).

The host parses decimal strings with mpmath at generous precision and
peels off float64 limbs exactly; the device never sees strings.
"""
from __future__ import annotations

import mpmath
import numpy as np


def str_to_limbs(s: str, K: int, np_dtype=np.float64) -> np.ndarray:
    """Parse one decimal string into K limbs (exact peel-off)."""
    nbits = (24 if np_dtype == np.float32 else 53) * K + 16
    with mpmath.workprec(nbits + 32):
        x = mpmath.mpf(s)
        limbs = np.zeros(K, dtype=np_dtype)
        for k in range(K):
            hi = np_dtype(float(x))
            limbs[k] = hi
            x = x - mpmath.mpf(float(hi))
        return limbs


def strs_to_limbs(strings, K: int, np_dtype=np.float64) -> np.ndarray:
    """Parse a flat list of decimal strings -> limbs array [K, n]; limbs
    below the dtype's smallest normal are flushed (as the JAX package's
    native parser does)."""
    n = len(strings)
    nbits = (24 if np_dtype == np.float32 else 53) * K + 16
    out = np.zeros((K, n), dtype=np_dtype)
    tiny = np.finfo(np_dtype).tiny
    with mpmath.workprec(nbits + 32):
        for i, s in enumerate(strings):
            x = mpmath.mpf(s)
            for k in range(K):
                hi = np_dtype(float(x))
                if abs(hi) < tiny:
                    break
                out[k, i] = hi
                x = x - mpmath.mpf(float(hi))
    return out


def str_to_scaled_limbs(s: str, K: int):
    """Parse one decimal string -> (float32 limbs [K], int32 exp scalar) in
    the scaled representation; K > 9 gives the wide representation, a LIST
    of per-word (limbs [Kg], exp) parts."""
    from ..ops.mpfloat import MAX_SCALED_K, f64_limbs_to_scaled_parts

    K64 = -(-(24 * K) // 53) + 1
    l64 = str_to_limbs(s, K64, np.float64)
    if K > MAX_SCALED_K:
        from ..ops.mpwide import f64_limbs_to_wide_parts

        return [(l[:, 0], e[0]) for l, e in f64_limbs_to_wide_parts(
            l64.reshape(K64, 1), K)]
    limbs, exp = f64_limbs_to_scaled_parts(l64.reshape(K64, 1), K)
    return limbs[:, 0], exp[0]


def scaled_limbs_to_mpf(limbs, exp) -> mpmath.mpf:
    """Exact mpmath value of a scaled (limbs [K], exp int) number."""
    with mpmath.workprec(30 * len(limbs) + 64):
        acc = mpmath.mpf(0)
        for l in np.asarray(limbs, dtype=np.float64):
            acc = acc + mpmath.mpf(float(l))
        return acc * mpmath.power(2, int(exp))


def wide_limbs_to_mpf(parts) -> mpmath.mpf:
    """Exact mpmath value of a wide number given as its words' (limbs [Kg],
    exp int) parts."""
    with mpmath.workprec(30 * sum(len(l) for l, _ in parts) + 64):
        return mpmath.fsum(scaled_limbs_to_mpf(l, e) for l, e in parts)


def limbs_to_mpf(limbs) -> mpmath.mpf:
    """Exact mpmath value of a single K-limb number (host numpy input)."""
    with mpmath.workprec(60 * len(limbs) + 64):
        acc = mpmath.mpf(0)
        for l in np.asarray(limbs, dtype=np.float64):
            acc = acc + mpmath.mpf(float(l))
        return acc


def limbs_to_str(limbs, ndigits=None) -> str:
    """Decimal string of a K-limb number, full precision by default."""
    limbs = np.asarray(limbs, dtype=np.float64)
    nbits = 53 * len(limbs) + 16
    if ndigits is None:
        ndigits = int(nbits * 0.30103) + 1
    with mpmath.workprec(nbits):
        acc = mpmath.mpf(0)
        for l in limbs:
            acc = acc + mpmath.mpf(float(l))
        return mpmath.nstr(acc, ndigits, strip_zeros=False, min_fixed=1,
                           max_fixed=0)
