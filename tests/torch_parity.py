"""Shared helpers of the tests that hold the PyTorch port (sdpb_tpu_torch)
against the JAX package (sdpb_tpu) on the CPU: inputs are made with numpy
from a seed and handed to both packages as the same float64 limbs.

Importing this module imports no JAX (only `J` does), so the CUDA tests
can use it on a machine without JAX."""
import math
from pathlib import Path

import numpy as np
import torch

from sdpb_tpu_torch.ops import mpfloat as tmp

# tier-1 runs several pytest workers; keep each torch process on one core
torch.set_num_threads(1)


def rand_limbs(rng, shape, K, positive=False, spread=0.0):
    """Float64 limb stacks [K, *shape]: a random top limb (optionally over
    `spread` decades) and tail limbs just under one ulp of their
    predecessor, so every limb carries fresh bits."""
    shape = tuple(shape)
    top = rng.standard_normal(shape)
    if positive:
        top = np.abs(top) + 0.5
    if spread:
        top = top * 10.0 ** rng.uniform(-spread, spread, shape)
    out = np.zeros((K,) + shape)
    out[0] = top
    for k in range(1, K):
        out[k] = (out[k - 1] * 2.0 ** -53 * rng.uniform(0.5, 1.0, shape)
                  * rng.choice([-1.0, 1.0], shape))
    return out


def rand_scaled(rng, shape, K, decades=10.0, positive=False):
    """Scaled parts (float32 limbs [K, *shape], int32 exp [*shape]) of
    random values over +-`decades` decades with full mantissas: float64
    limb stacks as rand_limbs makes them, converted exactly by the port's
    f64_limbs_to_scaled_parts (as tests/test_mpfloat_scaled.py:33 builds
    its inputs)."""
    shape = tuple(shape)
    K64 = -(-(24 * K) // 53) + 1
    l64 = rand_limbs(rng, shape, K64, positive=positive)
    l64 *= 10.0 ** rng.uniform(-decades, decades, shape)
    return tmp.f64_limbs_to_scaled_parts(l64, K)


def J(limbs):
    """The limbs (or scaled (limbs, exp) parts) as a JAX package MP."""
    import jax.numpy as jnp
    from sdpb_tpu.ops import mpfloat as jmp

    if isinstance(limbs, tuple):
        return jmp.MP(jnp.asarray(limbs[0], dtype=jnp.float32),
                      jnp.asarray(limbs[1], dtype=jnp.int32))
    return jmp.MP(jnp.asarray(limbs, dtype=jnp.float64))


def T(limbs, device="cpu") -> tmp.MP:
    """The limbs (or scaled (limbs, exp) parts) as a port MP (a copy) on
    `device`."""
    if isinstance(limbs, tuple):
        return tmp.MP(torch.tensor(np.asarray(limbs[0], dtype=np.float32), device=device),
                      torch.tensor(np.asarray(limbs[1], dtype=np.int32), device=device))
    return tmp.MP(torch.tensor(np.asarray(limbs, dtype=np.float64), device=device))


def parts_of(x):
    """Host (limbs, exp) of a scaled JAX or port MP."""
    if isinstance(x, tmp.MP):
        return x.limbs.detach().cpu().numpy(), x.exp.detach().cpu().numpy()
    return np.asarray(x.limbs), np.asarray(x.exp)


def same_scaled(x, y) -> bool:
    """Scaled values equal limb for limb (IEEE ==) and exponent for
    exponent."""
    (xl, xe), (yl, ye) = parts_of(x), parts_of(y)
    return xl.shape == yl.shape and np.array_equal(xl, yl) and np.array_equal(xe, ye)


def scaled_rel_err(a, b) -> float:
    """max over elements of |a - b| / |b| for scaled values, exactly (the
    difference taken in float64 limbs converted from the parts; values
    beyond float64's range are not compared this way)."""
    (al, ae), (bl, be) = parts_of(a), parts_of(b)
    K64 = -(-(24 * al.shape[0]) // 53) + 2
    x = tmp.scaled_parts_to_f64_limbs(al, ae, K64)
    y = tmp.scaled_parts_to_f64_limbs(bl, be, K64)
    return elementwise_rel_err(x, y)


def limbs_of(x) -> np.ndarray:
    """Host float64 limbs of a JAX or port MP (or raw array); scaled values
    as their float32 limbs."""
    if isinstance(x, tmp.MP):
        return x.limbs.detach().cpu().numpy()
    if hasattr(x, "limbs"):
        return np.asarray(x.limbs, dtype=np.float64)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def rel_err(a, b) -> float:
    """max |a - b| / max |b| over all elements, the difference taken at
    full MP precision (port's MP sub on the CPU)."""
    a, b = limbs_of(a), limbs_of(b)
    d = tmp.to_float_array(tmp.sub(T(a), T(b))).numpy()
    scale = np.max(np.abs(b[0] + b[1])) if b.size else 0.0
    return float(np.max(np.abs(d)) / scale) if scale else float(np.max(np.abs(d)))


def elementwise_rel_err(a, b) -> float:
    """max over elements of |a - b| / |b| at full MP precision."""
    a, b = limbs_of(a), limbs_of(b)
    d = np.abs(tmp.to_float_array(tmp.sub(T(a), T(b))).numpy())
    ref = np.abs(b[0] + b[1])
    return float(np.max(d / np.where(ref > 0, ref, 1.0)))


# ---------------------------------------------------------------------------
# Wide (two-word) values


def small_wide_config(K):
    """A wide configuration of two words of ceil(K/2) limbs for any K, so
    that wide values of 6 limbs (Kg = 3) can be staged (both packages'
    wide_config otherwise demand K > 9)."""
    return 2, -(-K // 2)


def JW(parts):
    """Wide word parts as a JAX package MPW."""
    from sdpb_tpu.ops.mpwide import MPW
    return MPW(tuple(J(p) for p in parts))


def wide_parts_of(x):
    """Host word parts of a JAX or port MPW."""
    return [parts_of(w) for w in x.words]


def same_wide(x, y) -> bool:
    """Wide values equal word for word, limb for limb and exponent for
    exponent."""
    return all(same_scaled(a, b) for a, b in zip(x.words, y.words)) and \
        len(x.words) == len(y.words)


def wide_to_mpf(x, prec):
    """Exact mpmath values (flattened) of a JAX or port MPW (or word
    parts)."""
    import mpmath
    parts = x if isinstance(x, list) else wide_parts_of(x)
    words = [(np.asarray(l, np.float64).reshape(l.shape[0], -1),
              np.asarray(e).reshape(-1)) for l, e in parts]
    out = []
    with mpmath.workprec(prec + 120):
        for i in range(words[0][1].size):
            acc = mpmath.mpf(0)
            for wl, we in words:
                acc += mpmath.fsum(mpmath.mpf(float(v)) for v in wl[:, i]) * \
                    mpmath.mpf(2) ** int(we[i])
            out.append(acc)
    return out


def mpf_to_f64_limbs(vals, shape, prec):
    """Exact mpmath values -> float64 limb stacks [K64, *shape] carrying
    prec + 106 bits (the input of the wide staging)."""
    import mpmath
    K64 = -(-prec // 53) + 2
    out = np.zeros((K64, len(vals)))
    with mpmath.workprec(prec + 120):
        for i, x in enumerate(vals):
            rem = x
            for k in range(K64):
                out[k, i] = float(rem)
                rem = rem - mpmath.mpf(out[k, i])
    return out.reshape((K64,) + tuple(shape))


def rand_wide_vals(rng, n, prec, decades=6):
    """Random mpmath values with content at the top, the middle and the
    bottom of `prec` bits, over +-decades decades."""
    import mpmath
    vals = []
    with mpmath.workprec(prec + 120):
        for _ in range(n):
            x = (mpmath.mpf(rng.uniform(-1, 1))
                 + mpmath.mpf(rng.uniform(-1, 1)) * mpmath.mpf(2) ** (-prec // 2)
                 + mpmath.mpf(rng.uniform(-1, 1)) * mpmath.mpf(2) ** (-prec + 40))
            vals.append(x * mpmath.mpf(10) ** int(rng.integers(-decades, decades + 1)))
    return vals


def max_rel_bits(got, want, prec):
    """max over elements of log2(|got - want| / |want|) (-inf when equal);
    a nonzero result for a zero want counts as +inf."""
    import mpmath
    worst = -math.inf
    with mpmath.workprec(prec + 120):
        for g, w in zip(got, want):
            if g == w:
                continue
            if w == 0:
                return math.inf
            worst = max(worst, float(mpmath.log(abs(g - w) / abs(w), 2)))
    return worst


# ---------------------------------------------------------------------------
# Perturbed problems (approx_objective)


def perturbed_sdp(host, delta: float, seed: int, fields: str = "bcB"):
    """A copy of a host SDPData (either package's) with b, c and B (those
    named in `fields`) each multiplied elementwise by 1 + delta * r, r
    standard normal from numpy's default_rng(seed), limb by limb."""
    import copy

    rng = np.random.default_rng(seed)
    new = copy.deepcopy(host)

    def scaled(a):
        return a * (1 + delta * rng.standard_normal(a.shape[1:]))

    if "b" in fields:
        new.b = scaled(host.b)
    for old, blk in zip(host.blocks, new.blocks):
        if "c" in fields:
            blk.c = scaled(old.c)
        if "B" in fields:
            blk.B = scaled(old.B)
    return new


def perturbed_pmp(doc: dict, delta: float, seed: int, digits: int = 80) -> dict:
    """A copy of a JSON PMP document with its objective and every
    polynomial coefficient (of each matrix's lower triangle, mirrored to
    the upper) multiplied by 1 + delta * r, r standard normal
    from numpy's default_rng(seed), at `digits` decimal digits.  Through
    sdp2input this perturbs b, c and B along the polynomial structure,
    which keeps a strictly feasible problem feasible; a random
    perturbation of c at the sample points need not (the ladder's
    interpolating polynomials are ill-conditioned in them)."""
    import copy

    import mpmath

    rng = np.random.default_rng(seed)
    new = copy.deepcopy(doc)

    def scaled(s):
        with mpmath.workprec(int(digits * 3.33) + 64):
            return mpmath.nstr(mpmath.mpf(s) * (1 + mpmath.mpf(delta * rng.standard_normal())),
                               digits, strip_zeros=False, min_fixed=1, max_fixed=0)

    new["objective"] = [scaled(s) for s in doc["objective"]]
    for entry in new["PositiveMatrixWithPrefactorArray"]:
        m = entry["polynomials"]
        for r in range(len(m)):
            for c in range(r + 1):      # the matrix stays symmetric
                m[r][c] = [[scaled(x) for x in poly] for poly in m[r][c]]
                if c < r:
                    m[c][r] = copy.deepcopy(m[r][c])
    return new


def same_sdp(a, b):
    """Two SDPB inputs hold the same files with the same bytes (control.json's
    `command` aside), two zips in the same order."""
    from sdpb_tpu_torch.io.sdp_zip import entries

    ea, eb = entries(a), entries(b)
    assert sorted(ea) == sorted(eb)
    if not (Path(a).is_dir() or Path(b).is_dir()):
        assert list(ea) == list(eb)
    for name in ea:
        assert ea[name] == eb[name], name
