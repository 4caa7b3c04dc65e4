"""The wide MP representation on torch tensors (port of
sdpb_tpu/ops/mpwide.py): a value of more than 216 bits as a sum of G
scaled words, each a scaled MP (ops/mpfloat.py) with its own int32
exponent per element.

    MPW(words = (w_0, ..., w_{G-1}))      value = sum_g value(w_g)

After renormalization |w_{g+1}| <~ 2^-(24 Kg) |w_g|, so G words of Kg
float32 limbs carry about 24 Kg G bits with unbounded range, and a
cancellation simply lowers a word's exponent, as in GMP.  G = 2 words of
Kg = 9 limbs (432 bits) cover the reference's default `--precision 400`.

The arithmetic is double-word expansion arithmetic whose digit is a
scaled word: at G = 2 the word TwoSum is mpfloat.add_full and the exact
word product mpfloat.mul_full, cross terms use the truncated base product,
all as torch ops, as in the JAX package.  At G = 3 a sum and a product are
one elementwise CUDA kernel each on the card (kernels.mp_wide3_add and
mp_wide3_mul; the JAX package's generic-G branch of its add and mul) over
the compact word ops of ops/mpwide_kernel.py, whose plain versions run on
the CPU; reciprocal, rsqrt, sqrt and division are built from them here.
Every public function of ops/mpfloat.py sends MPW operands here, so linalg
and the solver do not see the representation.  Factorizations never take
an MPW: linalg.PosdefSolver factors word 0 rounded to at most 9 limbs and
refines with wide residual products (the wide GEMM kernel).

`wide_config` is a module-level function so that tests can widen it to
small word sizes (G = 2, Kg = 3) as the JAX package's tests do.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import mpfloat as mpf
from .mpfloat import MP


def wide_config(K: int):
    """Total limb count K > 9 -> (G words, Kg limbs per word)."""
    if K <= mpf.MAX_SCALED_K:
        raise ValueError(f"the wide representation takes K > {mpf.MAX_SCALED_K} "
                         f"limbs, got K={K}")
    G = -(-K // 9)
    return G, -(-K // G)


class MPW:
    """A wide MP array: the unevaluated sum of G scaled words."""

    __slots__ = ("words",)

    def __init__(self, words):
        self.words = tuple(words)

    @property
    def G(self) -> int:
        return len(self.words)

    @property
    def Kg(self) -> int:
        return self.words[0].K

    @property
    def K(self) -> int:
        return sum(w.K for w in self.words)

    @property
    def shape(self) -> tuple:
        return self.words[0].shape

    @property
    def ndim(self) -> int:
        return self.words[0].ndim

    @property
    def dtype(self):
        return self.words[0].dtype

    @property
    def device(self) -> torch.device:
        return self.words[0].device

    @property
    def scaled(self) -> bool:
        return True

    def __repr__(self):
        return (f"MPW(G={self.G}, Kg={self.Kg}, shape={self.shape}, "
                f"device={self.device})")

    def __getitem__(self, idx):
        return MPW(w[idx] for w in self.words)

    def reshape(self, *shape):
        return MPW(w.reshape(*shape) for w in self.words)

    def transpose(self, *axes):
        return MPW(w.transpose(*axes) for w in self.words)

    @property
    def mT(self):
        return MPW(w.mT for w in self.words)


def _map(fn, *xs) -> MPW:
    """A word-wise base operation over aligned words."""
    return MPW(fn(*(x.words[g] for x in xs)) for g in range(xs[0].G))


# ---------------------------------------------------------------------------
# Construction


def zeros(shape, K: int, device) -> MPW:
    G, Kg = wide_config(K)
    return MPW(mpf.zeros(shape, Kg, device, scaled=True) for _ in range(G))


def from_double(x, K: int, device=None) -> MPW:
    """A float64 value holds at most 53 bits: word 0 takes it exactly."""
    G, Kg = wide_config(K)
    w0 = mpf.from_double(x, Kg, device, scaled=True)
    return MPW((w0,) + tuple(mpf.zeros(w0.shape, Kg, w0.device, scaled=True)
                             for _ in range(G - 1)))


def const(x: float, K: int, device) -> MPW:
    """The host number x as a wide value on `device`, made once
    (mpfloat.device_const); read-only."""
    return mpf.device_const(("mpw", float(x), K, wide_config(K)), device,
                            lambda: from_double(np.float64(x), K, device))


def widen(a: MP, K: int) -> MPW:
    """A scaled MP as an MPW with zero tail words (exact)."""
    G, Kg = wide_config(K)
    if a.K != Kg:
        a = mpf.round_to(a, Kg)
    return MPW((a,) + tuple(mpf.zeros(a.shape, Kg, a.device, scaled=True)
                            for _ in range(G - 1)))


def round_to(a: MPW, K: int):
    """K <= 9: word 0 rounded to a scaled MP of K limbs (the factor
    precision); the same wide configuration: a itself."""
    if K == a.K:
        return a
    if K <= mpf.MAX_SCALED_K:
        return mpf.round_to(a.words[0], K)
    if wide_config(K) == (a.G, a.Kg):
        return a
    raise ValueError(f"round_to({a!r}, {K}) is not supported")


# ---------------------------------------------------------------------------
# Word-level distillation and arithmetic


def neg(a: MPW) -> MPW:
    return _map(mpf.neg, a)


def _check_pair(a, b) -> None:
    if not (isinstance(a, MPW) and isinstance(b, MPW)):
        raise TypeError(f"wide arithmetic takes two MPW, got {type(a).__name__} "
                        f"and {type(b).__name__}")
    if (a.G, a.Kg) != (b.G, b.Kg):
        raise ValueError(f"wide operands differ: {a!r} and {b!r}")


def add(a: MPW, b: MPW) -> MPW:
    _check_pair(a, b)
    if a.G == 2:
        # exact word TwoSum of the tops; the terms below 2^-(24 Kg) combine
        # in base arithmetic, whose truncation lies below 2^-(48 Kg)
        s0, e0 = mpf.add_full(a.words[0], b.words[0])
        t = mpf.add(mpf.add(a.words[1], b.words[1]), e0)
        return MPW(mpf.add_full(s0, t))
    # imported here: kernels imports this module (MPW), and the three-word
    # sum and product are its kernels; nothing else here depends on it
    from .kernels import mp_wide3_add
    return mp_wide3_add(a, b)


def mul(a: MPW, b: MPW) -> MPW:
    _check_pair(a, b)
    if a.G == 2:
        p0, p1 = mpf.mul_full(a.words[0], b.words[0])
        t = mpf.add(mpf.add(mpf.mul(a.words[0], b.words[1]),
                            mpf.mul(a.words[1], b.words[0])), p1)
        return MPW(mpf.add_full(p0, t))
    from .kernels import mp_wide3_mul
    return mp_wide3_mul(a, b)


def _newton_steps(G: int) -> int:
    """Each step doubles the accurate words, from a seed that holds one."""
    n, acc = 0, 1
    while acc < G:
        acc *= 2
        n += 1
    return n


def reciprocal(b: MPW) -> MPW:
    one = const(1.0, b.K, b.device)
    r = widen(mpf.reciprocal(b.words[0]), b.K)
    for _ in range(_newton_steps(b.G)):
        r = add(r, mul(r, mpf.sub(one, mul(b, r))))
    return r


def rsqrt(a: MPW) -> MPW:
    half = const(0.5, a.K, a.device)
    three_half = const(1.5, a.K, a.device)
    r = widen(mpf.rsqrt(a.words[0]), a.K)
    for _ in range(_newton_steps(a.G)):
        arr = mul(a, mul(r, r))
        r = mul(r, mpf.sub(three_half, mul(half, arr)))
    return r


def sqrt(a: MPW) -> MPW:
    """sqrt for a >= 0; zero gives zero, a negative input NaN."""
    half = const(0.5, a.K, a.device)
    top = a.words[0].limbs[0]
    is_zero = top <= 0
    one = const(1.0, a.K, a.device)
    a_safe = where(is_zero, broadcast_to(one, a.shape), a)
    r = rsqrt(a_safe)
    s = mul(a_safe, r)
    rem = mpf.sub(a_safe, mul(s, s))
    s = add(s, mul(rem, mul(r, half)))
    sign_ok = torch.where(top < 0, torch.full_like(top, float("nan")),
                          torch.ones_like(top))
    s = MPW(MP(w.limbs * sign_ok, w.exp) for w in s.words)
    return where(is_zero, zeros(a.shape, a.K, a.device), s)


def sign_array(a: MPW) -> torch.Tensor:
    s = mpf.sign_array(a.words[0])
    for g in range(1, a.G):
        s = torch.where(s != 0, s, mpf.sign_array(a.words[g]))
    return s


def abs_(a: MPW) -> MPW:
    f = torch.where(sign_array(a) < 0, -1.0, 1.0).to(a.dtype)
    return MPW(MP(w.limbs * f, w.exp) for w in a.words)


def mul_pow2(a: MPW, p) -> MPW:
    return _map(lambda w: mpf.mul_pow2(w, p), a)


# ---------------------------------------------------------------------------
# Structural (word-wise)


def mask_value(a: MPW, m) -> MPW:
    return _map(lambda w: mpf.mask_value(w, m), a)


def take(a: MPW, idx, axis: int) -> MPW:
    return _map(lambda w: mpf.take(w, idx, axis), a)


def stack(ms: List[MPW], axis: int) -> MPW:
    return MPW(mpf.stack([m.words[g] for m in ms], axis) for g in range(ms[0].G))


def concatenate(ms: List[MPW], axis: int) -> MPW:
    return MPW(mpf.concatenate([m.words[g] for m in ms], axis)
               for g in range(ms[0].G))


def broadcast_to(a: MPW, shape) -> MPW:
    return _map(lambda w: mpf.broadcast_to(w, shape), a)


def diagonal(a: MPW) -> MPW:
    return _map(mpf.diagonal, a)


def set_block(a: MPW, idx: tuple, b: MPW) -> None:
    """a[idx] = b in place, word by word (mpfloat.set_block)."""
    for wa, wb in zip(a.words, b.words):
        mpf.set_block(wa, idx, wb)


def scalar_eye(s: MPW, n: int) -> MPW:
    return _map(lambda w: mpf.scalar_eye(w, n), s)


def expand_dims(a: MPW, axis: int) -> MPW:
    return _map(lambda w: mpf.expand_dims(w, axis), a)


def pad_dim(a: MPW, axis: int, count: int) -> MPW:
    return _map(lambda w: mpf.pad_dim(w, axis, count), a)


def where(cond, a: MPW, b: MPW) -> MPW:
    return MPW(mpf.where(cond, wa, wb) for wa, wb in zip(a.words, b.words))


# ---------------------------------------------------------------------------
# Conversions


def to_float_array(a: MPW) -> torch.Tensor:
    f = mpf.to_float_array(a.words[0])
    for g in range(1, a.G):
        f = f + mpf.to_float_array(a.words[g])
    return f


def to_double(a: MPW) -> torch.Tensor:
    acc = mpf.to_double(a.words[0])
    for g in range(1, a.G):
        acc = acc + mpf.to_double(a.words[g])
    return acc


def nearest_double(a: MPW) -> torch.Tensor:
    """The value rounded once to float64: every word's limbs in float64 at
    the common exponent e = max_g exp_g, renormalized to two float64 limbs
    as one expansion, the top one times 2^e.  (Rounding each word and
    summing the doubles would round twice.)  A word more than 900 binary
    digits below is shifted by -900 only: it then can only break a tie, for
    which its sign is all that counts."""
    e = a.words[0].exp
    for w in a.words[1:]:
        e = torch.maximum(e, w.exp)
    rows = []
    for w in a.words:
        d = torch.clamp(w.exp - e, -900, 0).to(torch.int64)
        f = mpf._pow2d(d)
        rows += [x.to(torch.float64) * f for x in w.limbs]
    top = mpf.renorm(rows, 2).limbs[0]
    e = torch.clamp(e.to(torch.int64), -2044, 2046)
    e1 = torch.clamp(e, -1022, 1023)
    return top * mpf._pow2d(e1) * mpf._pow2d(e - e1)


def max_abs(a: MPW) -> torch.Tensor:
    m = torch.abs(to_float_array(a))
    return torch.max(m) if a.ndim else m


# ---------------------------------------------------------------------------
# Host staging (numpy, exact)


def _full_distill(rs: List[np.ndarray]) -> List[np.ndarray]:
    """Sweeps until the rows do not overlap (Priest).  One sweep is not
    enough after a deep cancellation: row 0 can read exactly 0 while the
    value hides in the error rows."""
    for _ in range(len(rs)):
        rs = mpf._distill(rs)
    return rs


def f64_limbs_to_wide_parts(limbs64: np.ndarray, K: int):
    """Classic float64 limb stack [K64, *shape] -> G word parts
    [(float32 limbs [Kg, *shape], int32 exp [*shape]), ...], exactly
    (mpwide.py:485-508).  Content below a word's float32-normal span would
    be stored as subnormal limbs; it is dropped there, so that the
    residual subtraction routes it on to the next word."""
    G, Kg = wide_config(K)
    res = [np.asarray(limbs64[k], np.float64).copy() for k in range(limbs64.shape[0])]
    words = []
    tiny = np.finfo(np.float32).tiny
    for g in range(G):
        wl, we = mpf.f64_limbs_to_scaled_parts(np.stack(res, 0), Kg)
        wl = np.where(np.abs(wl) < tiny, np.float32(0.0), wl)
        words.append((wl, we))
        if g == G - 1:
            break
        K64w = -(-(24 * Kg) // 53) + 1
        back = mpf.scaled_parts_to_f64_limbs(wl, we, K64w)
        res = _full_distill(res + [-back[k] for k in range(K64w)])
    return words


def wide_parts_to_mp(parts, device) -> MPW:
    """Host word parts [(limbs, exp), ...] as an MPW on `device`."""
    return MPW(mpf.from_parts(l, e, device) for l, e in parts)


def host_f64_limbs(a: MPW, K64: int = 0) -> np.ndarray:
    """An MPW as a classic float64 limb stack (solution files), exact
    within float64's range as for a scaled word."""
    K64 = K64 or -(-(24 * a.K) // 53) + 1
    per_word = -(-(24 * a.Kg) // 53) + 1
    rows = []
    for w in a.words:
        back = mpf.scaled_parts_to_f64_limbs(w.limbs.detach().cpu().numpy(),
                                             w.exp.detach().cpu().numpy(), per_word)
        rows += list(back)
    return mpf.f64_limbs_to_classic(np.stack(rows, 0), K64)
