"""Multi-limb floating-point expansions on torch tensors: the classic and
scaled representations of sdpb_tpu/ops/mpfloat.py.

An `MP` value is an unevaluated sum of K limbs kept approximately
non-overlapping by renormalization.  Layout is limbs-first,
`limbs[K, *shape]`, exactly as in the JAX package, so the two compare limb
for limb.  Two representations share the container:

  * CLASSIC (exp is None): value = sum(limbs), float64 limbs.  K = 3
    carries 159 bits, K = 5 265, K = 8 424.
  * SCALED (exp an int32 tensor of the value shape): value =
    2^exp * sum(limbs), float32 limbs normalized so that limbs[0] has
    binary exponent CENTER(K) = max(0, 24K - 100).  The ladder then stays
    inside float32's normal range for K <= 9 (216 bits) while `exp` gives
    unlimited range.  Scaled K > 9 is the wide representation
    (ops/mpwide.py: a sum of G scaled words, each with its own exponent).
    Every public function here sends an `MPW` operand there, and `zeros`,
    `from_double` and `round_to` send a scaled K > MAX_SCALED_K there;
    `mul_full` and `add_full` below are the exact two-word product and sum
    the wide words are built on.

Every function here is the same sequence of IEEE operations as its JAX
counterpart on the CPU where the JAX package runs its unrolled renorm
(classic K <= 5, scaled K <= 3), so limbs agree bit for bit there.  Three
deliberate differences:
  * `renorm` has one form, the unrolled sweeps.  From classic K = 6 and
    scaled K = 4 the JAX package on the CPU switches to scan sweeps whose
    residue limb is a `jnp.sum` (mpfloat.py:94-99,817), so there it agrees
    only to the last limb.
  * Newton seeds for `rsqrt` are `1 / sqrt(m)` (correctly rounded on both
    devices); the JAX package seeds with `jax.lax.rsqrt`, which XLA:CPU
    rounds differently for part of the inputs, so `rsqrt` agrees with JAX
    only to within the Newton bound.
  * float32 subnormals are kept, by torch on the CPU and by the CUDA
    kernels (-ftz=false), so the two devices agree; XLA:CPU flushes them to
    zero.  From scaled K = 7 the last error terms of a product can fall
    that low, and there a scaled result may differ from the JAX package's
    in its last limb.

Products come in two term orders.  `mul` follows the JAX `mpfloat.mul`
(classic: sequential plan below K = 3, the vectorized `_mul_term_plan`
from K = 3; scaled: always vectorized).  `kmul` always follows the
sequential plan of `ops/mplist.py`, which is the order inside the Pallas
kernels and hence inside the CUDA kernels; the plain PyTorch versions of
those kernels use it.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .eft import quick_two_sum, split, two_sum

DTYPE = torch.float64
SCALED_DTYPE = torch.float32
# exponent of exact zeros in scaled mode: low enough never to win an
# alignment max, high enough that int32 sums of two cannot wrap
EXP_ZERO = -(1 << 24)
MAX_SCALED_K = 9
# uniform binary exponent a scaled product rescales every limb to first:
# products sit near 2^30, their Dekker errors near 2^6
MUL_UNIFORM_EXP = 15


def center_for(K: int) -> int:
    """Binary exponent of limbs[0] of a normalized scaled mantissa."""
    return max(0, 24 * K - 100)


# Device constants made from host values, once per key and device: a
# host-to-device copy inside a captured CUDA graph would either fail or
# replay a host buffer that is gone (solver/graphs.py), and the eager loop
# saves a copy per use.  No caller may write into a cached tensor.
_CONSTS = {}


def device_const(key, device, make):
    """The tensor (or MP) `make()` gives on `device`, made on first use of
    (key, device) and kept."""
    k = (key, str(torch.device(device)))
    out = _CONSTS.get(k)
    if out is None:
        out = _CONSTS[k] = make()
    return out


class MP:
    """limbs[K, *shape], value = 2^exp * sum of limbs (exp None: classic)."""

    __slots__ = ("limbs", "exp")

    def __init__(self, limbs: torch.Tensor, exp: torch.Tensor = None):
        self.limbs = limbs
        self.exp = exp

    @property
    def K(self) -> int:
        return self.limbs.shape[0]

    @property
    def shape(self) -> tuple:
        return tuple(self.limbs.shape[1:])

    @property
    def ndim(self) -> int:
        return self.limbs.dim() - 1

    @property
    def dtype(self):
        return self.limbs.dtype

    @property
    def device(self) -> torch.device:
        return self.limbs.device

    @property
    def scaled(self) -> bool:
        return self.exp is not None

    def __repr__(self):
        return (f"MP(K={self.K}, shape={self.shape}, device={self.device}, "
                f"scaled={self.scaled})")

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        return MP(self.limbs[(slice(None),) + idx],
                  None if self.exp is None else self.exp[idx])

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return MP(self.limbs.reshape((self.K,) + tuple(shape)),
                  None if self.exp is None else self.exp.reshape(shape))

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return MP(self.limbs.permute((0,) + tuple(a + 1 for a in axes)),
                  None if self.exp is None else self.exp.permute(axes))

    @property
    def mT(self):
        """Transpose of the last two value axes."""
        return MP(self.limbs.transpose(-1, -2),
                  None if self.exp is None else self.exp.transpose(-1, -2))


def _is_wide(x) -> bool:
    """True for an ops/mpwide.py MPW (checked by name: mpwide imports this
    module)."""
    return type(x).__name__ == "MPW"


def _wide():
    from . import mpwide

    return mpwide


def _wide_k(K: int, scaled: bool) -> bool:
    """A scaled K beyond one word's limbs is a wide value."""
    return scaled and K > MAX_SCALED_K


def _check_modes(a: MP, b: MP) -> None:
    if a.scaled != b.scaled:
        raise TypeError("cannot mix scaled and classic MP operands")


def _check_scaled_k(K: int) -> None:
    if K > MAX_SCALED_K:
        raise ValueError(f"a scaled MP word holds K <= {MAX_SCALED_K} float32 limbs "
                         f"(216 bits), got K={K}; wider values are MPW "
                         f"(ops/mpwide.py)")


# ---------------------------------------------------------------------------
# Powers of two (scaled mode)


def _pow2f(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 2^e for int32 e in [-126, 127], by bit assembly."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def _exp_bits(x: torch.Tensor) -> torch.Tensor:
    """Biased exponent field of float32 x (0 for zero and subnormals)."""
    return (x.view(torch.int32) >> 23) & 0xFF


def _scale_pow2(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """x * 2^d for int32 d broadcastable to x's trailing axes, in three
    clipped steps (|d| <= 381; each step rounds once, as in the JAX
    package's _scale_pow2_arr and _scale_pow2_rows); a negative residue
    flushes to zero."""
    for _ in range(3):
        step = torch.clamp(d, -126, 127)
        x = x * _pow2f(step)
        d = d - step
    return torch.where(d < 0, torch.zeros_like(x), x)


def _normalize_scaled(limbs: torch.Tensor, exp: torch.Tensor, K: int):
    """Re-center a renormalized mantissa so limbs[0] has binary exponent
    CENTER(K).  A top limb that is zero or subnormal marks an exact zero
    (limbs 0, exp EXP_ZERO)."""
    C = center_for(K)
    eb = _exp_bits(limbs[0])
    is_zero = eb == 0
    shift = torch.where(is_zero, torch.zeros_like(eb), eb - 127 - C)
    limbs = _scale_pow2(limbs, -shift)
    limbs = torch.where(is_zero, torch.zeros_like(limbs), limbs)
    exp = torch.where(is_zero, torch.full_like(eb, EXP_ZERO), exp + shift)
    return limbs, exp.to(torch.int32)


# ---------------------------------------------------------------------------
# Host conversions (numpy)


def _distill(rs):
    """Bottom-up TwoSum sweep: rs[0] becomes fl(sum), the rest exact."""
    for i in range(len(rs) - 2, -1, -1):
        s = rs[i] + rs[i + 1]
        v = s - rs[i]
        err = (rs[i] - (s - v)) + (rs[i + 1] - v)
        rs[i], rs[i + 1] = s, err
    return rs


def f64_to_scaled_parts(xs: np.ndarray, K: int):
    """float64 array -> (float32 limbs [K, *shape], int32 exp), exact."""
    xs = np.asarray(xs, dtype=np.float64)
    C = center_for(K)
    _, e = np.frexp(xs)
    is_zero = xs == 0.0
    shift = np.where(is_zero, 0, C + 1 - e).astype(np.int32)
    rem = np.ldexp(xs, shift)
    limbs = np.zeros((K,) + xs.shape, dtype=np.float32)
    for k in range(min(K, 3)):
        hi = rem.astype(np.float32)
        limbs[k] = hi
        rem = rem - hi.astype(np.float64)
    return limbs, np.where(is_zero, EXP_ZERO, -shift).astype(np.int32)


def f64_limbs_to_scaled_parts(limbs64: np.ndarray, K: int):
    """Classic float64 limb stack [K64, *shape] -> scaled parts (float32
    limbs [K, *shape], int32 exp), peeled at the value's own exponent.
    Every step is exact (power-of-two scalings and float64 TwoSums)."""
    limbs64 = np.asarray(limbs64, dtype=np.float64)
    shape = limbs64.shape[1:]
    C = center_for(K)
    is_zero = limbs64[0] == 0.0
    _, e = np.frexp(limbs64[0])
    shift = np.where(is_zero, 0, C + 1 - e).astype(np.int32)
    res = [np.ldexp(limbs64[k], shift) for k in range(limbs64.shape[0])]
    out = np.zeros((K,) + shape, dtype=np.float32)
    for k in range(K):
        res = _distill(res)
        hi = res[0].astype(np.float32)
        out[k] = hi
        res[0] = res[0] - hi.astype(np.float64)
    out[:, is_zero] = 0.0
    return out, np.where(is_zero, EXP_ZERO, -shift).astype(np.int32)


def scaled_parts_to_f64_limbs(limbs: np.ndarray, exp: np.ndarray,
                              K64: int) -> np.ndarray:
    """Scaled parts -> classic float64 limb stack [K64, *shape], exact
    while 2^exp * limb stays inside float64's range; a value beyond it
    raises rather than shrinking."""
    limbs = np.asarray(limbs, dtype=np.float64)
    # the lower clip keeps EXP_ZERO's 2^-1500 * limb an exact zero
    e = np.maximum(np.asarray(exp), -1500).astype(np.int64)
    with np.errstate(over="ignore"):
        res = [np.ldexp(limbs[k], e) for k in range(limbs.shape[0])]
    if not np.all(np.isfinite(res[0])):
        raise ValueError("scaled value exceeds float64 range (|x| > ~1e308); "
                         "cannot serialize to float64 limbs")
    out = np.zeros((K64,) + limbs.shape[1:], dtype=np.float64)
    for k in range(K64):
        res = _distill(res)
        out[k] = res[0]
        res[0] = res[0] - out[k]
    return out


def f64_limbs_to_classic(limbs64: np.ndarray, K: int) -> np.ndarray:
    """Float64 limb stack [K64, *shape] -> K classic float64 limbs,
    re-distilled (sdpb_tpu/ops/mpfloat.py:527): loads a checkpoint written
    at another precision."""
    res = [np.asarray(x, np.float64) for x in limbs64]
    out = np.zeros((K,) + np.shape(limbs64)[1:])
    for k in range(K):
        res = _distill(res)
        out[k] = res[0]
        res[0] = res[0] - out[k]
    return out


def host_f64_limbs(a: MP, K64: int = 0) -> np.ndarray:
    """Host float64 limb stack [K64, *shape] of any MP, re-distilled to K64
    limbs (default: enough for the full mantissa, K + 1 classic and
    ceil(24K/53) + 1 scaled), as sdpb_tpu's host_f64_limbs: the portable
    format of out.txt, y.txt and x_*.txt."""
    if _is_wide(a):
        return _wide().host_f64_limbs(a, K64)
    limbs = a.limbs.detach().cpu().numpy().astype(np.float64)
    if a.scaled:
        return scaled_parts_to_f64_limbs(limbs, a.exp.detach().cpu().numpy(),
                                         K64 or -(-(24 * a.K) // 53) + 1)
    K64 = K64 or a.K + 1
    if limbs.shape[0] == K64:
        return limbs
    return scaled_parts_to_f64_limbs(limbs, np.zeros(a.shape, np.int32), K64)


# ---------------------------------------------------------------------------
# Construction / conversion


def zeros(shape, K: int, device, scaled: bool = False) -> MP:
    if _wide_k(K, scaled):
        return _wide().zeros(shape, K, device)
    shape = tuple(shape)
    if not scaled:
        return MP(torch.zeros((K,) + shape, dtype=DTYPE, device=device))
    _check_scaled_k(K)
    return MP(torch.zeros((K,) + shape, dtype=SCALED_DTYPE, device=device),
              torch.full(shape, EXP_ZERO, dtype=torch.int32, device=device))


def from_parts(limbs, exp, device) -> MP:
    """Host (float32 limbs, int32 exp) parts as a scaled MP on `device`."""
    return MP(torch.as_tensor(np.asarray(limbs, dtype=np.float32), device=device),
              torch.as_tensor(np.asarray(exp, dtype=np.int32), device=device))


def _from_float_exp(f: torch.Tensor, e: torch.Tensor, K: int) -> MP:
    """Scaled MP of value f * 2^e from a float32 tensor (Newton seeds)."""
    limbs = torch.cat([f[None], torch.zeros((K - 1,) + f.shape, dtype=f.dtype,
                                            device=f.device)], 0)
    return MP(*_normalize_scaled(limbs, e, K))


def _tensor_to_scaled(x: torch.Tensor, K: int) -> MP:
    """A float32 or float64 tensor as a scaled MP on its device, exactly
    (a float64 mantissa fills at most 3 float32 limbs): the device
    counterpart of f64_to_scaled_parts.  For a float32 tensor it equals the
    JAX package's traced from_double (_from_float_exp(x, 0))."""
    m, e = torch.frexp(x.to(torch.float64))
    C = center_for(K)
    rem = m * 2.0 ** (C + 1)                    # exact
    limbs = torch.zeros((K,) + tuple(x.shape), dtype=SCALED_DTYPE, device=x.device)
    for k in range(min(K, 3)):
        limbs[k] = rem.to(SCALED_DTYPE)
        rem = rem - limbs[k].to(torch.float64)
    exp = torch.where(x == 0, torch.full_like(e, EXP_ZERO), e - (C + 1))
    return MP(*_normalize_scaled(limbs, exp.to(torch.int32), K))


def from_double(x, K: int, device=None, scaled: bool = False) -> MP:
    """Exact conversion from float64.  A host value (number or ndarray) is
    peeled into limbs on the host; a classic tensor becomes the top limb
    over K-1 zero limbs; a scaled one is converted on its device.  Host
    input needs an explicit `device`."""
    if isinstance(x, MP) or _is_wide(x):
        raise TypeError("already MP")
    if _wide_k(K, scaled):
        return _wide().from_double(x, K, device)
    if scaled:
        _check_scaled_k(K)
    if isinstance(x, torch.Tensor):
        if scaled:
            return _tensor_to_scaled(x, K)
        x = x.to(DTYPE)
        return MP(torch.cat([x[None], torch.zeros((K - 1,) + x.shape, dtype=DTYPE,
                                                   device=x.device)], 0))
    if device is None:
        raise ValueError("from_double of a host value needs a device")
    if scaled:
        return from_parts(*f64_to_scaled_parts(x, K), device)
    x = np.asarray(x, dtype=np.float64)
    limbs = np.zeros((K,) + x.shape, dtype=np.float64)
    limbs[0] = x
    return MP(torch.as_tensor(limbs, device=device))


def const(x: float, K: int, device, scaled: bool = False):
    """The host number x as an MP (or, scaled with K > MAX_SCALED_K, a
    wide MPW) on `device`, made once (device_const); read-only."""
    if _wide_k(K, scaled):
        return _wide().const(x, K, device)
    return device_const(("mp", float(x), K, scaled), device,
                        lambda: from_double(np.float64(x), K, device, scaled=scaled))


def to_scaled(a: MP, K: int) -> MP:
    """A classic float64 MP as a scaled K-limb MP on the same device (an
    exact host conversion when K limbs hold the value's bits)."""
    if a.scaled:
        return round_to(a, K)
    return from_parts(*f64_limbs_to_scaled_parts(a.limbs.cpu().numpy(), K),
                      a.device)


def _pow2d(e: torch.Tensor) -> torch.Tensor:
    """Exact float64 2^e for int64 e in [-1022, 1023], by bit assembly."""
    return ((e + 1023) << 52).view(torch.float64)


def to_double(a: MP) -> torch.Tensor:
    """Float64 approximation: the limbs summed top-down (logging only);
    scaled values beyond float64's exponent range saturate."""
    if _is_wide(a):
        return _wide().to_double(a)
    acc = a.limbs[0].to(torch.float64)
    for i in range(1, a.K):
        acc = acc + a.limbs[i].to(torch.float64)
    if a.scaled:
        e = torch.clamp(a.exp.to(torch.int64), -2044, 2046)
        e1 = torch.clamp(e, -1022, 1023)
        acc = acc * _pow2d(e1) * _pow2d(e - e1)
    return acc


def nearest_double(a: MP) -> torch.Tensor:
    """The value rounded to float64: for classic the top limb (a renormalized
    expansion's top limb is its rounded sum), for scaled the top limb of the
    float64 limbs renormalized to two, times 2^exp.  Summing the limbs
    (to_double) rounds twice now and then, a last-bit difference that would
    set a scaled run's step lengths apart from a classic run's."""
    if _is_wide(a):
        return _wide().nearest_double(a)
    if not a.scaled:
        return a.limbs[0]
    top = renorm([x.to(torch.float64) for x in a.limbs], 2).limbs[0]
    e = torch.clamp(a.exp.to(torch.int64), -2044, 2046)
    e1 = torch.clamp(e, -1022, 1023)
    return top * _pow2d(e1) * _pow2d(e - e1)


def to_float_array(a: MP) -> torch.Tensor:
    """Top limb plus the next one in the limb dtype (seeds, thresholds,
    error norms).  Scaled mode folds the exponent in with saturation:
    overflow gives +-float32 max, underflow 0 through subnormals."""
    if _is_wide(a):
        return _wide().to_float_array(a)
    m = a.limbs[0] if a.K == 1 else a.limbs[0] + a.limbs[1]
    if not a.scaled:
        return m
    C = center_for(a.K)
    m1 = m * 2.0 ** -min(C, 126)
    e = a.exp + C
    e1 = torch.clamp(e, -126, 127)
    e2 = torch.clamp(e - e1, -126, 0)
    f = m1 * _pow2f(e1) * _pow2f(e2)
    big = torch.sign(m) * float(np.finfo(np.float32).max)
    return torch.where(e > 127, big, f)


def round_to(a: MP, K: int) -> MP:
    """Keep the leading K limbs (zero-extend when K > a.K); scaled mode
    re-centers the mantissa on the new K's ladder.  A wide value rounds to
    its word 0 (K <= MAX_SCALED_K); a scaled K > MAX_SCALED_K widens."""
    if _is_wide(a):
        return _wide().round_to(a, K)
    if _wide_k(K, a.scaled):
        return _wide().widen(a, K)
    if a.scaled:
        _check_scaled_k(K)
    if K == a.K:
        return a
    if K < a.K:
        limbs = a.limbs[:K]
    else:
        pad = torch.zeros((K - a.K,) + a.shape, dtype=a.dtype, device=a.device)
        limbs = torch.cat([a.limbs, pad], 0)
    if not a.scaled:
        return MP(limbs)
    return MP(*_normalize_scaled(limbs, a.exp, K))


# ---------------------------------------------------------------------------
# Shape helpers (exponent-aware)


def neg(a: MP) -> MP:
    if _is_wide(a):
        return _wide().neg(a)
    return MP(-a.limbs, a.exp)


def _as_tensor(m, like: MP) -> torch.Tensor:
    if isinstance(m, torch.Tensor):
        return m.to(device=like.device, dtype=like.dtype)
    if isinstance(m, (int, float)):
        return device_const(("scalar", float(m), like.dtype), like.device,
                            lambda: torch.as_tensor(float(m), dtype=like.dtype,
                                                    device=like.device))
    return torch.as_tensor(np.asarray(m), dtype=like.dtype, device=like.device)


def mask_value(a: MP, m) -> MP:
    """Zero the elements where m (broadcastable to a.shape) is 0; scaled
    mode floors their exponents so they never win an alignment."""
    if _is_wide(a):
        return _wide().mask_value(a, m)
    mb = torch.broadcast_to(_as_tensor(m, a), a.shape)
    limbs = a.limbs * mb
    if not a.scaled:
        return MP(limbs)
    exp = torch.where(mb > 0, torch.broadcast_to(a.exp, a.shape),
                      torch.full(a.shape, EXP_ZERO, dtype=torch.int32,
                                 device=a.device))
    return MP(limbs, exp)


def take(a: MP, idx, axis: int) -> MP:
    """jnp.take on a value axis: an int drops the axis, a sequence keeps it."""
    if _is_wide(a):
        return _wide().take(a, idx, axis)
    axis = axis % a.ndim
    if isinstance(idx, int):
        return MP(a.limbs.select(axis + 1, idx),
                  None if a.exp is None else a.exp.select(axis, idx))
    idx = tuple(int(i) for i in idx)
    idx = device_const(("take", idx), a.device,
                       lambda: torch.as_tensor(idx, dtype=torch.long, device=a.device))
    return MP(a.limbs.index_select(axis + 1, idx),
              None if a.exp is None else a.exp.index_select(axis, idx))


def stack(ms: List[MP], axis: int) -> MP:
    if _is_wide(ms[0]):
        return _wide().stack(ms, axis)
    axis = axis % (ms[0].ndim + 1)
    limbs = torch.stack([m.limbs for m in ms], dim=axis + 1)
    if not ms[0].scaled:
        return MP(limbs)
    return MP(limbs, torch.stack([torch.broadcast_to(m.exp, m.shape) for m in ms],
                                 dim=axis))


def concatenate(ms: List[MP], axis: int) -> MP:
    if _is_wide(ms[0]):
        return _wide().concatenate(ms, axis)
    axis = axis % ms[0].ndim
    limbs = torch.cat([m.limbs for m in ms], dim=axis + 1)
    if not ms[0].scaled:
        return MP(limbs)
    return MP(limbs, torch.cat([m.exp for m in ms], dim=axis))


def _bcast(limbs: torch.Tensor, K: int, shape) -> torch.Tensor:
    """Broadcast [K, *value] limbs to [K, *shape] (left-pad value dims)."""
    lead = len(shape) - (limbs.dim() - 1)
    return limbs.reshape((K,) + (1,) * lead + tuple(limbs.shape[1:])).expand(
        (K,) + tuple(shape))


def broadcast_to(a: MP, shape) -> MP:
    if _is_wide(a):
        return _wide().broadcast_to(a, shape)
    shape = tuple(shape)
    return MP(_bcast(a.limbs, a.K, shape),
              None if a.exp is None else torch.broadcast_to(a.exp, shape))


def diagonal(a: MP) -> MP:
    """Diagonal over the last two value axes."""
    if _is_wide(a):
        return _wide().diagonal(a)
    return MP(torch.diagonal(a.limbs, dim1=-2, dim2=-1),
              None if a.exp is None else torch.diagonal(a.exp, dim1=-2, dim2=-1))


def set_block(a: MP, idx: tuple, b: MP) -> None:
    """a[idx] = b IN PLACE (limbs and exponents), where the JAX package's
    set_block returns an updated copy."""
    if _is_wide(a):
        return _wide().set_block(a, idx, b)
    a.limbs[(slice(None),) + idx] = b.limbs
    if a.scaled:
        a.exp[idx] = b.exp


def scalar_eye(s: MP, n: int) -> MP:
    """s * I as an [..., n, n] MP from a (batched) scalar s."""
    if _is_wide(s):
        return _wide().scalar_eye(s, n)
    eye = torch.eye(n, dtype=s.dtype, device=s.device)
    limbs = s.limbs[..., None, None] * eye
    if not s.scaled:
        return MP(limbs)
    exp = torch.where(eye > 0, s.exp[..., None, None],
                      torch.full((n, n), EXP_ZERO, dtype=torch.int32,
                                 device=s.device))
    return MP(limbs, exp)


def expand_dims(a: MP, axis: int) -> MP:
    if _is_wide(a):
        return _wide().expand_dims(a, axis)
    if axis < 0:
        axis = a.ndim + 1 + axis
    return MP(a.limbs.unsqueeze(axis + 1),
              None if a.exp is None else a.exp.unsqueeze(axis))


def pad_dim(a: MP, axis: int, count: int) -> MP:
    """Zero-pad `count` elements at the end of value axis `axis` (scaled
    zeros carry EXP_ZERO)."""
    if _is_wide(a):
        return _wide().pad_dim(a, axis, count)
    axis = axis % a.ndim
    shape = list(a.limbs.shape)
    shape[axis + 1] = count
    limbs = torch.cat([a.limbs, torch.zeros(shape, dtype=a.dtype, device=a.device)],
                      dim=axis + 1)
    if not a.scaled:
        return MP(limbs)
    eshape = shape[1:]
    pad = torch.full(eshape, EXP_ZERO, dtype=torch.int32, device=a.device)
    return MP(limbs, torch.cat([a.exp, pad], dim=axis))


# ---------------------------------------------------------------------------
# Renormalization (distillation by repeated extraction, mpfloat.py:774-878)


def sweeps(xs: Sequence[torch.Tensor], K: int, chain: bool) -> List[torch.Tensor]:
    """K bottom-up carry-chain extraction sweeps over the rows: sweep k
    runs i = m-2 .. k with (carry, xs[i+1]) = two_sum(xs[i], carry) from
    carry = xs[m-1], then xs[k] = carry.  With `chain` the residue rows
    K.. are then chain-summed into row K (the renorm tail), otherwise they
    are left as the exact residual.

    The sweeps run as a wavefront, with the same operations on the same
    values: sweep k takes its step j at time T = j + 2k, by when sweep k-1
    has finalized the rows it reads, so each time step is one batched
    TwoSum over the active sweeps (rows at stride 2), about m + K torch
    ops in all where one sweep after the other takes about 6 K m.  The
    chain tail is one more lane whose sums are the TwoSums' sums (IEEE
    addition commutes) and whose errors are dropped."""
    m = len(xs)
    L = min(K, m - 1)
    lanes = L + (1 if chain and m - 1 > K else 0)
    if lanes == 0:
        return list(xs)
    X = torch.stack(torch.broadcast_tensors(*xs))
    C = torch.empty((lanes,) + tuple(X.shape[1:]), dtype=X.dtype, device=X.device)
    for T in range(m + lanes - 2):
        lo, hi = max(0, T - (m - 2)), min(lanes - 1, T // 2)
        if T % 2 == 0 and T // 2 < lanes:
            C[T // 2] = X[m - 1]                 # sweep T/2 starts
        r = m - 2 - T + 2 * lo                   # the row sweep `lo` reads
        s, e = two_sum(X[r:r + 2 * (hi - lo) + 1:2], C[lo:hi + 1])
        C[lo:hi + 1] = s
        hw = min(hi, L - 1)
        if hw >= lo:
            X[r + 1:r + 2 * (hw - lo) + 2:2] = e[:hw - lo + 1]
        if T >= m - 2:                           # sweep T-(m-2) ends
            X[T - (m - 2)] = C[T - (m - 2)]
    return list(X.unbind(0))


def renorm(xs: Sequence[torch.Tensor], K: int, exp: torch.Tensor = None) -> MP:
    """Distill a list of limb tensors into a K-limb MP.  K bottom-up TwoSum
    sweeps extract the limbs, the residue is chain-summed into limb K
    (both by `sweeps`), and a top-down then bottom-up quick-two-sum pass
    compacts the result.  With `exp` the list is a mantissa at that common
    exponent, and the result is re-centered on the CENTER(K) ladder."""
    xs = list(torch.broadcast_tensors(*xs))
    if len(xs) < K + 2:
        xs += [torch.zeros_like(xs[0])] * (K + 2 - len(xs))
    xs = sweeps(xs, K, chain=True)
    for i in range(K):
        xs[i], xs[i + 1] = quick_two_sum(xs[i], xs[i + 1])
    for i in range(K - 1, 0, -1):
        xs[i - 1], xs[i] = quick_two_sum(xs[i - 1], xs[i])
    limbs = torch.stack(xs[:K], 0)
    if exp is None:
        return MP(limbs)
    return MP(*_normalize_scaled(limbs, exp, K))


# ---------------------------------------------------------------------------
# Addition / multiplication


def add(a: MP, b: MP) -> MP:
    """Limbs interleaved a0 b0 a1 b1 ... then renorm; scaled operands are
    first aligned on the larger exponent."""
    if _is_wide(a) or _is_wide(b):
        return _wide().add(a, b)
    assert a.K == b.K, (a.K, b.K)
    _check_modes(a, b)
    K = a.K
    shape = torch.broadcast_shapes(a.shape, b.shape)
    al = _bcast(a.limbs, K, shape)
    bl = _bcast(b.limbs, K, shape)
    exp = None
    if a.scaled:
        ae = torch.broadcast_to(a.exp, shape)
        be = torch.broadcast_to(b.exp, shape)
        exp = torch.maximum(ae, be)
        al = _scale_pow2(al, ae - exp)
        bl = _scale_pow2(bl, be - exp)
    xs = []
    for i in range(K):          # interleaved: roughly magnitude-sorted
        xs.append(al[i])
        xs.append(bl[i])
    return renorm(xs, K, exp)


def sub(a: MP, b: MP) -> MP:
    return add(a, neg(b))


def _mul_terms(a: MP, b: MP, sequential: bool):
    """The truncated (CAMPARY-style) limb product as an ordered term list,
    plus the scaled result's exponent (None for classic).

    Exact TwoProds for limb pairs i+j <= K-1, their errors for i+j <= K-2
    and plain products on the i+j == K tail.  The products are formed as
    one broadcast [K, K] outer product (elementwise, so every term has the
    same bits as a scalar TwoProd); only the ORDER of the list differs:
      * sequential (mpfloat.py:1031-1055, mplist.py:155-235): diagonal n
        lists the errors of diagonal n-1, then its products; the tail is
        one chained sum;
      * vectorized (_mul_term_plan, mpfloat.py:929-1010): diagonal n lists
        its products, then the errors of diagonal n-1; the tail terms stay
        separate.
    Scaled operands are first rescaled limb by limb to the uniform
    magnitude 2^MUL_UNIFORM_EXP; each term is then put back on the result's
    ladder by two exact power-of-two factors chosen by its product's
    diagonal (a chained tail is summed before it is put back)."""
    K = a.K
    shape = torch.broadcast_shapes(a.shape, b.shape)
    al = _bcast(a.limbs, K, shape)
    bl = _bcast(b.limbs, K, shape)
    scaled = a.scaled
    C = center_for(K) if scaled else 0
    if scaled:
        pre = device_const(("mul_pre", K), al.device, lambda: torch.tensor(
            [2.0 ** (24 * i - C + MUL_UNIFORM_EXP) for i in range(K)],
            dtype=SCALED_DTYPE, device=al.device))
        pre = pre.reshape((K,) + (1,) * len(shape))
        al = al * pre
        bl = bl * pre
    ah, alo = split(al)
    bh, blo = split(bl)
    P = al[:, None] * bl[None, :]
    E = ((ah[:, None] * bh[None, :] - P) + ah[:, None] * blo[None, :]
         + alo[:, None] * bh[None, :]) + alo[:, None] * blo[None, :]

    def put(t, n):
        if not scaled:
            return t
        d = C - 2 * MUL_UNIFORM_EXP - 24 * n
        d1 = int(np.clip(d, -126, 127))
        d2 = int(np.clip(d - d1, -126, 127))
        return t * 2.0 ** d1 * 2.0 ** d2

    xs = []
    for n in range(K):
        prods = [put(P[i, n - i], n) for i in range(n + 1)]
        errs = [put(E[i, n - 1 - i], n - 1) for i in range(n)]
        xs.extend(errs + prods if sequential else prods + errs)
    tail = [P[i, K - i] for i in range(1, K)]
    if sequential:
        if tail:
            t = tail[0]
            for x in tail[1:]:
                t = t + x
            xs.append(put(t, K))
    else:
        xs.extend(put(t, K) for t in tail)
    exp = None
    if scaled:
        exp = (torch.broadcast_to(a.exp, shape) + torch.broadcast_to(b.exp, shape)
               + C)
    return xs, exp


def mul(a: MP, b: MP) -> MP:
    """Truncated expansion product in the JAX `mpfloat.mul` term order."""
    if _is_wide(a) or _is_wide(b):
        return _wide().mul(a, b)
    assert a.K == b.K, (a.K, b.K)
    _check_modes(a, b)
    xs, exp = _mul_terms(a, b, sequential=not a.scaled and a.K < 3)
    return renorm(xs, a.K, exp)


def kmul(a: MP, b: MP) -> MP:
    """Truncated expansion product in the kernels' term order (mplist.mul)."""
    assert a.K == b.K, (a.K, b.K)
    _check_modes(a, b)
    xs, exp = _mul_terms(a, b, sequential=True)
    return renorm(xs, a.K, exp)


def mul_term_plan(K: int):
    """The vectorized plan (_mul_term_plan, mpfloat.py:929-957): row
    indices into the stacked [2K^2] (products, errors) terms by diagonal,
    and each row's product diagonal (which sets its placement scale)."""
    idx, diag = [], []
    for n in range(K + 1):
        if n < K:
            idx += [i * K + n - i for i in range(n + 1)]
            diag += [n] * (n + 1)
        if 1 <= n <= K - 1:
            idx += [K * K + i * K + n - 1 - i for i in range(n)]
            diag += [n - 1] * n
        if n == K:
            idx += [i * K + K - i for i in range(1, K)]
            diag += [n] * (K - 1)
    return np.asarray(idx, np.int32), np.asarray(diag, np.int32)


def mul_term_plan_full(K: int) -> np.ndarray:
    """Order of the FULL limb product (_mul_term_plan_full,
    mpfloat.py:1085-1097): every product and then its error, by product
    diagonal; index % K^2 recovers the limb pair."""
    idx = []
    for n in range(2 * K - 1):
        for i in range(max(0, n - K + 1), min(K, n + 1)):
            idx += [i * K + n - i, K * K + i * K + n - i]
    return np.asarray(idx, np.int32)


def _compact_hi(xs: List[torch.Tensor], K: int) -> torch.Tensor:
    """TwoSum compaction confined to the K extracted limbs, forward then
    back (exact rearrangement)."""
    his = list(xs[:K])
    for i in range(K - 1):
        his[i], his[i + 1] = two_sum(his[i], his[i + 1])
    for i in range(K - 1, 0, -1):
        his[i - 1], his[i] = two_sum(his[i - 1], his[i])
    return torch.stack(his, 0)


def _lift_residual(rows: List[torch.Tensor], K: int) -> List[torch.Tensor]:
    """The exact residual re-laddered 24K binary digits up onto the lo
    word's exponent, in separate multiplies of at most 2^108 (one factor
    2^(24K) would overflow float32)."""
    r = torch.stack(rows)
    sc = 24 * K
    while sc > 0:
        stp = min(sc, 108)
        r = r * 2.0 ** stp
        sc -= stp
    return list(r)


def mul_full(a: MP, b: MP):
    """The scaled product as TWO scaled words (hi, lo), hi + lo == a * b
    exactly (mpfloat.py:1100-1183): every diagonal of the limb product is
    kept, each limb lifted to about 2^MUL_UNIFORM_EXP by its own power of
    two, each term routed by content onto the hi ladder (when its whole
    mantissa stays a float32 normal there) or 24K binary digits down onto
    the lo ladder; the hi word is extracted error-free and its exact
    residual joins the lo word."""
    assert a.scaled and b.scaled and a.K == b.K, (a.K, b.K)
    K = a.K
    U = MUL_UNIFORM_EXP
    C = center_for(K)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    al = _bcast(a.limbs, K, shape)
    bl = _bcast(b.limbs, K, shape)
    ea, eb = _exp_bits(al), _exp_bits(bl)
    lift_a = torch.where(ea == 0, torch.zeros_like(ea), U + 127 - ea)
    lift_b = torch.where(eb == 0, torch.zeros_like(eb), U + 127 - eb)
    # lifts lie in [-112, 141]: two staged factors (the third is 2^0)
    As, Bs = _scale_pow2(al, lift_a), _scale_pow2(bl, lift_b)
    ah, alo = split(As)
    bh, blo = split(Bs)
    P = As[:, None] * Bs[None, :]
    E = ((ah[:, None] * bh[None, :] - P) + ah[:, None] * blo[None, :]
         + alo[:, None] * bh[None, :]) + alo[:, None] * blo[None, :]
    PE = torch.cat([P.reshape((K * K,) + shape), E.reshape((K * K,) + shape)], 0)
    D = (-(lift_a[:, None] + lift_b[None, :]) - C).reshape((K * K,) + shape)
    exp_hi = torch.broadcast_to(a.exp, shape) + torch.broadcast_to(b.exp, shape) + C
    idx = device_const(("mul_plan_full", K), al.device, lambda: torch.as_tensor(
        mul_term_plan_full(K), dtype=torch.long, device=al.device))
    G = PE[idx]
    Drow = D[idx % (K * K)]
    keep_hi = (_exp_bits(G) + Drow) >= 24
    zero = torch.zeros_like(G)
    S_hi = _scale_pow2(torch.where(keep_hi, G, zero), Drow)
    S_lo = _scale_pow2(torch.where(keep_hi, zero, G), Drow + 24 * K)
    # the K extraction sweeps leave the EXACT residual in rows K..
    # (_sweeps_exact_scan, mpfloat.py:1058-1082)
    xs = sweeps(list(S_hi), K, chain=False)
    hi = MP(*_normalize_scaled(_compact_hi(xs, K), exp_hi, K))
    lo = renorm(_lift_residual(xs[K:], K) + list(S_lo), K, exp_hi - 24 * K)
    return hi, lo


def add_full(a: MP, b: MP):
    """TwoSum of scaled words: hi + lo == a + b exactly, for leading
    cancellation up to about 242 bits (mpfloat.py:1186-1256).  Limb rows
    are routed by content: a row stays on the hi ladder when its whole
    mantissa survives the shift to the common top as float32 normals,
    deeper rows go straight to the lo ladder 24K binary digits down.  The
    hi stack is extracted error-free and its exact residual joins the lo
    stack."""
    assert a.scaled and b.scaled and a.K == b.K, (a.K, b.K)
    K = a.K
    shape = torch.broadcast_shapes(a.shape, b.shape)
    al = _bcast(a.limbs, K, shape)
    bl = _bcast(b.limbs, K, shape)
    ae = torch.broadcast_to(a.exp, shape)
    be = torch.broadcast_to(b.exp, shape)
    e_hi = torch.maximum(ae, be)

    def route(limbs, we):
        d = we - e_hi
        keep_hi = (_exp_bits(limbs) + d) >= 24
        zero = torch.zeros_like(limbs)
        return (_scale_pow2(torch.where(keep_hi, limbs, zero), d),
                _scale_pow2(torch.where(keep_hi, zero, limbs), d + 24 * K))

    a_hi, a_lo = route(al, ae)
    b_hi, b_lo = route(bl, be)
    rows = []
    for i in range(K):
        rows += [a_hi[i], b_hi[i]]
    xs = sweeps(rows, K, chain=False)
    hi = MP(*_normalize_scaled(_compact_hi(xs, K), e_hi, K))
    lo_rows = _lift_residual(xs[K:], K)
    for i in range(K):
        lo_rows += [a_lo[i], b_lo[i]]
    return hi, renorm(lo_rows, K, e_hi - 24 * K)


def mul_pow2(a: MP, p) -> MP:
    """Exact scaling by a power of two (scalar or per element); a scaled
    operand and a host power of two change only the exponent."""
    if _is_wide(a):
        return _wide().mul_pow2(a, p)
    if a.scaled and not isinstance(p, torch.Tensor):
        pf = float(p)
        e = int(np.log2(abs(pf)))
        if 2.0 ** e == abs(pf):
            exp = torch.where(a.exp == EXP_ZERO, a.exp, a.exp + e)
            return MP(a.limbs if pf > 0 else -a.limbs, exp)
    limbs = a.limbs * (p.to(a.dtype) if isinstance(p, torch.Tensor) else float(p))
    if not a.scaled:
        return MP(limbs)
    return MP(*_normalize_scaled(limbs, a.exp, a.K))


# ---------------------------------------------------------------------------
# Newton iterations


def newton_steps(K: int) -> int:
    """Limbs of accuracy double per step from one limb, plus one step."""
    n, acc = 0, 1.0
    while acc < K:
        acc *= 2
        n += 1
    return n + 1


def _seeded(seed: torch.Tensor, K: int) -> MP:
    return MP(torch.cat([seed[None], torch.zeros((K - 1,) + seed.shape,
                                                 dtype=seed.dtype,
                                                 device=seed.device)], 0))


def _unit_mantissa(a: MP) -> torch.Tensor:
    """Top ~48 bits of a scaled mantissa, moved to about [1, 2)."""
    m = a.limbs[0] if a.K == 1 else a.limbs[0] + a.limbs[1]
    return m * 2.0 ** -min(center_for(a.K), 126)


def reciprocal(b: MP, kernel_order: bool = False) -> MP:
    """1/b by Newton: r <- r + r (1 - b r)."""
    if _is_wide(b):
        return _wide().reciprocal(b)
    m_ = kmul if kernel_order else mul
    one = const(1.0, b.K, b.device, scaled=b.scaled)
    if b.scaled:
        m = _unit_mantissa(b)
        r = _from_float_exp(torch.ones_like(m) / m, -(b.exp + center_for(b.K)), b.K)
    else:
        r = _seeded(1.0 / to_float_array(b), b.K)
    for _ in range(newton_steps(b.K)):
        r = add(r, m_(r, sub(one, m_(b, r))))
    return r


def div(a: MP, b: MP) -> MP:
    r = reciprocal(b)
    q = mul(a, r)
    rem = sub(a, mul(b, q))     # one refinement: q += (a - b q) r
    return add(q, mul(rem, r))


def inv_sqrt(m: torch.Tensor) -> torch.Tensor:
    """fl(1 / fl(sqrt(m))): both steps correctly rounded, as `1 / sqrt(m)`
    in the CUDA kernels.  torch's vectorized float64 sqrt on the CPU is not
    correctly rounded, so CPU tensors take numpy's (IEEE) sqrt."""
    if m.device.type == "cpu":
        out = torch.empty_like(m)
        np.divide(1.0, np.sqrt(m.numpy()), out=out.numpy())
        return out
    return 1.0 / torch.sqrt(m)


def rsqrt(a: MP, kernel_order: bool = False) -> MP:
    """1/sqrt(a) by Newton: r <- r (3/2 - a r^2 / 2); a > 0.  Seeded with
    the correctly rounded 1/sqrt(m), never a device rsqrt; a scaled seed
    takes the mantissa times 2^(exp mod 2) and the exponent's half."""
    if _is_wide(a):
        return _wide().rsqrt(a)
    m_ = kmul if kernel_order else mul
    half = const(0.5, a.K, a.device, scaled=a.scaled)
    three_half = const(1.5, a.K, a.device, scaled=a.scaled)
    if a.scaled:
        E = a.exp + center_for(a.K)
        q = E >> 1
        x2 = _unit_mantissa(a) * _pow2f(E - 2 * q)      # in [1, 4)
        r = _from_float_exp(inv_sqrt(x2), -q, a.K)
    else:
        r = _seeded(inv_sqrt(to_float_array(a)), a.K)
    for _ in range(newton_steps(a.K)):
        arr = m_(a, m_(r, r))
        r = m_(r, sub(three_half, m_(half, arr)))
    return r


def sqrt(a: MP) -> MP:
    """sqrt via the rsqrt Newton chain plus one refinement; zero gives
    zero, a negative input NaN."""
    if _is_wide(a):
        return _wide().sqrt(a)
    half = const(0.5, a.K, a.device, scaled=a.scaled)
    top = a.limbs[0]
    is_zero = top <= 0
    one_l = torch.zeros_like(a.limbs)
    one_l[0] = 2.0 ** center_for(a.K) if a.scaled else 1.0
    a_safe = MP(torch.where(is_zero, one_l, a.limbs))
    if a.scaled:
        a_safe = MP(*_normalize_scaled(
            a_safe.limbs, torch.where(is_zero, torch.zeros_like(a.exp), a.exp), a.K))
    r = rsqrt(a_safe)
    s = mul(a_safe, r)
    rem = sub(a_safe, mul(s, s))
    s = add(s, mul(rem, mul(r, half)))
    sign_ok = torch.where(top < 0, torch.full_like(top, float("nan")),
                          torch.ones_like(top))
    limbs = torch.where(is_zero, torch.zeros_like(s.limbs), s.limbs * sign_ok)
    if not a.scaled:
        return MP(limbs)
    return MP(limbs, torch.where(is_zero, torch.full_like(s.exp, EXP_ZERO), s.exp))


# ---------------------------------------------------------------------------
# Comparisons, selection, reductions


def sign_array(a: MP) -> torch.Tensor:
    """Elementwise sign: the sign of the first nonzero limb (the exponent
    never changes it)."""
    if _is_wide(a):
        return _wide().sign_array(a)
    s = torch.sign(a.limbs[a.K - 1])
    for i in range(a.K - 2, -1, -1):
        s = torch.where(a.limbs[i] != 0, torch.sign(a.limbs[i]), s)
    return s


def lt(a: MP, b: MP) -> torch.Tensor:
    return sign_array(sub(a, b)) < 0


def where(cond, a: MP, b: MP) -> MP:
    if _is_wide(a) or _is_wide(b):
        return _wide().where(cond, a, b)
    _check_modes(a, b)
    if isinstance(cond, (bool, np.bool_)):
        cond = device_const(("cond", bool(cond)), a.device,
                            lambda: torch.tensor(bool(cond), device=a.device))
    elif not isinstance(cond, torch.Tensor):
        cond = torch.as_tensor(np.asarray(cond, dtype=bool), device=a.device)
    shape = torch.broadcast_shapes(a.shape, b.shape, tuple(cond.shape))
    c = torch.broadcast_to(cond, shape)
    limbs = torch.where(c, _bcast(a.limbs, a.K, shape), _bcast(b.limbs, b.K, shape))
    if not a.scaled:
        return MP(limbs)
    return MP(limbs, torch.where(c, torch.broadcast_to(a.exp, shape),
                                 torch.broadcast_to(b.exp, shape)))


def abs_(a: MP) -> MP:
    if _is_wide(a):
        return _wide().abs_(a)
    s = sign_array(a)
    return MP(a.limbs * torch.where(s < 0, -1.0, 1.0).to(a.dtype), a.exp)


def maximum(a: MP, b: MP) -> MP:
    return where(lt(a, b), b, a)


def minimum(a: MP, b: MP) -> MP:
    return where(lt(a, b), a, b)


def sum_(a: MP, axis=None) -> MP:
    """Pairwise-tree sum along `axis` (None: all axes) at full precision."""
    if axis is None:
        return _sum_axis0(a.reshape((int(np.prod(a.shape)),) if a.shape else (1,)))
    axis = axis % a.ndim
    perm = [axis] + [i for i in range(a.ndim) if i != axis]
    return _sum_axis0(a.transpose(perm))


def _sum_axis0(a: MP) -> MP:
    """Halve repeatedly: add the two halves, carry an odd last element."""
    n = a.shape[0]
    while n > 1:
        half = n // 2
        s = add(a[:half], a[half:2 * half])
        if n % 2:
            s = concatenate([s, a[n - 1:n]], axis=0)
        a = s
        n = a.shape[0]
    return a[0]


def max_abs(a: MP) -> torch.Tensor:
    """max |a| in the limb dtype (error norms)."""
    if _is_wide(a):
        return _wide().max_abs(a)
    m = torch.abs(to_float_array(a))
    return torch.max(m) if a.ndim else m


def dot(a: MP, b: MP) -> MP:
    """Full-precision dot product of 1-D MP vectors."""
    return sum_(mul(a, b), axis=0)
