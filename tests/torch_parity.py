"""Shared helpers of the tests that hold the PyTorch port (sdpb_tpu_torch)
against the JAX package (sdpb_tpu) on the CPU: inputs are made with numpy
from a seed and handed to both packages as the same float64 limbs.

Importing this module imports no JAX (only `J` does), so the CUDA tests
can use it on a machine without JAX."""
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
