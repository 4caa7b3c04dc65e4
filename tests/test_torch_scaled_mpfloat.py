"""The port's scaled MP arithmetic (float32 limbs and an int32 exponent per
element, sdpb_tpu_torch.ops.mpfloat) against the JAX package's scaled
representation on the CPU.

Tolerances:
  * host conversions, structural helpers, add, sub, mul, div, reciprocal,
    sums, comparisons: bit-identical limbs and exponents at K32 <= 3 (the
    JAX package runs its unrolled renorm there, the same IEEE op
    sequence).
  * the same ops at K32 >= 4: bit-identical or within 2^-(24K-10)
    relative (JAX on the CPU switches to scan renorms there).
  * rsqrt and sqrt: bit-identical or within 2^-(24K-10) relative at
    K32 <= 5, 2^-(24K-40) at K32 = 9.  The port seeds Newton with the
    correctly rounded float32 1/sqrt(m); JAX seeds with jax.lax.rsqrt,
    which XLA:CPU rounds differently for part of the inputs.  With the JAX
    seed substituted the chain is bit-identical (asserted below; from
    K32 = 7 only with float32 subnormals flushed, as XLA:CPU flushes them
    and the port does not: otherwise within the Newton bound).  At
    K32 = 9 the chain itself is accurate to about 2^-185 against mpmath in
    both packages (measured: JAX 2^-184.8, the port 2^-188.6), so two
    seeds end that far apart; the port's error against mpmath is asserted
    below 2^-(24K-40).
  * nearest_double (the float64 a step length is computed from): the
    value rounded to nearest, exactly, where summing the limbs
    (to_double, the JAX package's) can be one ulp off.
  * the kernel term order (kmul, reciprocal and rsqrt in kernel order)
    against ops/mplist.py, the arithmetic inside the Pallas kernels, on
    the same terms.
"""
import mpmath
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdpb_tpu.ops import mplist as ml, mpfloat as jmp
from sdpb_tpu_torch.ops import mpfloat as tmp
from sdpb_tpu_torch.utils.strings import scaled_limbs_to_mpf

from torch_parity import J, T, rand_scaled, same_scaled, scaled_rel_err

torch.set_num_threads(1)


def _bound(K):
    return 2.0 ** -(24 * K - 10)


def _newton_bound(K):
    return _bound(K) if K <= 5 else 2.0 ** -(24 * K - 40)


def _check(name, K, jres, tres, seeded=False):
    """Bit-identical where the op sequence is identical, else the bound."""
    if same_scaled(jres, tres):
        return
    assert K >= 4 or seeded, f"{name} at K={K} is not bit-identical"
    err = scaled_rel_err(tres, jres)
    assert err < (_newton_bound(K) if seeded else _bound(K)), (name, K, err)


def _inputs(K, seed, shape=(6, 7)):
    rng = np.random.default_rng(seed)
    return (rand_scaled(rng, shape, K), rand_scaled(rng, shape, K),
            rand_scaled(rng, shape, K, positive=True), rand_scaled(rng, shape[-1:], K))


@pytest.mark.parametrize("K", [2, 3])
def test_scaled_ops_match_jax(K):
    a, b, c, v = _inputs(K, 100 + K)
    ja, jb, jc, jv = J(a), J(b), J(c), J(v)
    ta, tb, tc, tv = T(a), T(b), T(c), T(v)
    mask = np.zeros((6, 7), np.float32)
    mask[::2] = 1.0
    cond = a[0][0] > 0
    pairs = [
        ("add", jmp.add(ja, jb), tmp.add(ta, tb)),
        ("sub", jmp.sub(ja, jb), tmp.sub(ta, tb)),
        ("mul", jmp.mul(ja, jb), tmp.mul(ta, tb)),
        ("mul_bcast", jmp.mul(ja, jv), tmp.mul(ta, tv)),
        ("mul_pow2", jmp.mul_pow2(ja, np.float64(0.25)), tmp.mul_pow2(ta, 0.25)),
        ("mul_pow2_neg", jmp.mul_pow2(ja, np.float64(-2.0)), tmp.mul_pow2(ta, -2.0)),
        ("mul_pow2_arr", jmp.mul_pow2(ja, jnp.asarray(np.float32(3.0))),
         tmp.mul_pow2(ta, torch.tensor(3.0))),
        ("div", jmp.div(ja, jc), tmp.div(ta, tc)),
        ("reciprocal", jmp.reciprocal(jb), tmp.reciprocal(tb)),
        ("sum_axis", jmp.sum_(ja, axis=1), tmp.sum_(ta, axis=1)),
        ("sum_all", jmp.sum_(ja), tmp.sum_(ta)),
        ("dot", jmp.dot(jv, jv), tmp.dot(tv, tv)),
        ("abs", jmp.abs_(jb), tmp.abs_(tb)),
        ("maximum", jmp.maximum(ja, jb), tmp.maximum(ta, tb)),
        ("minimum", jmp.minimum(ja, jb), tmp.minimum(ta, tb)),
        ("where", jmp.where(jnp.asarray(cond), ja, jb),
         tmp.where(torch.as_tensor(cond), ta, tb)),
        ("mask", jmp.mask_value(ja, jnp.asarray(mask)), tmp.mask_value(ta, torch.tensor(mask))),
        ("round_down", jmp.round_to(ja, 2), tmp.round_to(ta, 2)),
        ("round_up", jmp.round_to(ja, K + 1), tmp.round_to(ta, K + 1)),
        ("scalar_eye", jmp.scalar_eye(jv, 3), tmp.scalar_eye(tv, 3)),
        ("pad", jmp.pad_dim(ja, 1, 3), tmp.pad_dim(ta, 1, 3)),
        ("take", jmp.take(ja, jnp.asarray([4, 0]), 1), tmp.take(ta, [4, 0], 1)),
        ("stack", jmp.stack([ja, jb], 1), tmp.stack([ta, tb], 1)),
        ("concat", jmp.concatenate([ja, jb], 0), tmp.concatenate([ta, tb], 0)),
        ("diagonal", jmp.diagonal(ja[:, :6]), tmp.diagonal(ta[:, :6])),
    ]
    for name, jres, tres in pairs:
        _check(name, K, jres, tres)
    for name, jres, tres in (("rsqrt", jmp.rsqrt(jc), tmp.rsqrt(tc)),
                             ("sqrt", jmp.sqrt(jc), tmp.sqrt(tc))):
        _check(name, K, jres, tres, seeded=True)
    for jres, tres in ((jmp.to_float_array(jb), tmp.to_float_array(tb)),
                       (jmp.to_double(jb), tmp.to_double(tb)),
                       (jmp.max_abs(jb), tmp.max_abs(tb)),
                       (jmp.lt(ja, jb), tmp.lt(ta, tb))):
        assert np.array_equal(np.asarray(jres), tres.numpy())
    assert np.array_equal(jmp.host_f64_limbs(ja), tmp.host_f64_limbs(ta))


@pytest.mark.parametrize("K", [5, 9])
def test_scaled_core_ops_match_jax_high_k(K):
    """From K32 = 4 the JAX package renormalizes with scan sweeps on the
    CPU; add, mul and the Newton reciprocal (every other op is built from
    them) are bit-identical or within the bound."""
    a, b, _, _ = _inputs(K, 300 + K, (4, 5))
    _check("add", K, jmp.add(J(a), J(b)), tmp.add(T(a), T(b)))
    _check("mul", K, jmp.mul(J(a), J(b)), tmp.mul(T(a), T(b)))
    _check("reciprocal", K, jmp.reciprocal(J(b)), tmp.reciprocal(T(b)))


@pytest.mark.parametrize("K", [2, 3, 5, 9])
def test_scaled_kernel_order_ops_match_mplist(K):
    """kmul and the kernel-order Newton chains follow ops/mplist.py (the
    arithmetic inside the Pallas kernels); rsqrt up to its seed."""
    a, b, c, _ = _inputs(K, 200 + K, (5, 7))
    lv = lambda p: ([jnp.asarray(p[0][k]) for k in range(K)], jnp.asarray(p[1]))
    st = lambda v: jmp.MP(jnp.stack(v[0]), v[1])
    _check("kmul", K, st(ml.mul(lv(a), lv(b), K)), tmp.kmul(T(a), T(b)))
    _check("add", K, st(ml.add(lv(a), lv(b), K)), tmp.add(T(a), T(b)))
    _check("reciprocal", K, st(ml.reciprocal(lv(b), K)),
           tmp.reciprocal(T(b), kernel_order=True))
    r = tmp.rsqrt(T(c), kernel_order=True)
    _check("rsqrt", K, st(ml.rsqrt(lv(c), K)), r, seeded=True)
    with mpmath.workprec(24 * K + 80):
        for i in range(0, 35, 3):
            x = scaled_limbs_to_mpf(c[0][:, i // 7, i % 7], c[1][i // 7, i % 7])
            got = scaled_limbs_to_mpf(r.limbs[:, i // 7, i % 7].numpy(),
                                      r.exp[i // 7, i % 7])
            assert abs(got * mpmath.sqrt(x) - 1) < _newton_bound(K)


@pytest.mark.parametrize("K", [2, 3, 9])
def test_scaled_rsqrt_seed_is_the_only_difference(K, monkeypatch):
    """With jax.lax.rsqrt as the seed, rsqrt and sqrt are bit-identical to
    the JAX package's where it runs the unrolled renorm (K32 <= 3), and
    the kernel-order rsqrt to ops/mplist.py's at K32 <= 6.  From K32 = 7
    the renorm's last error terms reach float32's subnormal range, which
    XLA:CPU flushes to zero and the port keeps (IEEE, as the CUDA kernels
    built with -ftz=false): there the chain agrees within the Newton bound,
    and bit for bit once the port flushes subnormals too."""
    rng = np.random.default_rng(7 + K)
    c = rand_scaled(rng, (64,), K, positive=True)
    monkeypatch.setattr(tmp, "inv_sqrt", lambda m: torch.from_numpy(
        np.array(jax.lax.rsqrt(jnp.asarray(m.numpy())))))
    if K <= 3:
        assert same_scaled(jmp.rsqrt(J(c)), tmp.rsqrt(T(c)))
        assert same_scaled(jmp.sqrt(J(c)), tmp.sqrt(T(c)))
    lv = ([jnp.asarray(c[0][k]) for k in range(K)], jnp.asarray(c[1]))
    r = ml.rsqrt(lv, K)
    ref = jmp.MP(jnp.stack(r[0]), r[1])
    _check("rsqrt", K, ref, tmp.rsqrt(T(c), kernel_order=True), seeded=True)
    if K <= 6:
        assert same_scaled(ref, tmp.rsqrt(T(c), kernel_order=True))
    assert torch.set_flush_denormal(True)
    try:
        assert same_scaled(ref, tmp.rsqrt(T(c), kernel_order=True))
    finally:
        torch.set_flush_denormal(False)


def test_scaled_conversions_and_range():
    """Host and device conversions against the JAX package, exactly;
    values far beyond float64's range stay finite; zeros carry EXP_ZERO."""
    x = np.array([1.5, -2.25, 1e150, 3.333333333333333, 0.0, 1e-200])
    for K in (2, 5, 9):
        l, e = tmp.f64_to_scaled_parts(x, K)
        jl, je = jmp.f64_to_scaled_parts(x, K)
        assert np.array_equal(l, jl) and np.array_equal(e, je)
        assert same_scaled(tmp.from_double(x, K, "cpu", scaled=True),
                           jmp.from_double(x, K, jnp.float32, scaled=True))
        # a float64 mantissa fills three float32 limbs: K = 2 keeps 48 bits
        back = tmp.to_double(tmp.from_double(x, K, "cpu", scaled=True)).numpy()
        assert np.array_equal(back, x) if K > 2 else \
            np.all(np.abs(back - x) <= 2.0 ** -47 * np.abs(x))
        # float32 tensors: the traced path of the JAX package
        f = np.array([1.5, -2.25, 3.3333333, 0.0, 1e-30, 6e37], np.float32)
        assert same_scaled(tmp.from_double(torch.tensor(f), K, scaled=True),
                           jmp.from_double(jnp.asarray(f), K, jnp.float32, scaled=True))
        # float64 tensors: exact (three float32 limbs)
        back = tmp.to_double(tmp.from_double(torch.tensor(x), K, scaled=True)).numpy()
        assert np.array_equal(back, x) or K == 2
        rng = np.random.default_rng(K)
        l64 = rng.standard_normal((4, 3, 5)) * 2.0 ** -np.arange(4)[:, None, None] * 1e-17
        assert all(np.array_equal(p, q) for p, q in zip(
            tmp.f64_limbs_to_scaled_parts(l64, K), jmp.f64_limbs_to_scaled_parts(l64, K)))
        s = rand_scaled(rng, (3, 4), K)
        assert np.array_equal(tmp.scaled_parts_to_f64_limbs(*s, 4),
                              jmp.scaled_parts_to_f64_limbs(*s, 4))
        assert same_scaled(tmp.to_scaled(tmp.MP(torch.tensor(l64[:3])), K),
                           tmp.from_parts(*jmp.f64_limbs_to_scaled_parts(l64[:3], K), "cpu"))
    z = tmp.sqrt(tmp.zeros((4,), 5, "cpu", scaled=True))
    assert np.all(z.limbs.numpy() == 0) and np.all(z.exp.numpy() == tmp.EXP_ZERO)
    limbs, exp = rand_scaled(np.random.default_rng(1), (8,), 5, decades=0)
    big = (limbs, exp + 2000)                           # ~ 10^602
    back = tmp.div(tmp.mul(T(big), T(big)), T(big))
    _check("beyond float64", 5, jmp.div(jmp.mul(J(big), J(big)), J(big)), back)
    rel = tmp.to_float_array(tmp.div(tmp.sub(back, T(big)), T(big))).numpy()
    assert np.all(np.abs(rel) < 2.0 ** -(24 * 5 - 16))
    # beyond 9 limbs a scaled value is wide (two words of ceil(K/2) limbs);
    # one word still holds at most 9
    wide = tmp.zeros((2,), 10, "cpu", scaled=True)
    assert type(wide).__name__ == "MPW" and (wide.G, wide.Kg) == (2, 5)
    with pytest.raises(ValueError, match="MPW"):
        tmp._check_scaled_k(10)
    with pytest.raises(TypeError):
        tmp.add(T(big), tmp.zeros((8,), 5, "cpu"))


def test_nearest_double_rounds_once():
    """nearest_double is the float64 nearest to the exact value; summing
    the limbs top-down (to_double) rounds a value just above a midpoint
    down to even."""
    rng = np.random.default_rng(11)
    for K in (3, 5, 9):
        limbs, exp = rand_scaled(rng, (200,), K, decades=30)
        got = tmp.nearest_double(T((limbs, exp))).numpy()
        with mpmath.workprec(30 * K + 64):
            want = [float(scaled_limbs_to_mpf(limbs[:, i], exp[i])) for i in range(200)]
        assert np.array_equal(got, np.array(want))
    # 1 + 2^-53 + 2^-80: the midpoint between 1 and 1 + 2^-52, and above it
    l64 = np.array([[1.0], [2.0 ** -53], [2.0 ** -80]])
    x = tmp.from_parts(*tmp.f64_limbs_to_scaled_parts(l64, 5), "cpu")
    assert float(tmp.nearest_double(x)[0]) == 1.0 + 2.0 ** -52
    assert float(tmp.to_double(x)[0]) == 1.0
    c = T(np.array([[1.0], [2.0 ** -60]]))
    assert torch.equal(tmp.nearest_double(c), c.limbs[0])
