"""The port's error-free transforms and classic MP arithmetic
(sdpb_tpu_torch.ops.eft / mpfloat) against the JAX package on the CPU.

Tolerances:
  * EFTs: bit-identical.
  * MP ops at K = 2..5: bit-identical limbs (the JAX package runs its
    unrolled renorm there, the same IEEE op sequence as the port).
  * MP ops at K = 6..9: bit-identical or within 2^-(53K-10) relative (JAX
    on the CPU switches to scan renorms whose residue limb is a jnp.sum).
  * rsqrt and sqrt: bit-identical or within 2^-(53K-10) relative.  The
    port seeds Newton with the correctly rounded 1/sqrt(m); JAX seeds with
    jax.lax.rsqrt, which XLA:CPU rounds differently for part of the
    inputs, so on some elements only the bound holds (asserted below).
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdpb_tpu.ops import eft as jeft, mplist as ml, mpfloat as jmp
from sdpb_tpu_torch.ops import eft as teft, mpfloat as tmp

from torch_parity import J, T, elementwise_rel_err, limbs_of, rand_limbs

torch.set_num_threads(1)


def _bound(K):
    return 2.0 ** -(53 * K - 10)


def test_eft_bit_identical_and_exact():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(512) * np.exp(rng.uniform(-30, 30, 512))
    b = rng.standard_normal(512) * np.exp(rng.uniform(-30, 30, 512))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for jf, tf in ((jeft.two_sum, teft.two_sum),
                   (jeft.quick_two_sum, teft.quick_two_sum),
                   (jeft.two_prod, teft.two_prod)):
        jo = [np.asarray(x) for x in jf(ja, jb)]
        to = [x.numpy() for x in tf(ta, tb)]
        for x, y in zip(jo, to):
            assert np.array_equal(x, y)
    jh, jl = jeft.split(ja)
    th, tl = teft.split(ta)
    assert np.array_equal(np.asarray(jh), th.numpy())
    assert np.array_equal(np.asarray(jl), tl.numpy())
    s, e = teft.two_sum(ta, tb)
    p, pe = teft.two_prod(ta, tb)
    for i in range(64):
        assert Fraction(float(s[i])) + Fraction(float(e[i])) == \
            Fraction(a[i]) + Fraction(b[i])
        assert Fraction(float(p[i])) + Fraction(float(pe[i])) == \
            Fraction(a[i]) * Fraction(b[i])


def _check(name, K, jres, tres, seeded=False):
    """Bit-identical where the op sequence is identical, else the bound."""
    x, y = limbs_of(jres), limbs_of(tres)
    assert x.shape == y.shape, (name, x.shape, y.shape)
    if np.array_equal(x, y):
        return "bitwise"
    assert K >= 6 or seeded, f"{name} at K={K} is not bit-identical"
    err = elementwise_rel_err(tres, jres)
    assert err < _bound(K), (name, K, err)
    return "bound"


@pytest.mark.parametrize("K", [2, 3, 4, 5])
def test_mp_ops_match_jax(K):
    rng = np.random.default_rng(100 + K)
    a = rand_limbs(rng, (6, 9), K)
    b = rand_limbs(rng, (6, 9), K, spread=3.0)
    c = rand_limbs(rng, (6, 9), K, positive=True, spread=3.0)
    v = rand_limbs(rng, (9,), K)
    ja, jb, jc, jv = J(a), J(b), J(c), J(v)
    ta, tb, tc, tv = T(a), T(b), T(c), T(v)
    pairs = [
        ("add", jmp.add(ja, jb), tmp.add(ta, tb)),
        ("sub", jmp.sub(ja, jb), tmp.sub(ta, tb)),
        ("mul", jmp.mul(ja, jb), tmp.mul(ta, tb)),
        ("mul_bcast", jmp.mul(ja, jv), tmp.mul(ta, tv)),
        ("mul_pow2", jmp.mul_pow2(ja, np.float64(0.25)), tmp.mul_pow2(ta, 0.25)),
        ("div", jmp.div(ja, jc), tmp.div(ta, tc)),
        ("reciprocal", jmp.reciprocal(jb), tmp.reciprocal(tb)),
        ("sum_axis", jmp.sum_(ja, axis=1), tmp.sum_(ta, axis=1)),
        ("sum_all", jmp.sum_(ja), tmp.sum_(ta)),
        ("dot", jmp.dot(jv, jv), tmp.dot(tv, tv)),
        ("abs", jmp.abs_(jb), tmp.abs_(tb)),
        ("maximum", jmp.maximum(ja, jb), tmp.maximum(ta, tb)),
        ("minimum", jmp.minimum(ja, jb), tmp.minimum(ta, tb)),
        ("where", jmp.where(jnp.asarray(a[0] > 0), ja, jb),
         tmp.where(torch.as_tensor(a[0] > 0), ta, tb)),
        ("round_down", jmp.round_to(ja, 2), tmp.round_to(ta, 2)),
        ("round_up", jmp.round_to(ja, K + 1), tmp.round_to(ta, K + 1)),
        ("to_float", jmp.to_float_array(jb), tmp.to_float_array(tb)),
        ("to_double", jmp.to_double(jb), tmp.to_double(tb)),
        ("max_abs", jmp.max_abs(jb), tmp.max_abs(tb)),
        ("lt", jmp.lt(ja, jb).astype(jnp.float64), tmp.lt(ta, tb).double()),
    ]
    for name, jres, tres in pairs:
        _check(name, K, jres, tres)
    # rsqrt / sqrt: the Newton seed may differ (see module docstring)
    for name, jres, tres in (("rsqrt", jmp.rsqrt(jc), tmp.rsqrt(tc)),
                             ("sqrt", jmp.sqrt(jc), tmp.sqrt(tc))):
        _check(name, K, jres, tres, seeded=True)
    assert np.array_equal(jmp.host_f64_limbs(ja), tmp.host_f64_limbs(ta))


@pytest.mark.parametrize("K", [6, 7, 8, 9])
def test_core_ops_match_jax_high_k(K):
    """From K = 6 the JAX package renormalizes with scan sweeps; add, mul
    and the Newton reciprocal (every other op is built from them) must be
    bit-identical or within the bound."""
    rng = np.random.default_rng(300 + K)
    a = rand_limbs(rng, (4, 5), K)
    b = rand_limbs(rng, (4, 5), K, spread=3.0)
    _check("add", K, jmp.add(J(a), J(b)), tmp.add(T(a), T(b)))
    _check("mul", K, jmp.mul(J(a), J(b)), tmp.mul(T(a), T(b)))
    _check("reciprocal", K, jmp.reciprocal(J(b)), tmp.reciprocal(T(b)))


@pytest.mark.parametrize("K", [2, 3, 5, 9])
def test_kernel_order_ops_match_mplist(K):
    """kmul and the kernel-order Newton chains follow ops/mplist.py (the
    arithmetic inside the Pallas kernels), bit for bit; rsqrt up to its
    seed."""
    rng = np.random.default_rng(200 + K)
    a = rand_limbs(rng, (5, 7), K)
    b = rand_limbs(rng, (5, 7), K, spread=3.0)
    c = rand_limbs(rng, (5, 7), K, positive=True, spread=3.0)
    lv = lambda x: ([jnp.asarray(x[k]) for k in range(K)], None)
    stack = lambda v: np.stack([np.asarray(t) for t in v[0]])
    assert np.array_equal(stack(ml.mul(lv(a), lv(b), K)),
                          limbs_of(tmp.kmul(T(a), T(b))))
    assert np.array_equal(stack(ml.add(lv(a), lv(b), K)),
                          limbs_of(tmp.add(T(a), T(b))))
    assert np.array_equal(stack(ml.reciprocal(lv(b), K)),
                          limbs_of(tmp.reciprocal(T(b), kernel_order=True)))
    _check("rsqrt", K, stack(ml.rsqrt(lv(c), K)),
           tmp.rsqrt(T(c), kernel_order=True), seeded=True)


def test_rsqrt_seed_is_the_only_difference():
    """With the JAX seed substituted, rsqrt is bit-identical: the Newton
    chain itself is the same op sequence."""
    K = 3
    rng = np.random.default_rng(7)
    c = rand_limbs(rng, (200,), K, positive=True)
    jres = limbs_of(jmp.rsqrt(J(c)))
    jseed = np.asarray(jax.lax.rsqrt(jnp.asarray(c[0] + c[1])))
    r = tmp.MP(torch.as_tensor(np.concatenate([jseed[None], np.zeros((K - 1, 200))])))
    half, th = tmp.from_double(0.5, K, "cpu"), tmp.from_double(1.5, K, "cpu")
    for _ in range(tmp.newton_steps(K)):
        r = tmp.mul(r, tmp.sub(th, tmp.mul(half, tmp.mul(T(c), tmp.mul(r, r)))))
    assert np.array_equal(limbs_of(r), jres)
    assert elementwise_rel_err(tmp.rsqrt(T(c)), jres) < _bound(K)


def test_from_double_and_host_limbs():
    x = np.array([[1.5, -2.25e-300], [3e200, 0.0]])
    for K in (2, 5):
        assert np.array_equal(limbs_of(tmp.from_double(x, K, "cpu")),
                              limbs_of(jmp.from_double(x, K, jnp.float64)))
        t = tmp.from_double(torch.as_tensor(x), K)
        assert np.array_equal(limbs_of(t), limbs_of(jmp.from_double(jnp.asarray(x), K,
                                                                    jnp.float64)))
    with pytest.raises(ValueError):
        tmp.from_double(1.0, 3)


def _sequential_sweeps(xs, K, chain):
    """The extraction sweeps one after the other, as the kernels run them:
    sweep k carries xs[m-1] up to row k; with `chain` the residue rows K..
    are then summed bottom-up into row K."""
    xs = list(xs)
    m = len(xs)
    for k in range(min(K, m - 1)):
        for i in range(m - 2, k - 1, -1):
            xs[i], xs[i + 1] = teft.two_sum(xs[i], xs[i + 1])
    if chain and m - 1 > K:
        s = xs[m - 1]
        for i in range(m - 2, K - 1, -1):
            s = s + xs[i]
        xs[K] = s
    return xs


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K,m,chain", [(2, 4, True), (3, 8, True), (5, 12, True),
                                       (9, 30, True), (3, 8, False), (9, 20, False),
                                       (4, 3, False), (12, 145, True), (13, 170, True)])
def test_sweeps_wavefront_equals_sequential(K, m, chain, dtype):
    """mpfloat.sweeps (every renorm's extraction, run as a wavefront) gives
    the bits of the sweeps run one after the other, on rows of mixed signs
    spread over a wide exponent range, with exact cancellations."""
    rng = np.random.default_rng(K * 100 + m)
    rows = rng.standard_normal((m, 257)) * np.exp2(rng.integers(-60, 60, (m, 257)))
    rows[m // 2, :32] = -rows[0, :32]
    xs = [torch.as_tensor(r).to(dtype) for r in rows]
    got = tmp.sweeps(xs, K, chain)
    want = _sequential_sweeps(xs, K, chain)
    assert len(got) == len(want) == m
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int64 if dtype == torch.float64 else torch.int32),
                           w.view(torch.int64 if dtype == torch.float64 else torch.int32))
