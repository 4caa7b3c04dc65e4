"""The port's wide (two-word) representation, sdpb_tpu_torch/ops/mpwide.py,
against the JAX package's sdpb_tpu/ops/mpwide.py and against mpmath, on the
CPU.

Both packages' wide_config is widened to two words of Kg = 3 limbs (PREC =
144 bits) for the parity tests, as tests/test_mpwide_kernel.py does: the
JAX wide ops compile for minutes at Kg = 9 on the CPU.  Inputs come from a
seed (numpy) as exact mpmath values, staged by each package's own
f64_limbs_to_wide_parts.

The JAX ops run op by op (not under jax.jit): jitted for the CPU, XLA's
fusion changed the JAX package's wide product by 2^-25 relative on one of
nine elements of these inputs (content gaps in word 0), where the eager
JAX result, the port's and mpmath's agree exactly.

Tolerances:
  * staging, host_f64_limbs, add, sub, mul, div, rsqrt, sqrt and the
    structural ops: bit-identical words (limbs and exponents) with the JAX
    package.  (The base rsqrt seeds differ, see the port's mpfloat
    docstring; on these inputs the Newton steps give the same bits.)
  * against mpmath: add, sub, mul within 2^-(PREC-22), div, rsqrt, sqrt
    within 2^-(PREC-34), the JAX tests' bounds (tests/test_mpwide.py), at
    Kg = 3 and, for the port alone, at the real word sizes Kg = 5 (K = 10)
    and Kg = 9 (K = 18, the --precision 400 contract);
  * nearest_double: exactly the float64 nearest to the mpmath value.
"""
import mpmath
import numpy as np
import pytest
import torch

from sdpb_tpu.ops import mpfloat as jmp, mpwide as jmw
from sdpb_tpu_torch.ops import mpfloat as tmp, mpwide as tmw

from torch_parity import (JW, max_rel_bits, mpf_to_f64_limbs, rand_wide_vals,
                          same_wide, small_wide_config, wide_parts_of, wide_to_mpf)

torch.set_num_threads(1)

K = 6
PREC = 24 * K


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(jmw, "wide_config", small_wide_config)
    monkeypatch.setattr(tmw, "wide_config", small_wide_config)


def _staged(vals, shape, K=K, prec=PREC):
    """(port MPW, JAX-staged word parts) of exact values."""
    l64 = mpf_to_f64_limbs(vals, shape, prec)
    return tmw.wide_parts_to_mp(tmw.f64_limbs_to_wide_parts(l64, K), "cpu"), l64


def _pair(seed, n=9, decades=6, positive=False):
    rng = np.random.default_rng(seed)
    va = rand_wide_vals(rng, n, PREC, decades)
    vb = rand_wide_vals(rng, n, PREC, decades)
    if positive:
        vb = [abs(v) for v in vb]
    return va, vb


def test_staging_and_host_limbs_equal_jax(small):
    va, _ = _pair(1, n=12, decades=30)
    l64 = mpf_to_f64_limbs(va, (3, 4), PREC)
    mine = tmw.f64_limbs_to_wide_parts(l64, K)
    ref = jmw.f64_limbs_to_wide_parts(l64, K)
    for (ml, me), (rl, re) in zip(mine, ref):
        assert ml.dtype == rl.dtype and np.array_equal(ml, rl) and np.array_equal(me, re)
    port, jaxv = tmw.wide_parts_to_mp(mine, "cpu"), jmw.wide_parts_to_mp(ref)
    assert np.array_equal(tmp.host_f64_limbs(port), jmp.host_f64_limbs(jaxv))
    assert max_rel_bits(wide_to_mpf(port, PREC), va, PREC) < -(PREC - 8)


_OPS = {
    "add": (tmp.add, jmp.add, lambda x, y: x + y, -(PREC - 22)),
    "sub": (tmp.sub, jmp.sub, lambda x, y: x - y, -(PREC - 22)),
    "mul": (tmp.mul, jmp.mul, lambda x, y: x * y, -(PREC - 22)),
    "div": (tmp.div, jmp.div, lambda x, y: x / y, -(PREC - 34)),
    "rsqrt": (lambda x, y: tmp.rsqrt(y), lambda x, y: jmp.rsqrt(y),
              lambda x, y: 1 / mpmath.sqrt(y), -(PREC - 34)),
    "sqrt": (lambda x, y: tmp.sqrt(y), lambda x, y: jmp.sqrt(y),
             lambda x, y: mpmath.sqrt(y), -(PREC - 34)),
}


@pytest.mark.parametrize("name", list(_OPS))
def test_op_matches_jax_and_mpmath(small, name):
    port_op, jax_op, exact, mpmath_bits = _OPS[name]
    va, vb = _pair(10 + list(_OPS).index(name),
                   positive=name in ("rsqrt", "sqrt", "div"))
    if name == "sqrt":
        vb[0] = mpmath.mpf(0)
    a, _ = _staged(va, (len(va),))
    b, _ = _staged(vb, (len(vb),))
    mine = port_op(a, b)
    ref = jax_op(JW(wide_parts_of(a)), JW(wide_parts_of(b)))
    assert same_wide(mine, ref), name
    with mpmath.workprec(PREC + 120):
        want = [exact(x, y) for x, y in zip(wide_to_mpf(a, PREC), wide_to_mpf(b, PREC))]
    assert max_rel_bits(wide_to_mpf(mine, PREC), want, PREC) < mpmath_bits, name


def test_deep_cancellation_and_spill(small):
    """A sum whose leading 100 bits cancel (no single float32 ladder holds
    it) and the product of operands with content gaps wider than a word
    (tests/test_mpwide_kernel.py:162-178) against mpmath."""
    with mpmath.workprec(PREC + 200):
        va = [mpmath.mpf(3) / 7, mpmath.mpf(10) ** 25]
        vb = [-(v - mpmath.mpf(2) ** -100 * v * (1 + mpmath.mpf(1) / 3)) for v in va]
        ga = [mpmath.mpf(3) / 7 + mpmath.mpf(5) / 11 * mpmath.mpf(2) ** -100]
        gb = [mpmath.mpf(1) / 3 + mpmath.mpf(2) ** -90 / 7]
    a, _ = _staged(va, (2,))
    b, _ = _staged(vb, (2,))
    with mpmath.workprec(PREC + 200):
        want = [x + y for x, y in zip(wide_to_mpf(a, PREC), wide_to_mpf(b, PREC))]
    assert max_rel_bits(wide_to_mpf(tmp.add(a, b), PREC), want, PREC) < -(PREC - 100 - 30)
    a, _ = _staged(ga, (1,))
    b, _ = _staged(gb, (1,))
    with mpmath.workprec(PREC + 200):
        want = [wide_to_mpf(a, PREC)[0] * wide_to_mpf(b, PREC)[0]]
    assert max_rel_bits(wide_to_mpf(tmp.mul(a, b), PREC), want, PREC) < -(PREC - 22)


def test_structural_ops_match_jax(small):
    """where, mask_value, take, stack, concatenate, broadcast_to, diagonal,
    set_block, scalar_eye, expand_dims, pad_dim, sum_, sign_array, abs_,
    max_abs, to_double, to_float_array, round_to: the same words as the
    JAX package's (set_block in place in the port)."""
    va, _ = _pair(40, n=12, decades=10)
    va[5] = mpmath.mpf(0)
    a, _ = _staged(va, (3, 4))
    ja = JW(wide_parts_of(a))
    m = np.array([[1, 0, 1, 1], [0, 1, 0, 1], [1, 1, 1, 0]], np.float32)
    cond = m > 0
    pairs = [
        (tmp.mask_value(a, torch.as_tensor(m)), jmp.mask_value(ja, m)),
        (tmp.where(torch.as_tensor(cond), a, tmp.neg(a)), jmp.where(cond, ja, jmp.neg(ja))),
        (tmp.take(a, [2, 0], 1), jmp.take(ja, np.array([2, 0]), 1)),
        (tmp.stack([a, a], 0), jmp.stack([ja, ja], 0)),
        (tmp.concatenate([a, a], 1), jmp.concatenate([ja, ja], 1)),
        (tmp.broadcast_to(a, (2, 3, 4)), jmp.broadcast_to(ja, (2, 3, 4))),
        (tmp.diagonal(a[:, :3]), jmp.diagonal(ja[:, :3])),
        (tmp.scalar_eye(a[0], 3), jmp.scalar_eye(ja[0], 3)),
        (tmp.expand_dims(a, -1), jmp.expand_dims(ja, -1)),
        (tmp.pad_dim(a, 1, 2), jmp.pad_dim(ja, 1, 2)),
        (tmp.sum_(a, axis=1), jmp.sum_(ja, axis=1)),
        (tmp.abs_(a), jmp.abs_(ja)),
        (tmp.mul_pow2(a, 0.25), jmp.mul_pow2(ja, 0.25)),
        (tmp.round_to(a, 2), jmp.round_to(ja, 2)),
        (tmp.round_to(tmp.round_to(a, 2), K), jmp.round_to(jmp.round_to(ja, 2), K)),
    ]
    for i, (mine, ref) in enumerate(pairs):
        if hasattr(ref, "words"):
            assert same_wide(mine, ref), i
        else:
            assert np.array_equal(mine.limbs.numpy(), np.asarray(ref.limbs)) and \
                np.array_equal(mine.exp.numpy(), np.asarray(ref.exp)), i
    blk = tmw.zeros((3, 4), K, "cpu")
    assert blk.G == 2 and blk.Kg == 3 and blk.K == K
    tmp.set_block(blk, (slice(1, 3), slice(0, 2)), a[1:3, 0:2])
    ref = jmp.set_block(jmw.zeros((3, 4), K), (slice(1, 3), slice(0, 2)), ja[1:3, 0:2])
    assert same_wide(blk, ref)
    assert np.array_equal(tmp.sign_array(a).numpy(), np.asarray(jmp.sign_array(ja)))
    assert np.array_equal(tmp.to_float_array(a).numpy(), np.asarray(jmp.to_float_array(ja)))
    assert float(tmp.max_abs(a)) == float(jmp.max_abs(ja))
    assert np.array_equal(tmp.to_double(a).numpy(), np.asarray(jmp.to_double(ja)))


@pytest.mark.parametrize("Kw", [10, 18])
def test_port_against_mpmath_at_real_word_sizes(Kw):
    """K = 10 (Kg = 5) and K = 18 (Kg = 9): add, mul, div, sqrt against
    mpmath, with the JAX tests' bounds; nearest_double exactly rounded."""
    prec = 24 * Kw
    assert tmw.wide_config(Kw) == (2, Kw // 2)
    rng = np.random.default_rng(Kw)
    va = rand_wide_vals(rng, 5, prec, 30)
    vb = [abs(v) for v in rand_wide_vals(rng, 5, prec, 30)]
    a, _ = _staged(va, (5,), Kw, prec)
    b, _ = _staged(vb, (5,), Kw, prec)
    ha, hb = wide_to_mpf(a, prec), wide_to_mpf(b, prec)
    assert max_rel_bits(ha, va, prec) < -(prec - 8)
    checks = ((tmp.add(a, b), lambda x, y: x + y, 22), (tmp.mul(a, b), lambda x, y: x * y, 22),
              (tmp.div(a, b), lambda x, y: x / y, 34),
              (tmp.sqrt(b), lambda x, y: mpmath.sqrt(y), 34))
    for got, f, slack in checks:
        with mpmath.workprec(prec + 120):
            want = [f(x, y) for x, y in zip(ha, hb)]
        assert max_rel_bits(wide_to_mpf(got, prec), want, prec) < -(prec - slack)
    nd = tmp.nearest_double(a).numpy()
    with mpmath.workprec(prec + 120):
        for x, v in zip(nd, ha):
            lo, hi = np.nextafter(x, -np.inf), np.nextafter(x, np.inf)
            assert abs(mpmath.mpf(float(x)) - v) <= abs(mpmath.mpf(float(lo)) - v)
            assert abs(mpmath.mpf(float(x)) - v) <= abs(mpmath.mpf(float(hi)) - v)


def test_dispatch_and_configuration():
    """Scaled K > 9 is wide in zeros, from_double and round_to; a word
    keeps refusing K > 9; wide_config refuses K <= 9."""
    assert tmw.wide_config(17) == (2, 9) and tmw.wide_config(19) == (3, 7)
    with pytest.raises(ValueError):
        tmw.wide_config(9)
    z = tmp.zeros((2,), 18, "cpu", scaled=True)
    assert isinstance(z, tmw.MPW) and (z.G, z.Kg, z.K) == (2, 9, 18)
    one = tmp.from_double(np.ones(2), 10, "cpu", scaled=True)
    assert isinstance(one, tmw.MPW) and one.Kg == 5
    w = tmp.round_to(tmp.from_double(np.ones(2), 7, "cpu", scaled=True), 18)
    assert isinstance(w, tmw.MPW) and w.Kg == 9
    assert tmp.round_to(w, 7).K == 7 and not isinstance(tmp.round_to(w, 7), tmw.MPW)
    with pytest.raises(ValueError):
        tmp._check_scaled_k(10)
