"""Three-word wide values (G = 3 scaled words, --precision 425-640): the
port's staging and sum and product (sdpb_tpu_torch/ops/mpwide.py, whose
G = 3 sum and product are the plain versions of the three-word kernels,
ops/mpwide_kernel.py's wadd_g_c and wmul_g_c) against the JAX package's
generic-G branches (sdpb_tpu/ops/mpwide.py:229-306) and against mpmath, on
the CPU.  tests/test_torch_mpwide3_newton.py does the same for division,
rsqrt and sqrt.

No test ran the JAX package's generic-G arithmetic before: its own tests
and the port's build two words only.  Both packages' wide_config is widened
here to three words of Kg = 3 limbs (PREC = 216 bits) for the parity
tests, as tests/test_torch_mpwide.py does for two words; the port alone is
also held to mpmath at the real word sizes Kg = 7 and 9 (21 and 27 limbs,
--precision 440 and 640).  The JAX ops run op by op (not under jax.jit:
XLA:CPU's fusion changes a wide product, ROADMAP C).  Each eager JAX
three-word product maps ~1,500 more memory regions in the process (its
executables are not reused), and at the kernel's 65,530 LLVM stops with
"Cannot allocate memory": the JAX calls are spread over two files (one
xdist worker process each) and kept few.

The JAX branch misses mpmath in two ways at G = 3, which the port's
three-word arithmetic repairs (ROADMAP C; neither shows at G = 2):
  * its exact word product mul_full returns two words, but two dense words
    (a word's limbs span up to ~24 Kg + 12 digits, much more where its
    content has gaps) can have a product of more: its low end is lost,
    ~2^-(48 Kg + 8) of the product (the port takes the top word product in
    three words, mpwide_kernel.mul_full3_c);
  * its word TwoSum add_full loses the low limbs of a word lying more than
    ~24 Kg + 150 digits below the other (the port leaves words more than
    24 Kg apart as they are), and after a cancellation its sweeps can leave
    word 0 holding few digits with word 1 overlapping it (the port ends
    with one top-down pass).
Tolerances:
  * staging (f64_limbs_to_wide_parts), host_f64_limbs and the structural
    ops (no arithmetic): bit-identical with the JAX package;
  * sum, difference and product against mpmath: within 2^-(PREC-22) of
    the operands' magnitudes (sum) or of the exact product, the JAX tests'
    bound (tests/test_mpwide.py); against the JAX package within the same
    bound wherever the JAX result itself meets it ("the port is right, and
    agrees with JAX unless JAX is not", as tests/test_torch_slice.py holds
    the iteration), and the inputs include cases where it does not;
  * a sum after a deep cancellation: word 0 carries the value to within
    2^-(24 Kg - 4) (its words do not overlap), where the JAX branch's does
    not;
  * nearest_double: exactly the float64 nearest to the mpmath value.
Inputs are dense (float64 limb stacks with fresh bits in every limb, as
chip_smoke.py makes its operands) unless a test says otherwise;
test_sparse_words_product_is_exact_too takes words whose content has gaps
inside them.
"""
import mpmath
import numpy as np
import pytest
import torch

from sdpb_tpu.ops import mpfloat as jmp, mpwide as jmw
from sdpb_tpu_torch.ops import kernels as tk, mpfloat as tmp, mpwide as tmw

from torch_parity import (JW, max_rel_bits, mpf_to_f64_limbs, rand_limbs, rand_wide_vals,
                          same_wide, wide_parts_of, wide_to_mpf)

torch.set_num_threads(1)

K = 9
PREC = 24 * K


def three_wide_config(K):
    """Three words of ceil(K/3) limbs for any K (both packages' wide_config
    otherwise give three words from K = 19 only)."""
    return 3, -(-K // 3)


@pytest.fixture
def three(monkeypatch):
    monkeypatch.setattr(jmw, "wide_config", three_wide_config)
    monkeypatch.setattr(tmw, "wide_config", three_wide_config)


def dense(rng, shape, Kw=K, spread=20, positive=False):
    """A three-word port MPW of dense random values over +-spread binary
    orders: a float64 limb stack with fresh bits in every limb, staged."""
    l64 = rand_limbs(rng, shape, -(-(24 * Kw) // 53) + 3, positive=positive)
    l64 *= 2.0 ** rng.integers(-spread, spread + 1, shape)
    return tmw.wide_parts_to_mp(tmw.f64_limbs_to_wide_parts(l64, Kw), "cpu")


def staged(vals, shape, Kw=K):
    prec = 24 * Kw
    return tmw.wide_parts_to_mp(
        tmw.f64_limbs_to_wide_parts(mpf_to_f64_limbs(vals, shape, prec), Kw), "cpu")


def _bits(got, want, scale, prec):
    """max log2(|got - want| / scale) over elements (-inf where equal)."""
    worst = -np.inf
    with mpmath.workprec(prec + 200):
        for g, w, s in zip(got, want, scale):
            if g != w:
                worst = max(worst, float(mpmath.log(abs(g - w) / s, 2)))
    return worst


def _held(mine, ref, exact, scale, prec, bound):
    """The port meets the bound against mpmath, and agrees with JAX within
    it wherever JAX meets it.  Returns the elements where JAX misses."""
    m = wide_to_mpf(mine, prec)
    r = wide_to_mpf(ref, prec)
    assert _bits(m, exact, scale, prec) < bound
    misses = 0
    for g, j, w, s in zip(m, r, exact, scale):
        with mpmath.workprec(prec + 200):
            jax_ok = j == w or float(mpmath.log(abs(j - w) / s, 2)) < bound
            if jax_ok:
                assert g == j or float(mpmath.log(abs(g - j) / s, 2)) < bound
            misses += not jax_ok
    return misses


@pytest.mark.parametrize("Kw", [9, 21, 27])
def test_staging_and_host_limbs_equal_jax(Kw, monkeypatch):
    """f64_limbs_to_wide_parts and host_f64_limbs at three words, word for
    word with the JAX package's (numpy on both sides), values within
    2^-(PREC-8) of mpmath; the real configurations 3 x 7 and 3 x 9."""
    if Kw == 9:
        monkeypatch.setattr(jmw, "wide_config", three_wide_config)
        monkeypatch.setattr(tmw, "wide_config", three_wide_config)
    prec = 24 * Kw
    assert tmw.wide_config(Kw) == jmw.wide_config(Kw) == (3, Kw // 3)
    vals = rand_wide_vals(np.random.default_rng(Kw), 12, prec, 30)
    l64 = mpf_to_f64_limbs(vals, (3, 4), prec)
    mine, ref = tmw.f64_limbs_to_wide_parts(l64, Kw), jmw.f64_limbs_to_wide_parts(l64, Kw)
    assert len(mine) == 3
    for (ml, me), (rl, re) in zip(mine, ref):
        assert ml.dtype == rl.dtype and np.array_equal(ml, rl) and np.array_equal(me, re)
    port = tmw.wide_parts_to_mp(mine, "cpu")
    assert port.G == 3 and port.K == Kw
    assert np.array_equal(tmp.host_f64_limbs(port), jmp.host_f64_limbs(jmw.wide_parts_to_mp(ref)))
    assert max_rel_bits(wide_to_mpf(port, prec), vals, prec) < -(prec - 8)
    # a three-word value stores ceil(24 K / 53) + 1 float64 limbs (14 at K = 27)
    assert tmp.host_f64_limbs(port).shape[0] == -(-(24 * Kw) // 53) + 1


def test_configuration_and_newton_steps():
    """19-27 scaled limbs are three words of 7-9; a value of three words
    takes two Newton steps from its word-0 seed, as in the JAX package."""
    assert [tmw.wide_config(k) for k in (19, 21, 24, 27)] == [(3, 7), (3, 7), (3, 8), (3, 9)]
    assert tmw._newton_steps(3) == jmw._newton_steps(3) == 2
    z = tmp.zeros((2,), 27, "cpu", scaled=True)
    assert isinstance(z, tmw.MPW) and (z.G, z.Kg, z.K) == (3, 9, 27)
    one = tmp.from_double(np.ones(2), 21, "cpu", scaled=True)
    assert (one.G, one.Kg) == (3, 7) and float(tmp.to_double(one)[0]) == 1.0


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_sum_and_product_against_jax_and_mpmath(three, name):
    """Dense operands over 40 binary orders, a few of the sum's with a
    deep cancellation: the port within 2^-(PREC-22) of mpmath, and of the
    JAX package's result wherever that meets the bound too."""
    rng = np.random.default_rng({"add": 1, "sub": 2, "mul": 3}[name])
    a, b = dense(rng, (12,)), dense(rng, (12,))
    if name != "mul":       # b = -a (1 + 2^-40 r) on three elements
        sign = -1.0 if name == "add" else 1.0
        for w_a, w_b in zip(a.words, b.words):
            w_b.limbs[:, :3] = sign * w_a.limbs[:, :3]
            w_b.exp[:3] = w_a.exp[:3]
        b.words[1].limbs[1, :3] *= np.float32(1 + 2.0 ** -20)
    port_op, jax_op = {"add": (tmp.add, jmp.add), "sub": (tmp.sub, jmp.sub),
                       "mul": (tmp.mul, jmp.mul)}[name]
    mine = port_op(a, b)
    ref = jax_op(JW(wide_parts_of(a)), JW(wide_parts_of(b)))
    ha, hb = wide_to_mpf(a, PREC), wide_to_mpf(b, PREC)
    with mpmath.workprec(PREC + 200):
        if name == "mul":
            exact = [x * y for x, y in zip(ha, hb)]
            scale = [abs(e) for e in exact]
        else:
            exact = [x + y if name == "add" else x - y for x, y in zip(ha, hb)]
            scale = [max(abs(x), abs(y)) for x, y in zip(ha, hb)]
    _held(mine, ref, exact, scale, PREC, -(PREC - 22))


def test_reference_defects_at_three_words(three):
    """Cases where the JAX package's generic-G branch misses mpmath and the
    port meets it: (a) the product of dense words (the top word product
    needs more than two words); (b) a sum whose top words cancel over ~40
    digits: the JAX words overlap (word 1 within 2^-(24 Kg - 4) of word 0),
    the port's do not, and its word 0 alone carries the value to
    2^-(24 Kg - 4)."""
    rng = np.random.default_rng(11)
    a, b = dense(rng, (64,)), dense(rng, (64,))
    ha, hb = wide_to_mpf(a, PREC), wide_to_mpf(b, PREC)
    with mpmath.workprec(PREC + 200):
        exact = [x * y for x, y in zip(ha, hb)]
    scale = [abs(e) for e in exact]
    mine, ref = tmp.mul(a, b), jmp.mul(JW(wide_parts_of(a)), JW(wide_parts_of(b)))
    misses = _held(mine, ref, exact, scale, PREC, -(PREC - 22))
    assert misses > 0, "the JAX package's product met mpmath on every element"
    assert _bits(wide_to_mpf(ref, PREC), exact, scale, PREC) > -(48 * 3 + 20)

    # (b) y = x (1 - 2^-40 u) + z, words of y staged exactly: x - y cancels
    # the top 40 digits
    with mpmath.workprec(PREC + 200):
        xs = [mpmath.mpf(rng.uniform(1, 2)) + mpmath.mpf(rng.uniform(-1, 1)) * 2 ** -60
              + mpmath.mpf(rng.uniform(-1, 1)) * 2 ** -130 for _ in range(8)]
        ys = [x * (1 - mpmath.mpf(rng.uniform(0.5, 1)) * 2 ** -40)
              + mpmath.mpf(rng.uniform(-1, 1)) * 2 ** -170 for x in xs]
    x, y = staged(xs, (8,)), staged(ys, (8,))
    mine, ref = tmp.sub(x, y), jmp.sub(JW(wide_parts_of(x)), JW(wide_parts_of(y)))
    hx, hy = wide_to_mpf(x, PREC), wide_to_mpf(y, PREC)
    with mpmath.workprec(PREC + 200):
        exact = [u - v for u, v in zip(hx, hy)]
    assert _bits(wide_to_mpf(mine, PREC), exact, [abs(u) for u in hx], PREC) < -(PREC - 22)

    def word0_error(v):
        w0 = wide_to_mpf(tmw.MPW(v.words[:1]), PREC)
        return _bits(w0, exact, [abs(e) for e in exact], PREC)

    assert word0_error(mine) < -(24 * 3 - 4)
    assert word0_error(ref) > -(24 * 3 - 4)


@pytest.mark.parametrize("Kw", [21, 27])
def test_port_against_mpmath_at_real_word_sizes(Kw):
    """3 x 7 (--precision 440) and 3 x 9 (640): sum, difference, product,
    division, rsqrt and sqrt of dense values over 40 binary orders within
    the JAX tests' bounds (2^-(PREC-22), division and roots 2^-(PREC-34));
    nearest_double exactly rounded; to_double and max_abs."""
    prec = 24 * Kw
    rng = np.random.default_rng(Kw)
    a, b = dense(rng, (6,), Kw), dense(rng, (6,), Kw, positive=True)
    assert (a.G, a.Kg) == (3, Kw // 3)
    ha, hb = wide_to_mpf(a, prec), wide_to_mpf(b, prec)
    with mpmath.workprec(prec + 200):
        checks = ((tmp.add(a, b), [x + y for x, y in zip(ha, hb)],
                   [max(abs(x), abs(y)) for x, y in zip(ha, hb)], 22),
                  (tmp.sub(a, b), [x - y for x, y in zip(ha, hb)],
                   [max(abs(x), abs(y)) for x, y in zip(ha, hb)], 22),
                  (tmp.mul(a, b), [x * y for x, y in zip(ha, hb)], None, 22),
                  (tmp.div(a, b), [x / y for x, y in zip(ha, hb)], None, 34),
                  (tmp.rsqrt(b), [1 / mpmath.sqrt(y) for y in hb], None, 34),
                  (tmp.sqrt(b), [mpmath.sqrt(y) for y in hb], None, 34))
    for i, (got, want, scale, slack) in enumerate(checks):
        scale = scale or [abs(w) for w in want]
        assert _bits(wide_to_mpf(got, prec), want, scale, prec) < -(prec - slack), i
    nd = tmp.nearest_double(a).numpy()
    with mpmath.workprec(prec + 120):
        for x, v in zip(nd, ha):
            lo, hi = np.nextafter(x, -np.inf), np.nextafter(x, np.inf)
            assert abs(mpmath.mpf(float(x)) - v) <= abs(mpmath.mpf(float(lo)) - v)
            assert abs(mpmath.mpf(float(x)) - v) <= abs(mpmath.mpf(float(hi)) - v)
    assert np.allclose(tmp.to_double(a).numpy(), [float(v) for v in ha], rtol=1e-15)
    assert float(tmp.max_abs(a)) == pytest.approx(max(abs(float(v)) for v in ha), rel=1e-6)


def test_sparse_words_product_is_exact_too():
    """The product of words whose content has gaps inside them (1 + 2^-g r
    + 2^-2g s, g near a word's width, its word 0 spread over ~24 Kg + 90
    digits), whose top word product spans far more than two words: at
    3 x 9 within 2^-(PREC-22) of mpmath, as for dense words (a top product
    in two words, as the JAX package takes it, keeps ~2^-482 there)."""
    Kw, prec = 27, 648
    rng = np.random.default_rng(5)
    vals = []
    with mpmath.workprec(prec + 200):
        for _ in range(12):
            g = int(rng.integers(176, 276))
            vals.append((mpmath.mpf(rng.uniform(-1, 1))
                         + mpmath.mpf(rng.uniform(-1, 1)) * mpmath.mpf(2) ** -g
                         + mpmath.mpf(rng.uniform(-1, 1)) * mpmath.mpf(2) ** (-2 * g))
                        * mpmath.mpf(2) ** int(rng.integers(-40, 40)))
    a, b = staged(vals[:6], (6,), Kw), staged(vals[6:], (6,), Kw)
    ha, hb = wide_to_mpf(a, prec), wide_to_mpf(b, prec)
    with mpmath.workprec(prec + 200):
        exact = [x * y for x, y in zip(ha, hb)]
    err = _bits(wide_to_mpf(tmp.mul(a, b), prec), exact, [abs(e) for e in exact], prec)
    assert err < -(prec - 22)


def test_structural_ops_match_jax(three):
    """where, mask_value, take, stack, concatenate, broadcast_to, diagonal,
    scalar_eye, expand_dims, pad_dim, abs_, mul_pow2, round_to (to a word
    and back), sign_array, to_float_array, to_double, max_abs: no
    arithmetic, the same words as the JAX package's."""
    rng = np.random.default_rng(40)
    a = dense(rng, (3, 4))
    ja = JW(wide_parts_of(a))
    m = np.array([[1, 0, 1, 1], [0, 1, 0, 1], [1, 1, 1, 0]], np.float32)
    pairs = [
        (tmp.mask_value(a, torch.as_tensor(m)), jmp.mask_value(ja, m)),
        (tmp.where(torch.as_tensor(m > 0), a, tmp.neg(a)), jmp.where(m > 0, ja, jmp.neg(ja))),
        (tmp.take(a, [2, 0], 1), jmp.take(ja, np.array([2, 0]), 1)),
        (tmp.stack([a, a], 0), jmp.stack([ja, ja], 0)),
        (tmp.concatenate([a, a], 1), jmp.concatenate([ja, ja], 1)),
        (tmp.broadcast_to(a, (2, 3, 4)), jmp.broadcast_to(ja, (2, 3, 4))),
        (tmp.diagonal(a[:, :3]), jmp.diagonal(ja[:, :3])),
        (tmp.scalar_eye(a[0], 3), jmp.scalar_eye(ja[0], 3)),
        (tmp.expand_dims(a, -1), jmp.expand_dims(ja, -1)),
        (tmp.pad_dim(a, 1, 2), jmp.pad_dim(ja, 1, 2)),
        (tmp.abs_(a), jmp.abs_(ja)),
        (tmp.mul_pow2(a, 0.25), jmp.mul_pow2(ja, 0.25)),
        (tmp.round_to(a, 2), jmp.round_to(ja, 2)),
        (tmp.round_to(tmp.round_to(a, 2), K), jmp.round_to(jmp.round_to(ja, 2), K)),
    ]
    for i, (mine, ref) in enumerate(pairs):
        if hasattr(ref, "words"):
            assert mine.G == 3 and same_wide(mine, ref), i
        else:
            assert np.array_equal(mine.limbs.numpy(), np.asarray(ref.limbs)) and \
                np.array_equal(mine.exp.numpy(), np.asarray(ref.exp)), i
    assert np.array_equal(tmp.sign_array(a).numpy(), np.asarray(jmp.sign_array(ja)))
    assert np.array_equal(tmp.to_float_array(a).numpy(), np.asarray(jmp.to_float_array(ja)))
    assert np.array_equal(tmp.to_double(a).numpy(), np.asarray(jmp.to_double(ja)))
    assert float(tmp.max_abs(a)) == float(jmp.max_abs(ja))


def test_the_three_word_kernels_refuse_and_broadcast(three):
    """The elementwise wrappers take two three-word values of one word size
    (raising otherwise, on the CPU too) and broadcast their shapes as the
    arithmetic does: [4, 5] + [5] equals [4, 5] + the row broadcast; no
    launch is counted on the CPU."""
    rng = np.random.default_rng(9)
    a, b = dense(rng, (4, 5)), dense(rng, (5,))
    tk.reset_launches()
    for op, plain in ((tk.mp_wide3_add, tk.mp_wide3_add_plain),
                      (tk.mp_wide3_mul, tk.mp_wide3_mul_plain)):
        got = op(a, b)
        assert got.shape == (4, 5)
        assert same_wide(got, plain(a, tmp.broadcast_to(b, (4, 5))))
    assert tk.LAUNCHES["mp_wide3_add"] == tk.LAUNCHES["mp_wide3_mul"] == 0
    two = tmw.MPW(a.words[:2])
    with pytest.raises(ValueError, match="G = 3"):
        tk.mp_wide3_add(two, two)
    with pytest.raises(ValueError, match="G = 3"):
        tk.mp_wide3_mul(a, dense(rng, (5,), 12))
