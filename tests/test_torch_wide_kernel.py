"""The wide GEMM's arithmetic in kernel order (sdpb_tpu_torch/ops/
mpwide_kernel.py) and its plain version (kernels.mp_matmul_wide_plain)
against the JAX package's sdpb_tpu/ops/mpwide_kernel.py and mpmath, on the
CPU.  The CUDA kernel itself is held bit for bit to the plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Word size Kg = 3 (PREC = 144 bits) for the parity tests, as
tests/test_mpwide_kernel.py runs the JAX list forms (their XLA:CPU compile
grows steeply with Kg); the port alone also at Kg = 5 and 9.

Tolerances:
  * add_st_c and mul_st_c: bit-identical (limbs and exponents) with the
    JAX package's add_st and mul_st, whose rows are in the same order;
  * add_full_c and mul_full_c: hi + lo within 2^-(PREC-8) relative of the
    JAX package's add_full_st and mul_full_st and of the exact sum or
    product (the lo word truncates at PREC = 48 Kg bits of the result; the
    compact lo stacks are ordered differently from the list forms', so the
    lo words may differ in their last limbs: the renorm's chain-sum tail);
  * the plain wide GEMM: within 2^-(PREC-26) relative of the JAX list-form
    wfma_acc chain + wnormalize and of mpmath (the bound of
    tests/test_mpwide_kernel.py::test_wide_fma_chain);
  * the spill case of tests/test_mpwide_kernel.py:162-178: within
    2^-(PREC-22) of mpmath.
"""
import mpmath
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdpb_tpu.ops import mpwide as jmw, mpwide_kernel as jwk
from sdpb_tpu_torch.ops import (kernels as tk, mpfloat as tmp, mpwide as tmw,
                                mpwide_kernel as twk)

from torch_parity import (max_rel_bits, mpf_to_f64_limbs, rand_scaled, rand_wide_vals,
                          same_wide, small_wide_config, wide_parts_of, wide_to_mpf)

torch.set_num_threads(1)

Kg = 3
PREC = 48 * Kg


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(jmw, "wide_config", small_wide_config)
    monkeypatch.setattr(tmw, "wide_config", small_wide_config)


def _sv(parts):
    return torch.tensor(parts[0]), torch.tensor(parts[1])


def _jsv(parts):
    return jnp.asarray(parts[0], jnp.float32), jnp.asarray(parts[1], jnp.int32)


def _same(x, y) -> bool:
    return np.array_equal(np.asarray(x[0]), np.asarray(y[0])) and \
        np.array_equal(np.asarray(x[1]), np.asarray(y[1]))


def _vals(parts_list, prec):
    return wide_to_mpf([tuple(np.asarray(v) for v in p) for p in parts_list], prec)


def _wide(vals, shape, K=2 * Kg):
    l64 = mpf_to_f64_limbs(vals, shape, 24 * K)
    return tmw.wide_parts_to_mp(tmw.f64_limbs_to_wide_parts(l64, K), "cpu")


@pytest.mark.parametrize("op", ["add", "mul"])
def test_base_ops_bit_identical_with_list_forms(op):
    rng = np.random.default_rng(3 if op == "add" else 4)
    a, b = rand_scaled(rng, (4, 5), Kg, 8.0), rand_scaled(rng, (4, 5), Kg, 8.0)
    b[1][0, :2] = -(1 << 24)                      # exact zeros
    b[0][:, 0, :2] = 0.0
    if op == "add":
        mine = twk.add_st_c(_sv(a), _sv(b), Kg)
        ref = jax.jit(lambda x, y: jwk.add_st(x, y, Kg))(_jsv(a), _jsv(b))
    else:
        mine = twk.mul_st_c(_sv(a), _sv(b), Kg)
        ref = jax.jit(lambda x, y: jwk.mul_st(x, y, Kg))(_jsv(a), _jsv(b))
    assert _same(mine, ref)


@pytest.mark.parametrize("op", ["add_full", "mul_full"])
def test_full_ops_match_list_forms_and_mpmath(op):
    """Word TwoSum and exact word product on operands over 8 decades,
    including leading cancellation (b = -a with its second limb scaled by
    1 + 2^-20) and a zero operand."""
    rng = np.random.default_rng(5 if op == "add_full" else 6)
    a, b = rand_scaled(rng, (16,), Kg, 8.0), rand_scaled(rng, (16,), Kg, 8.0)
    b[0][:, :3] = -a[0][:, :3]
    b[0][1, :3] *= np.float32(1 + 2.0 ** -20)
    b[1][:3] = a[1][:3]
    b[0][:, 3], b[1][3] = 0.0, -(1 << 24)
    port = {"add_full": twk.add_full_c, "mul_full": twk.mul_full_c}[op]
    lists = {"add_full": jwk.add_full_st, "mul_full": jwk.mul_full_st}[op]
    hi, lo = port(_sv(a), _sv(b), Kg)
    jhi, jlo = jax.jit(lambda x, y: lists(x, y, Kg))(_jsv(a), _jsv(b))
    mine, ref = _vals([hi, lo], PREC), _vals([jhi, jlo], PREC)
    with mpmath.workprec(PREC + 120):
        va, vb = _vals([a], PREC), _vals([b], PREC)
        exact = [x + y if op == "add_full" else x * y for x, y in zip(va, vb)]
    assert max_rel_bits(mine, ref, PREC) < -(PREC - 8)
    assert max_rel_bits(mine, exact, PREC) < -(PREC - 8)
    assert _same(hi, jhi) or op == "mul_full"


def test_plain_gemm_matches_jax_list_form(small):
    """kernels.mp_matmul_wide on CPU operands (its plain version) against
    the JAX list-form wfma_acc chain + wnormalize and mpmath; broadcast
    batch, Kd = 3, N = 1; the launch counter does not move."""
    rng = np.random.default_rng(7)
    B, M, Kd, N = 2, 2, 3, 1
    va = rand_wide_vals(rng, B * M * Kd, PREC, 2)
    vb = rand_wide_vals(rng, Kd * N, PREC, 2)
    a, b = _wide(va, (B, M, Kd)), _wide(vb, (Kd, N))
    tk.reset_launches()
    out = tk.mp_matmul_wide(a, b)
    assert out.shape == (B, M, N) and tk.LAUNCHES["mp_matmul_wide"] == 0

    def chain(aw, bw):
        acc = jwk.wzeros((B, M, N), Kg)
        for t in range(Kd):
            at = tuple((l[:, :, :, t:t + 1], e[:, :, t:t + 1]) for l, e in aw)
            bt = tuple((l[:, t:t + 1, :][:, None], e[t:t + 1, :][None]) for l, e in bw)
            acc = jwk.wfma_acc(acc, at, bt, Kg)
        return jwk.wnormalize(acc, Kg)

    # op by op: jitted, the unrolled chain compiles for minutes on the CPU
    ref = chain(tuple(_jsv(p) for p in wide_parts_of(a)),
                tuple(_jsv(p) for p in wide_parts_of(b)))
    mine = wide_to_mpf(out, PREC)
    assert max_rel_bits(mine, _vals(list(ref), PREC), PREC) < -(PREC - 26)
    ha = np.array(wide_to_mpf(a, PREC), dtype=object).reshape(B, M, Kd)
    hb = np.array(wide_to_mpf(b, PREC), dtype=object).reshape(Kd, N)
    with mpmath.workprec(PREC + 120):
        want = [mpmath.fsum(ha[i, m, t] * hb[t, n] for t in range(Kd))
                for i in range(B) for m in range(M) for n in range(N)]
    assert max_rel_bits(mine, want, PREC) < -(PREC - 26)


def _one_pass(a4, b4, K):
    """The wide GEMM as the one-pass chain of wfma_acc_c over t from a zero
    accumulator, then wnormalize_c."""
    _, B, M, Kd = a4.words[0].limbs.shape
    acc = twk.wzeros((B, M, b4.words[0].limbs.shape[-1]), K, "cpu")
    for t in range(Kd):
        at = tuple((w.limbs[..., t:t + 1], w.exp[..., t:t + 1]) for w in a4.words)
        bt = tuple((w.limbs[:, :, t:t + 1, :], w.exp[:, t:t + 1, :]) for w in b4.words)
        acc = twk.wfma_acc_c(acc, at, bt, K)
    return tmw.MPW(tmp.MP(*w) for w in twk.wnormalize_c(acc, K))


def _two_pass_operands(rng, Kw, Kd, B=2, M=3, N=2):
    """Operands [B,M,Kd] and [1,Kd,N] (a broadcast batch), canonicalised."""
    prec = 24 * Kw
    a = _wide(rand_wide_vals(rng, B * M * Kd, prec, 3), (B, M, Kd), Kw)
    b = _wide(rand_wide_vals(rng, Kd * N, prec, 3), (1, Kd, N), Kw)
    a4, b4, _ = tk._canon_wide_pair(a, b)
    assert a4.Kg == Kw // 2 and b4.words[0].limbs.shape == (Kw // 2, B, Kd, N)
    return a4, b4


@pytest.mark.parametrize("Kw,Kd", [(6, 1), (6, 2), (6, 7), (10, 1), (10, 2), (10, 7),
                                    (18, 1), (18, 2), (18, 7)])
def test_two_pass_plain_gemm_bit_identical_with_one_pass(Kw, Kd, monkeypatch):
    """The plain wide GEMM's two passes (wfma_term_c of every term at once,
    then wacc_c over t) against the one-pass chain of wfma_acc_c from a
    zero accumulator and wnormalize_c: limbs and exponents of both words
    bit-identical, at Kg = 3, 5 and 9, with a broadcast batch and ragged
    M = 3, N = 2."""
    if Kw == 6:
        monkeypatch.setattr(tmw, "wide_config", small_wide_config)
    a4, b4 = _two_pass_operands(np.random.default_rng(40 + Kw + Kd), Kw, Kd)
    assert same_wide(tk.mp_matmul_wide_plain(a4, b4), _one_pass(a4, b4, Kw // 2))


@pytest.mark.parametrize("Kw", [6, 10, 18])
def test_two_pass_plain_gemm_in_chunks_of_t(Kw, monkeypatch):
    """A term budget of 2 B M N: the plain two-pass GEMM runs Kd = 7 in
    chunks of 2, 2, 2 and 1 values of t, the accumulator carried across
    them, bit-identical with the one-pass chain."""
    if Kw == 6:
        monkeypatch.setattr(tmw, "wide_config", small_wide_config)
    a4, b4 = _two_pass_operands(np.random.default_rng(60 + Kw), Kw, 7)
    monkeypatch.setattr(tk, "WIDE_PLAIN_TERMS", 2 * 2 * 3 * 2)
    assert tk.wide_chunk(2, 3, 7, 2, tk.WIDE_PLAIN_TERMS) == 2
    assert same_wide(tk.mp_matmul_wide_plain(a4, b4), _one_pass(a4, b4, Kw // 2))


def test_spill_case_against_mpmath(small):
    """Operands whose word-0 content is spread wider than a word: the
    product through one wfma_acc_c step and wnormalize_c stays exact to
    the wide precision."""
    with mpmath.workprec(PREC + 200):
        va = [mpmath.mpf(3) / 7 + mpmath.mpf(5) / 11 * mpmath.mpf(2) ** -100]
        vb = [mpmath.mpf(1) / 3 + mpmath.mpf(2) ** -90 / 7]
    a, b = _wide(va, (1, 1, 1)), _wide(vb, (1, 1))
    out = tk.mp_matmul_wide(a, b)
    with mpmath.workprec(PREC + 200):
        want = [wide_to_mpf(a, PREC)[0] * wide_to_mpf(b, PREC)[0]]
    assert max_rel_bits(wide_to_mpf(out, PREC), want, PREC) < -(PREC - 22)


@pytest.mark.parametrize("Kw", [10, 18])
def test_plain_gemm_against_mpmath_at_real_word_sizes(Kw):
    """Kg = 5 and Kg = 9 (the --precision 400 contract), no JAX."""
    prec = 24 * Kw
    rng = np.random.default_rng(Kw)
    B, M, Kd, N = 1, 2, 3, 2
    va, vb = rand_wide_vals(rng, M * Kd, prec, 3), rand_wide_vals(rng, Kd * N, prec, 3)
    a, b = _wide(va, (B, M, Kd), Kw), _wide(vb, (B, Kd, N), Kw)
    assert a.Kg == Kw // 2
    out = tk.mp_matmul_wide(a, b)
    ha = np.array(wide_to_mpf(a, prec), dtype=object).reshape(M, Kd)
    hb = np.array(wide_to_mpf(b, prec), dtype=object).reshape(Kd, N)
    with mpmath.workprec(prec + 120):
        want = [mpmath.fsum(ha[m, t] * hb[t, n] for t in range(Kd))
                for m in range(M) for n in range(N)]
    assert max_rel_bits(wide_to_mpf(out, prec), want, prec) < -(prec - 26)


def test_wide_gemm_refuses_what_it_cannot_take(small):
    """G other than 2 or 3 raises (on the CPU too), and so do operands of
    different word counts; so do an MP operand and differing word sizes.
    Kd = 0 gives zeros."""
    rng = np.random.default_rng(8)
    a = _wide(rand_wide_vals(rng, 4, PREC, 2), (2, 2))
    g3, g4 = tmw.MPW(a.words + a.words[:1]), tmw.MPW(a.words + a.words)
    with pytest.raises(ValueError, match="G = 2 or G = 3"):
        tk.mp_matmul_wide(g4, g4)
    with pytest.raises(ValueError, match="G = 2 or G = 3"):
        tk.mp_matmul_wide(a, g3)
    with pytest.raises(TypeError):
        tk.mp_matmul_wide(a, a.words[0])
    b = _wide(rand_wide_vals(rng, 4, 24 * 10, 2), (2, 2), 10)
    with pytest.raises(ValueError, match="word sizes"):
        tk.mp_matmul_wide(a, b)
    z = tk.mp_matmul_wide(a[:, :0], a[:0, :])
    assert z.shape == (2, 2) and all(bool((w.limbs == 0).all()) for w in z.words)
    assert same_wide(z, tmw.zeros((2, 2), 2 * Kg, "cpu"))


@pytest.mark.slow
def test_plain_gemm_against_pallas_interpret(small):
    """The plain version against the Pallas wide kernel itself
    (pallas_kernels._mp_matmul_pallas_wide, interpret mode) at B = M = Kd
    = N = 2: within 2^-(PREC-26) (the interpret-mode body compiles for
    minutes on the CPU)."""
    from sdpb_tpu.ops import pallas_kernels as pk

    rng = np.random.default_rng(9)
    a = _wide(rand_wide_vals(rng, 8, PREC, 1), (2, 2, 2))
    b = _wide(rand_wide_vals(rng, 8, PREC, 1), (2, 2, 2))
    ref = pk._mp_matmul_pallas_wide(jmw.MPW(tuple(
        jmw.mpf.MP(*_jsv(p)) for p in wide_parts_of(a))), jmw.MPW(tuple(
            jmw.mpf.MP(*_jsv(p)) for p in wide_parts_of(b))), chunk=1, interpret=True)
    out = tk.mp_matmul_wide(a, b)
    assert max_rel_bits(wide_to_mpf(out, PREC), wide_to_mpf(ref, PREC), PREC) \
        < -(PREC - 26)
