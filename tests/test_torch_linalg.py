"""The port's MP linear algebra (sdpb_tpu_torch.ops.linalg, plain kernel
versions on the CPU) against sdpb_tpu.ops.linalg's XLA path on the CPU.

Tolerances:
  * elementwise helpers (symmetrize, frobenius, trace, outer): bit-identical
    (same mpfloat op sequence).
  * matmul, matvec, cholesky, triangular solves, refined solves: within
    2^-(53K-10) relative to the largest entry of the JAX result.  The
    port follows the Pallas kernels' order (chunks of 8, kernel term order,
    right-looking solves); the XLA path sums and substitutes in another
    order, so only the last limb differs.
  * min_eigenvalue_estimate: 1e-12 relative (float64 LAPACK eigvalsh on
    both sides, called through different libraries).
  * scaled operands (float32 limbs, int32 exponents, K32 = 3, entries
    graded over 8 decades): the refined solve within 2^-(24K-16) relative
    of the JAX package's and its residual at full precision; the scaled
    min_eigenvalue_estimate reads the nearest float64 of each entry, so it
    equals the classic estimate of the same values (the JAX package reads
    float32 there, its base type on the TPU).
"""
import numpy as np
import pytest
import torch

from sdpb_tpu.ops import linalg as jla
from sdpb_tpu_torch.ops import linalg as tla

from sdpb_tpu_torch.ops import mpfloat as tmp

from torch_parity import J, T, limbs_of, rand_limbs, rel_err, scaled_rel_err

torch.set_num_threads(1)


def _bound(K):
    return 2.0 ** -(53 * K - 10)


def _spd(rng, B, n, K):
    G = rng.standard_normal((B, n, n))
    A = rand_limbs(rng, (B, n, n), K)
    top = G @ np.swapaxes(G, -1, -2) + n * np.eye(n)
    A[1:] *= np.abs(top / A[0])
    A[0] = top
    return (A + np.swapaxes(A, -1, -2)) / 2


def test_elementwise_helpers_bit_identical():
    K = 3
    rng = np.random.default_rng(1)
    a = rand_limbs(rng, (2, 5, 5), K)
    b = rand_limbs(rng, (2, 5, 5), K)
    u, v = rand_limbs(rng, (2, 5), K), rand_limbs(rng, (2, 4), K)
    for jres, tres in ((jla.symmetrize(J(a)), tla.symmetrize(T(a))),
                       (jla.frobenius(J(a), J(b)), tla.frobenius(T(a), T(b))),
                       (jla.trace(J(a)), tla.trace(T(a))),
                       (jla.outer(J(u), J(v)), tla.outer(T(u), T(v)))):
        assert np.array_equal(limbs_of(jres), limbs_of(tres))


@pytest.mark.parametrize("K", [2, 3])
def test_matmul_and_matvec_within_bound(K):
    rng = np.random.default_rng(10 + K)
    a, b = rand_limbs(rng, (2, 4, 13), K), rand_limbs(rng, (2, 13, 3), K)
    assert rel_err(tla.matmul(T(a), T(b)), jla.matmul(J(a), J(b))) < _bound(K)
    x = rand_limbs(rng, (13,), K)
    assert rel_err(tla.matvec(T(a), T(x)), jla.matvec(J(a), J(x))) < _bound(K)


@pytest.mark.parametrize("K", [2, 3])
def test_factor_and_solves_within_bound(K):
    rng = np.random.default_rng(20 + K)
    A = _spd(rng, 2, 6, K)
    B = rand_limbs(rng, (2, 6, 3), K)
    L, Lj = tla.cholesky(T(A)), jla.cholesky(J(A))
    assert rel_err(L, Lj) < _bound(K)
    Lh = limbs_of(L)
    for tf, jf in ((tla.solve_lower, jla.solve_lower),
                   (tla.solve_lower_T, jla.solve_lower_T),
                   (tla.cholesky_solve, jla.cholesky_solve)):
        assert rel_err(tf(T(Lh), T(B)), jf(J(Lh), J(B))) < _bound(K)


def test_refined_solve_within_bound():
    """Factor at 2 limbs, refine to K = 3 (the solver's mixed precision)."""
    K = 3
    rng = np.random.default_rng(5)
    A = _spd(rng, 2, 6, K)
    B = rand_limbs(rng, (2, 6, 4), K)
    x = tla.PosdefSolver(T(A), 2).solve(T(B), n_refine=2)
    xj = jla.PosdefSolver(J(A), 2).solve(J(B), n_refine=2)
    assert rel_err(x, xj) < _bound(K)
    # and the residual is at full precision
    r = limbs_of(tla.matmul(T(A), x))
    assert rel_err(r, B) < _bound(K)


def test_min_eigenvalue_estimate():
    rng = np.random.default_rng(6)
    A = rand_limbs(rng, (3, 5, 5), 2)
    A[0] = A[0] + np.swapaxes(A[0], -1, -2)
    got = tla.min_eigenvalue_estimate(T(A)).numpy()
    want = np.asarray(jla.min_eigenvalue_estimate(J(A)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_scaled_refined_solve_and_eigenvalue_estimate():
    K = 3
    rng = np.random.default_rng(8)
    A = _spd(rng, 2, 6, 3)
    d = 10.0 ** rng.uniform(-2, 2, (2, 6))
    A = A * d[None, :, :, None] * d[None, :, None, :]
    A = tmp.f64_limbs_to_scaled_parts((A + np.swapaxes(A, -1, -2)) / 2, K)
    B = tmp.f64_limbs_to_scaled_parts(rand_limbs(rng, (2, 6, 4), 3), K)
    x = tla.PosdefSolver(T(A), 2).solve(T(B), n_refine=2)
    assert scaled_rel_err(x, jla.PosdefSolver(J(A), 2).solve(J(B), n_refine=2)) \
        < 2.0 ** -(24 * K - 16)
    assert scaled_rel_err(tla.matmul(T(A), x), T(B)) < 2.0 ** -(24 * K - 16)
    with pytest.raises(NotImplementedError, match="exponent-tracked"):
        tla.PosdefSolver(T(A), 2, equilibrate=True)
    exact = tmp.host_f64_limbs(T(A), 4)
    got = tla.min_eigenvalue_estimate(T(A))
    assert torch.equal(got, tla.min_eigenvalue_estimate(T(exact)))
