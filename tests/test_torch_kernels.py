"""The plain PyTorch versions of the port's CUDA kernels
(sdpb_tpu_torch.ops.kernels) against the Pallas kernels they replace, run
in interpret mode with float64 limbs on the CPU (as
tests/test_pallas_factor.py runs them).

Tolerances:
  * mp_matmul and mp_solve_triangular: bit-identical limbs (IEEE ==, so
    +0 and -0 compare equal).
  * mp_cholesky: bit-identical, or — where the Newton seed differs (the
    port seeds rsqrt with the correctly rounded 1/sqrt, Pallas with
    jax.lax.rsqrt) — L L^T - A within 2^-(53K-10) relative and L within
    2^-(53K-10) of the Pallas factor.
  * the scaled branches (float32 limbs and int32 exponents, `scaled=True`
    in Pallas; inputs spread over 8-12 decades, broadcast batch, a
    contraction tail padded with EXP_ZERO): mp_matmul and
    mp_solve_triangular bit-identical in limbs and exponents; mp_cholesky
    bit-identical with the jax.lax.rsqrt seed substituted, and with the
    port's own seed L within 2^-(24K-10) relative of the Pallas factor.
The CUDA kernels themselves are held to their plain versions, bit for
bit, by tests/test_torch_cuda.py and by chip_smoke.py on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdpb_tpu.ops import pallas_kernels as pk
from sdpb_tpu_torch.ops import kernels as tk, mpfloat as tmp

from torch_parity import (J, T, limbs_of, rand_limbs, rand_scaled, rel_err,
                          same_scaled, scaled_rel_err)

torch.set_num_threads(1)


def _spd(rng, B, n, K):
    G = rng.standard_normal((B, n, n))
    A = _lift(G @ np.swapaxes(G, -1, -2) + n * np.eye(n), rng, K)
    return (A + np.swapaxes(A, -1, -2)) / 2


def _lift(A, rng, K):
    """A as the top limb of K-limb values with fresh tail limbs."""
    out = rand_limbs(rng, A.shape, K)
    out[1:] *= np.abs(A / out[0])
    out[0] = A
    return out


@pytest.mark.parametrize("K", [2, 3, 4])
def test_matmul_plain_matches_pallas(K):
    rng = np.random.default_rng(10 + K)
    # broadcast batch, Kd = 11 (not a multiple of 8), N = 1
    a = rand_limbs(rng, (2, 2, 3, 11), K)
    b = rand_limbs(rng, (2, 1, 11, 1), K)
    out = tk.mp_matmul(T(a), T(b))
    assert out.shape == (2, 2, 3, 1)
    assert np.array_equal(limbs_of(out), limbs_of(pk.mp_matmul(J(a), J(b),
                                                               interpret=True)))
    if K == 3:
        # M = 1, 2-D a against a batched b, Kd = 8 exactly
        a = rand_limbs(rng, (1, 8), K)
        b = rand_limbs(rng, (2, 8, 4), K)
        assert np.array_equal(limbs_of(tk.mp_matmul(T(a), T(b))),
                              limbs_of(pk.mp_matmul(J(a), J(b), interpret=True)))


@pytest.mark.parametrize("K", [2, 3, 4])
def test_cholesky_plain_matches_pallas(K):
    rng = np.random.default_rng(20 + K)
    A = _spd(rng, 2, 7, K)
    L = limbs_of(tk.mp_cholesky(T(A)))
    Lp = limbs_of(pk.mp_cholesky(J(A), interpret=True))
    if np.array_equal(L, Lp):
        return
    bound = 2.0 ** -(53 * K - 10)
    assert rel_err(L, Lp) < bound
    LLt = tmp.sum_(tmp.mul(tmp.expand_dims(T(L), -2), tmp.expand_dims(T(L), -3)),
                   axis=3)
    assert rel_err(LLt, np.tril(A) + np.swapaxes(np.tril(A, -1), -1, -2)) < bound


@pytest.mark.parametrize("K", [2, 3, 4])
def test_trsm_plain_matches_pallas(K):
    rng = np.random.default_rng(30 + K)
    L = limbs_of(tk.mp_cholesky(T(_spd(rng, 2, 6, K))))
    B = rand_limbs(rng, (2, 6, 3), K)
    for lower, t in ((True, L), (False, np.ascontiguousarray(np.swapaxes(L, -1, -2)))):
        X = tk.mp_solve_triangular(T(t), T(B), lower=lower)
        Xp = pk.mp_solve_triangular(J(t), J(B), lower=lower, interpret=True)
        assert np.array_equal(limbs_of(X), limbs_of(Xp)), lower


def _spd_scaled(rng, B, n, K, decades):
    """SPD blocks graded over 2 * decades decades, as scaled parts."""
    G = rng.standard_normal((B, n, n))
    A = G @ np.swapaxes(G, -1, -2) + n * np.eye(n)
    d = 10.0 ** rng.uniform(-decades, decades, (B, n))
    A = _lift(A * d[:, :, None] * d[:, None, :], rng, -(-(24 * K) // 53) + 1)
    return tmp.f64_limbs_to_scaled_parts((A + np.swapaxes(A, -1, -2)) / 2, K)


@pytest.mark.parametrize("K", [2, 3])
def test_scaled_matmul_plain_matches_pallas(K):
    rng = np.random.default_rng(40 + K)
    # broadcast batch, Kd = 11 (a tail of 5 padded with EXP_ZERO), N = 1
    a = rand_scaled(rng, (2, 2, 3, 11), K, decades=6.0)
    b = rand_scaled(rng, (2, 1, 11, 1), K, decades=6.0)
    out = tk.mp_matmul(T(a), T(b))
    assert out.shape == (2, 2, 3, 1)
    assert same_scaled(out, pk.mp_matmul(J(a), J(b), interpret=True))
    # exact zeros among the operands keep their EXP_ZERO through the tree
    a[0][:, 0, 0, :, :4] = 0.0
    a[1][0, 0, :, :4] = tmp.EXP_ZERO
    assert same_scaled(tk.mp_matmul(T(a), T(b)), pk.mp_matmul(J(a), J(b), interpret=True))


@pytest.mark.parametrize("K", [2, 3])
def test_scaled_cholesky_plain_matches_pallas(K, monkeypatch):
    rng = np.random.default_rng(50 + K)
    A = _spd_scaled(rng, 2, 7, K, decades=5.0)
    Lp = pk.mp_cholesky(J(A), interpret=True)
    assert scaled_rel_err(tk.mp_cholesky(T(A)), Lp) < 2.0 ** -(24 * K - 10)
    monkeypatch.setattr(tmp, "inv_sqrt", lambda m: torch.from_numpy(
        np.array(jax.lax.rsqrt(jnp.asarray(m.numpy())))))
    assert same_scaled(tk.mp_cholesky(T(A)), Lp)


@pytest.mark.parametrize("K", [2, 3])
def test_scaled_trsm_plain_matches_pallas(K):
    rng = np.random.default_rng(60 + K)
    L = tk.mp_cholesky(T(_spd_scaled(rng, 2, 6, K, decades=4.0)))
    L = (L.limbs.numpy(), L.exp.numpy())
    Lt = tuple(np.ascontiguousarray(np.swapaxes(x, -1, -2)) for x in L)
    B = rand_scaled(rng, (2, 6, 3), K, decades=4.0)
    for lower, t in ((True, L), (False, Lt)):
        X = tk.mp_solve_triangular(T(t), T(B), lower=lower)
        assert same_scaled(X, pk.mp_solve_triangular(J(t), J(B), lower=lower,
                                                     interpret=True)), lower


def test_dispatch_is_by_device_without_fallback():
    """CPU operands run the plain version and launch nothing; operands on
    any other non-CUDA device, or split across devices, raise."""
    rng = np.random.default_rng(1)
    a = T(rand_limbs(rng, (2, 3, 3), 2))
    tk.reset_launches()
    tk.mp_matmul(a, a)
    tk.mp_cholesky(tmp.MP(torch.as_tensor(_spd(rng, 2, 3, 2))))
    tk.mp_solve_triangular(a, a)
    assert tk.LAUNCHES == {"mp_matmul": 0, "mp_cholesky": 0,
                           "mp_solve_triangular": 0, "mp_matmul_scaled": 0,
                           "mp_cholesky_scaled": 0, "mp_solve_triangular_scaled": 0,
                           "mp_matmul_wide": 0}
    meta = tmp.MP(torch.empty((2, 2, 3, 3), dtype=torch.float64, device="meta"))
    for call in (lambda: tk.mp_matmul(meta, meta), lambda: tk.mp_cholesky(meta),
                 lambda: tk.mp_solve_triangular(meta, meta),
                 lambda: tk.mp_matmul(a, meta)):
        with pytest.raises(ValueError):
            call()


def test_library_names_follow_source_hash():
    paths = {tk.library_path(K) for K in tk.K_RANGE}
    assert len(paths) == len(tk.K_RANGE)
    assert all(p.parent == tk.BUILD_DIR for p in paths)
    assert {p.name for p in tk.CSRC.iterdir()} >= {"mp.cuh", *tk.SOURCES}
