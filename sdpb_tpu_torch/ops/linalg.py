"""Dense linear algebra on MP arrays (port of sdpb_tpu/ops/linalg.py).

Every product, Cholesky factorization and triangular solve goes to the
wrappers of ops/kernels.py: the CUDA kernel for CUDA tensors, its plain
PyTorch version for CPU tensors.  Shapes are batched, [..., n, m].  Wide
(MPW) products go to the wide GEMM; factorizations never take a wide
value (PosdefSolver factors word 0 and refines with wide residuals).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels
from . import mpfloat as mp
from .mpfloat import MP, _is_wide


def matmul(a: MP, b: MP) -> MP:
    """a [..., M, Kd] @ b [..., Kd, N] at full MP precision."""
    if _is_wide(a) or _is_wide(b):
        return kernels.mp_matmul_wide(a, b)
    return kernels.mp_matmul(a, b)


def col(x: MP) -> MP:
    """[..., n] -> [..., n, 1]."""
    return mp.expand_dims(x, -1)


def row(x: MP) -> MP:
    """[..., m] -> [..., 1, m]."""
    return mp.expand_dims(x, -2)


def matvec(a: MP, x: MP) -> MP:
    return matmul(a, col(x))[..., 0]


def outer(u: MP, v: MP) -> MP:
    return mp.mul(mp.expand_dims(u, -1), mp.expand_dims(v, -2))


def symmetrize(a: MP) -> MP:
    """(A + A^T) / 2."""
    return mp.mul_pow2(mp.add(a, a.mT), 0.5)


def frobenius(a: MP, b: MP) -> MP:
    """Tr(A B) for symmetric A, B: elementwise dot over the last two axes."""
    prod = mp.mul(a, b)
    flat = prod.reshape(prod.shape[:-2] + (prod.shape[-2] * prod.shape[-1],))
    return mp.sum_(flat, axis=flat.ndim - 1)


def trace(a: MP) -> MP:
    d = mp.diagonal(a)
    return mp.sum_(d, axis=d.ndim - 1)


def cholesky(A: MP) -> MP:
    """Lower Cholesky factor of SPD blocks A [..., n, n]."""
    return kernels.mp_cholesky(A)


def solve_lower(L: MP, B: MP) -> MP:
    """X = L^{-1} B, L [..., n, n] lower, B [..., n, m]."""
    return kernels.mp_solve_triangular(L, B, lower=True)


def solve_lower_T(L: MP, B: MP) -> MP:
    """X = L^{-T} B by backward substitution on the upper factor L^T."""
    return kernels.mp_solve_triangular(L.mT, B, lower=False)


def cholesky_solve(L: MP, B: MP) -> MP:
    """A^{-1} B given A = L L^T."""
    return solve_lower_T(L, solve_lower(L, B))


class PosdefSolver:
    """Cholesky factor of an SPD MP matrix at `factor_limbs` limbs, with
    full-precision solves against the original matrix by iterative
    refinement (residuals at full K, corrections at the factor precision).
    A wide A is factored as its word 0 rounded to factor_limbs <= 9 (by the
    scaled Cholesky kernel), and its residuals are wide products.
    The JAX package's optional Jacobi equilibration (off in the solver) is
    not ported; a scaled operand has no use for it (its exponents carry the
    range), and asking for it raises."""

    def __init__(self, A: MP, factor_limbs: int = 2, equilibrate: bool = False):
        if equilibrate:
            raise NotImplementedError(
                "equilibration is unnecessary with exponent-tracked limbs"
                if A.scaled else "Jacobi equilibration is not ported")
        self.A = A
        self.Kf = factor_limbs
        self.L = cholesky(mp.round_to(A, factor_limbs))

    @classmethod
    def from_parts(cls, A: MP, L: MP, factor_limbs: int) -> "PosdefSolver":
        """Reassemble from precomputed parts: A and its factor L at
        factor_limbs limbs (sdpb_tpu/ops/linalg.py:279-290, whose third part,
        the diagonal reciprocals, this solver does not keep)."""
        self = cls.__new__(cls)
        self.A = A
        self.Kf = factor_limbs
        self.L = L
        return self

    def solve_lo(self, B_lo: MP) -> MP:
        """A^{-1} B at factor precision."""
        return cholesky_solve(self.L, B_lo)

    def solve(self, B: MP, n_refine: int) -> MP:
        """A^{-1} B at B's full precision after n_refine refinement passes."""
        K = B.K
        x = mp.round_to(self.solve_lo(mp.round_to(B, self.Kf)), K)
        for _ in range(n_refine):
            r = mp.sub(B, matmul(self.A, x))
            dx = self.solve_lo(mp.round_to(r, self.Kf))
            x = mp.add(x, mp.round_to(dx, K))
        return x


class EigInput(NamedTuple):
    """What eigvalsh reads for min_eigenvalue_estimate, and how its result
    is read back."""
    sym: torch.Tensor     # [..., n, n] float64, rescaled, symmetrized, finite
    scale: torch.Tensor   # [..., 1, 1] the rescaling
    bad: torch.Tensor     # [...] True where A had a non-finite entry


def eigvalsh_input(A: MP) -> EigInput:
    """The float64 matrices of min_eigenvalue_estimate, without the
    eigvalsh: A read as float64, rescaled by its max magnitude and
    symmetrized (as jnp.linalg.eigvalsh does by default).  A non-finite
    entry (a failed iteration) is zeroed and its matrix marked `bad`, since
    LAPACK and cuSOLVER refuse it where jnp.linalg.eigvalsh returns NaN.

    A scaled A is read as its nearest float64 (mpfloat.nearest_double)
    where the JAX package reads float32, its base type on the TPU: the card
    has native float64, and so a scaled run sees the same float64 matrices
    as a classic one and takes the same steps, where float32 would move
    them at 1e-7 (the step lengths need only a few digits either way).  A
    wide A is read the same way, rounded once from both words."""
    a = mp.nearest_double(A) if A.scaled else mp.to_float_array(A)
    scale = torch.amax(torch.abs(a), dim=(-2, -1), keepdim=True)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    s = a / safe
    sym = (s + s.mT) / 2
    finite = torch.isfinite(sym)
    return EigInput(torch.where(finite, sym, torch.zeros_like(sym)), safe,
                    torch.logical_not(torch.all(finite.flatten(-2), dim=-1)))


def min_eigenvalue_from(inp: EigInput, w: torch.Tensor) -> torch.Tensor:
    """lambda_min from the eigenvalues w = eigvalsh(inp.sym): NaN where
    the matrix was not finite."""
    lmin = w[..., 0] * inp.scale[..., 0, 0]
    return torch.where(inp.bad, torch.full_like(lmin, float("nan")), lmin)


def min_eigenvalue_estimate(A: MP) -> torch.Tensor:
    """lambda_min of symmetric blocks A [..., n, n] in float64
    (eigvalsh_input, then eigvalsh)."""
    inp = eigvalsh_input(A)
    return min_eigenvalue_from(inp, torch.linalg.eigvalsh(inp.sym))
