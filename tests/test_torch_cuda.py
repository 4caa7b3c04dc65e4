"""The port's CUDA kernels and MP arithmetic on the card.  Every test here
needs a CUDA device and nvcc and skips without them.  The file imports no
JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances, all bit-identical limbs (IEEE ==) and, for the scaled
representation, identical exponents:
  * each kernel, classic and scaled, against its plain PyTorch version on
    the card;
  * each kernel on the card against its plain version on the CPU (which
    tests/test_torch_kernels.py holds bit for bit to the Pallas kernels);
  * the elementwise MP ops on the card against the same ops on the CPU,
    and the Newton seed 1/sqrt(m) against numpy's correctly rounded one.
A run of the solver on the card is held to the CPU run at 1e-8 relative:
the step lengths come from eigvalsh, which is cuSOLVER on the card and
LAPACK on the CPU.
"""
import numpy as np
import pytest
import torch

from sdpb_tpu_torch.ops import kernels as tk, mpfloat as tmp

from torch_parity import T, rand_limbs, rand_scaled, same_scaled

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


def _spd(rng, B, n, K):
    G = rng.standard_normal((B, n, n))
    A = rand_limbs(rng, (B, n, n), K)
    top = G @ np.swapaxes(G, -1, -2) + n * np.eye(n)
    A[1:] *= np.abs(top / A[0])
    A[0] = top
    return (A + np.swapaxes(A, -1, -2)) / 2


def _same(x: tmp.MP, y: tmp.MP) -> bool:
    return torch.equal(x.limbs.cpu(), y.limbs.cpu()) and (
        x.exp is None or torch.equal(x.exp.cpu(), y.exp.cpu()))


def _spd_scaled(rng, B, n, K, decades=2.5):
    """SPD blocks graded over 2 * decades decades, as scaled parts."""
    G = rng.standard_normal((B, n, n))
    top = G @ np.swapaxes(G, -1, -2) + n * np.eye(n)
    d = 10.0 ** rng.uniform(-decades, decades, (B, n))
    top = top * d[:, :, None] * d[:, None, :]
    A = rand_limbs(rng, (B, n, n), -(-(24 * K) // 53) + 1)
    A[1:] *= np.abs(top / A[0])
    A[0] = top
    return tmp.f64_limbs_to_scaled_parts((A + np.swapaxes(A, -1, -2)) / 2, K)


@pytest.mark.parametrize("K", list(range(2, 14)))
def test_kernels_match_plain_versions(cuda, K):
    rng = np.random.default_rng(K)
    # broadcast batch, Kd = 11 (not a multiple of 8), N = 1
    a, b = rand_limbs(rng, (2, 3, 5, 11), K), rand_limbs(rng, (1, 11, 1), K)
    tk.reset_launches()
    out = tk.mp_matmul(T(a, cuda), T(b, cuda))
    assert tk.LAUNCHES["mp_matmul"] == 1
    a4, b4, unflatten = tk._canon_batched_pair(T(a, cuda), T(b, cuda))
    assert _same(out, unflatten(tk.mp_matmul_plain(a4, b4)))
    assert _same(out, tk.mp_matmul(T(a), T(b)))

    A = _spd(rng, 3, 9, K)
    L = tk.mp_cholesky(T(A, cuda))
    assert tk.LAUNCHES["mp_cholesky"] == 1
    assert _same(L, tk.mp_cholesky_plain(T(A, cuda)))
    assert _same(L, tk.mp_cholesky(T(A)))

    B = rand_limbs(rng, (3, 9, 4), K)
    Lh = L.limbs.cpu().numpy()
    for lower, t in ((True, Lh), (False, np.swapaxes(Lh, -1, -2))):
        X = tk.mp_solve_triangular(T(t, cuda), T(B, cuda), lower)
        assert _same(X, tk.mp_solve_triangular_plain(T(t, cuda), T(B, cuda), lower))
        assert _same(X, tk.mp_solve_triangular(T(t), T(B), lower))
    assert tk.LAUNCHES["mp_solve_triangular"] == 2


@pytest.mark.parametrize("K", list(range(2, 10)))
def test_scaled_kernels_match_plain_versions(cuda, K):
    rng = np.random.default_rng(100 + K)
    a, b = rand_scaled(rng, (2, 3, 5, 11), K), rand_scaled(rng, (1, 11, 1), K)
    tk.reset_launches()
    out = tk.mp_matmul(T(a, cuda), T(b, cuda))
    assert tk.LAUNCHES["mp_matmul_scaled"] == 1 and tk.LAUNCHES["mp_matmul"] == 0
    a4, b4, unflatten = tk._canon_batched_pair(T(a, cuda), T(b, cuda))
    assert _same(out, unflatten(tk.mp_matmul_plain(a4, b4)))
    assert _same(out, tk.mp_matmul(T(a), T(b)))

    A = _spd_scaled(rng, 3, 9, K)
    L = tk.mp_cholesky(T(A, cuda))
    assert tk.LAUNCHES["mp_cholesky_scaled"] == 1
    assert _same(L, tk.mp_cholesky_plain(T(A, cuda)))
    assert _same(L, tk.mp_cholesky(T(A)))

    B = rand_scaled(rng, (3, 9, 4), K)
    Lh = (L.limbs.cpu().numpy(), L.exp.cpu().numpy())
    Lt = tuple(np.ascontiguousarray(np.swapaxes(x, -1, -2)) for x in Lh)
    for lower, t in ((True, Lh), (False, Lt)):
        X = tk.mp_solve_triangular(T(t, cuda), T(B, cuda), lower)
        assert _same(X, tk.mp_solve_triangular_plain(T(t, cuda), T(B, cuda), lower))
        assert _same(X, tk.mp_solve_triangular(T(t), T(B), lower))
    assert tk.LAUNCHES["mp_solve_triangular_scaled"] == 2
    assert tk.LAUNCHES["mp_solve_triangular"] == 0


def test_scaled_dispatch_launches_or_raises(cuda):
    """A scaled CUDA operand launches the scaled kernel (its counter, and
    only its, moves) or raises; it never runs the plain version."""
    rng = np.random.default_rng(9)
    a = T(rand_scaled(rng, (2, 3, 3), 3), cuda)
    tk.reset_launches()
    tk.mp_matmul(a, a)
    tk.mp_cholesky(T(_spd_scaled(rng, 2, 3, 3), cuda))
    tk.mp_solve_triangular(a, a)
    assert tk.LAUNCHES == {"mp_matmul": 0, "mp_cholesky": 0, "mp_solve_triangular": 0,
                           "mp_matmul_scaled": 1, "mp_cholesky_scaled": 1,
                           "mp_solve_triangular_scaled": 1,
                           "mp_matmul_wide": 0, "mp_matmul_wide3": 0, "mp_wide3_add": 0,
                           "mp_wide3_mul": 0, "peak_probe": 0}
    wrong_limbs = tmp.MP(a.limbs.double(), a.exp)
    wrong_exp = tmp.MP(a.limbs, a.exp.long())
    classic = tmp.MP(a.limbs.double())
    for x, y in ((wrong_limbs, wrong_limbs), (wrong_exp, wrong_exp), (a, classic)):
        with pytest.raises(TypeError):
            tk.mp_matmul(x, y)
    with pytest.raises(ValueError):
        tk.mp_cholesky(tmp.MP(torch.zeros((10, 1, 3, 3), device=cuda),
                              torch.zeros((1, 3, 3), dtype=torch.int32, device=cuda)))
    assert tk.LAUNCHES["mp_matmul_scaled"] == 1


@pytest.mark.parametrize("K", [2, 3, 5, 9])
def test_scaled_elementwise_ops_agree_across_devices(cuda, K):
    rng = np.random.default_rng(60 + K)
    a = rand_scaled(rng, (400,), K)
    c = rand_scaled(rng, (400,), K, positive=True)
    ops = {
        "add": lambda x, y: tmp.add(x, y),
        "mul": lambda x, y: tmp.mul(x, y),
        "kmul": lambda x, y: tmp.kmul(x, y),
        "div": lambda x, y: tmp.div(x, y),
        "reciprocal": lambda x, y: tmp.reciprocal(y, kernel_order=True),
        "rsqrt": lambda x, y: tmp.rsqrt(y),
        "sqrt": lambda x, y: tmp.sqrt(y),
        "sum": lambda x, y: tmp.sum_(x, axis=0),
        "round_to": lambda x, y: tmp.round_to(x, 2),
        "to_float": lambda x, y: tmp.MP(tmp.to_float_array(x)[None]),
    }
    for name, f in ops.items():
        assert _same(f(T(a, cuda), T(c, cuda)), f(T(a), T(c))), name
    m = torch.as_tensor(c[0][0] + c[0][1])
    seed = tmp.inv_sqrt(m.to(cuda)).cpu().numpy()
    assert np.array_equal(seed, (np.float32(1) / np.sqrt(m.numpy())))


@pytest.mark.parametrize("K", [2, 3, 5, 8])
def test_elementwise_ops_agree_across_devices(cuda, K):
    rng = np.random.default_rng(50 + K)
    a = rand_limbs(rng, (400,), K, spread=3.0)
    c = rand_limbs(rng, (400,), K, positive=True, spread=3.0)
    ops = {
        "add": lambda x, y: tmp.add(x, y),
        "mul": lambda x, y: tmp.mul(x, y),
        "kmul": lambda x, y: tmp.kmul(x, y),
        "div": lambda x, y: tmp.div(x, y),
        "reciprocal": lambda x, y: tmp.reciprocal(y),
        "rsqrt": lambda x, y: tmp.rsqrt(y),
        "rsqrt_kernel_order": lambda x, y: tmp.rsqrt(y, kernel_order=True),
        "sqrt": lambda x, y: tmp.sqrt(y),
        "sum": lambda x, y: tmp.sum_(x, axis=0),
    }
    for name, f in ops.items():
        assert _same(f(T(a, cuda), T(c, cuda)), f(T(a), T(c))), name
    m = c[0] + c[1]
    seed = tmp.inv_sqrt(torch.as_tensor(m, device=cuda)).cpu().numpy()
    assert np.array_equal(seed, 1.0 / np.sqrt(m))


def test_cuda_dispatch_raises_on_what_the_kernels_cannot_take(cuda):
    x = torch.zeros((2, 1, 3, 3), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        tk.mp_matmul(tmp.MP(x), tmp.MP(x))
    # classic limbs past the kernels' K = 13
    fourteen = tmp.MP(torch.zeros((14, 1, 3, 3), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        tk.mp_cholesky(fourteen)
    with pytest.raises(ValueError):
        tk.mp_matmul(tmp.MP(fourteen.limbs[:2]), tmp.MP(fourteen.limbs[:2].cpu()))


@pytest.mark.parametrize("scaled_limbs", [0, 7])
def test_solver_on_card_follows_cpu_run(cuda, scaled_limbs):
    """Four iterations of the certificate SDP on the card and on the CPU
    (float64 eigenvalues from cuSOLVER and from LAPACK set the steps):
    every statistic to 1e-8 relative (classic) or 1e-5 (scaled, whose
    error norms and corrector beta are float32)."""
    from pathlib import Path

    from sdpb_tpu_torch.io.sdp_zip import read_sdp
    from sdpb_tpu_torch.models.sdp import build_device_sdp
    from sdpb_tpu_torch.solver.params import SolverParameters
    from sdpb_tpu_torch.solver.solve import host_mpf, run_solver

    zip_ = Path(__file__).resolve().parents[1] / "fixtures" / "dim2_certificate" / "sdp.zip"
    host = read_sdp(zip_, 5 if scaled_limbs else 3)
    params = SolverParameters(precision=150, initial_matrix_scale_primal="1e2",
                              initial_matrix_scale_dual="1e2", max_iterations=4)
    tk.reset_launches()
    on_card = run_solver(build_device_sdp(host, cuda, scaled_limbs), params,
                         verbosity=0)
    names = [tk.counter(n, bool(scaled_limbs)) for n in tk.KERNEL_NAMES]
    assert all(tk.LAUNCHES[n] > 0 for n in names), tk.LAUNCHES
    on_cpu = run_solver(build_device_sdp(host, "cpu", scaled_limbs), params,
                        verbosity=0)
    rel = 1e-5 if scaled_limbs else 1e-8
    assert str(on_card.terminate_reason) == str(on_cpu.terminate_reason)
    assert len(on_card.history) == len(on_cpu.history)
    for mine, ref in zip(on_card.history, on_cpu.history):
        for f in mine._fields:
            got, want = getattr(mine, f), getattr(ref, f)
            if f in ("primal_objective", "dual_objective", "duality_gap", "mu"):
                got, want = float(host_mpf(got)), float(host_mpf(want))
            assert abs(got - want) <= rel * max(abs(want), 1e-30), f


# ---------------------------------------------------------------------------
# The triangular solve at edge shapes: the kernel keeps the reciprocals,
# x_i, the residual and T's triangle in shared memory where all four fit,
# and reads all four through L2 (the wrapper's scratch, X, T) where they do
# not


TRSM_NS = (1, 2, 31, 32, 33, 57, 64, 65, 130)
# (m, B) per n: one column, the ladder's 15 columns over 120 blocks, more
# columns than a block has warps; B = 133 is more blocks than SMs
TRSM_MB = ((1, 133), (15, 120), (33, 1))


def _trsm_operands(rng, B, n, m, K, scaled):
    """A triangular solve's T [B,n,n] (its diagonal above its rows' other
    entries) and right-hand side [B,n,m], as parts."""
    if scaled:
        t = rand_scaled(rng, (B, n, n), K, decades=2.0)
        idx = np.arange(n)
        t[1][:, idx, idx] += 4      # a diagonal above its rows' entries
        return t, rand_scaled(rng, (B, n, m), K, decades=2.0)
    t = rand_limbs(rng, (B, n, n), K)
    t[0][:, np.arange(n), np.arange(n)] += n * np.sign(t[0][:, np.arange(n), np.arange(n)])
    return t, rand_limbs(rng, (B, n, m), K)


def _trsm_matches(cuda, t, b, scaled, label):
    for lower in (True, False):
        tk.reset_launches()
        X = tk.mp_solve_triangular(T(t, cuda), T(b, cuda), lower)
        assert tk.LAUNCHES[tk.counter("mp_solve_triangular", scaled)] == 1
        want = tk.mp_solve_triangular_plain(T(t, cuda), T(b, cuda), lower)
        assert _same(X, want), (label, lower)


@pytest.mark.parametrize("scaled,K", [(False, 4), (False, 12), (False, 13), (True, 8)])
@pytest.mark.parametrize("n", TRSM_NS)
def test_trsm_kernel_matches_plain_version_at_edge_shapes(cuda, n, scaled, K):
    """Lower and upper, classic K=4 and scaled K=8 (the ladder's factor
    limbs), classic K=12 and 13 (the product of --precision 577-681): the
    kernel bit for bit with its plain version on the card.  At
    n = 130 (T's triangle 8515 elements, 272 KB classic, 306 KB scaled)
    nothing is in shared memory; at every other n, as at the ladder's
    shapes (n <= 57, m <= 38), everything is."""
    rng = np.random.default_rng(500 + n + 1000 * scaled + (10 * K if K >= 12 else 0))
    for m, B in TRSM_MB:
        t, b = _trsm_operands(rng, B, n, m, K, scaled)
        _trsm_matches(cuda, t, b, scaled, (m, B))


@pytest.mark.parametrize("scaled,K,n,m", [(False, 4, 2, 7300), (False, 8, 3, 3700),
                                          (True, 9, 3, 5900)])
def test_trsm_kernel_past_shared_memory(cuda, scaled, K, n, m):
    """Shapes whose reciprocals and x_i alone, n + m elements, overflow the
    H100's 227 KB of shared memory a block (233-237 KB here): the kernel
    solves them through L2, bit for bit with its plain version, with one
    batch element.  Few pivots: a block runs one batch element's whole
    solve on one SM."""
    rng = np.random.default_rng(700 + n + m + scaled)
    t, b = _trsm_operands(rng, 1, n, m, K, scaled)
    _trsm_matches(cuda, t, b, scaled, (n, m))


# ---------------------------------------------------------------------------
# The GEMM and the factor at edge shapes: the GEMM splits each output's
# contraction over threads (a chunk of 8 a thread, rounds of chunks, the
# chunk sums folded in shared memory), the factor runs its pivot chain in
# a warp of its own ahead of the worker warps


GEMM_KDS = (1, 7, 8, 9, 57, 129)
GEMM_MN = ((1, 33), (33, 1), (15, 15))
BUILDS = ((False, 4), (False, 8), (False, 11), (False, 12), (False, 13), (True, 8), (True, 9))


def _operand(rng, shape, K, scaled, device, decades=2.0):
    return T(rand_scaled(rng, shape, K, decades=decades) if scaled else rand_limbs(rng, shape, K),
             device)


@pytest.mark.parametrize("Kd", GEMM_KDS)
@pytest.mark.parametrize("scaled,K", BUILDS)
def test_gemm_kernel_matches_plain_version_at_edge_shapes(cuda, scaled, K, Kd):
    """Classic K = 4, 8, 11, 12 and 13, scaled K = 8 and 9: contractions of
    one chunk and less, a chunk and one, 8 and 17 chunks; one row, one
    column and a square output; one batch element and more than the card
    has SMs.  The kernel bit for bit with its plain version on the card,
    one launch."""
    rng = np.random.default_rng(800 + Kd + 10 * K + 1000 * scaled)
    for M, N in GEMM_MN:
        for B in (1, 133):
            a = _operand(rng, (B, M, Kd), K, scaled, cuda)
            b = _operand(rng, (B, Kd, N), K, scaled, cuda)
            tk.reset_launches()
            out = tk.mp_matmul(a, b)
            assert tk.LAUNCHES[tk.counter("mp_matmul", scaled)] == 1
            assert _same(out, tk.mp_matmul_plain(a, b)), (M, N, B)


def test_scaled_gemm_kernel_graded_operands_with_zeros(cuda):
    """Scaled K = 9 operands over 20 decades with exact zeros (EXP_ZERO)
    scattered among them and whole chunks of zeros: the exponents meet in
    the chunk tree and in the accumulate as in the plain version."""
    rng = np.random.default_rng(901)
    K, B, M, Kd, N = 9, 7, 15, 57, 15
    a = rand_scaled(rng, (B, M, Kd), K, decades=10.0)
    b = rand_scaled(rng, (B, Kd, N), K, decades=10.0)
    for x, shape in ((a, (B, M, Kd)), (b, (B, Kd, N))):
        zero = rng.random(shape) < 0.2
        x[0][:, zero] = 0.0
        x[1][zero] = tmp.EXP_ZERO
    a[0][:, :, :, 8:16] = 0.0
    a[1][:, :, 8:16] = tmp.EXP_ZERO
    A, Bm = T(a, cuda), T(b, cuda)
    assert _same(tk.mp_matmul(A, Bm), tk.mp_matmul_plain(A, Bm))


CHOL_NS = (1, 2, 31, 32, 33, 57, 65, 130)


@pytest.mark.parametrize("n", CHOL_NS)
@pytest.mark.parametrize("scaled,K", [(False, 4), (False, 12), (False, 13), (True, 8),
                                      (True, 9)])
def test_cholesky_kernel_matches_plain_version_at_edge_shapes(cuda, scaled, K, n):
    """Classic K = 4, 12 and 13, scaled K = 8 and 9 (graded over 5 decades): one and
    two pivots, a warp's width of pivots and one either side, the ladder's
    57, and past two warps of rows (one batch element there, so that the
    plain version stays fast).  Bit for bit, one launch."""
    rng = np.random.default_rng(1100 + n + 10 * K + 1000 * scaled)
    B = 1 if n >= 65 else 3
    A = T(_spd_scaled(rng, B, n, K) if scaled else _spd(rng, B, n, K), cuda)
    tk.reset_launches()
    L = tk.mp_cholesky(A)
    assert tk.LAUNCHES[tk.counter("mp_cholesky", scaled)] == 1
    assert _same(L, tk.mp_cholesky_plain(A))


def test_scaled_cholesky_kernel_graded_over_twenty_decades(cuda):
    """Scaled K = 8 SPD blocks graded over 20 decades (the ladder's factor
    limbs), 120 of them at n = 20: bit for bit."""
    rng = np.random.default_rng(1201)
    A = T(_spd_scaled(rng, 120, 20, 8, decades=10.0), cuda)
    assert _same(tk.mp_cholesky(A), tk.mp_cholesky_plain(A))


# ---------------------------------------------------------------------------
# The wide (two-word) GEMM and the wide elementwise ops


def _wide(rng, shape, K, decades=3):
    """A random MPW of K = 2 Kg limbs (CPU) with content in both words."""
    from sdpb_tpu_torch.ops import mpwide as tmw
    from torch_parity import mpf_to_f64_limbs, rand_wide_vals

    n = int(np.prod(shape))
    vals = rand_wide_vals(rng, n, 24 * K, decades)
    return tmw.wide_parts_to_mp(
        tmw.f64_limbs_to_wide_parts(mpf_to_f64_limbs(vals, shape, 24 * K), K), "cpu")


def _wide_np(rng, shape, Kg, decades=2.0):
    """A random MPW of 2 Kg limbs (CPU) from float64 limb stacks with fresh
    bits in every limb (past the 48 Kg bits the two words hold), staged
    exactly; numpy only, so large operands are cheap."""
    from sdpb_tpu_torch.ops import mpwide as tmw
    K64 = -(-(48 * Kg) // 53) + 2
    l64 = rand_limbs(rng, shape, K64, spread=decades)
    return tmw.wide_parts_to_mp(tmw.f64_limbs_to_wide_parts(l64, 2 * Kg), "cpu")


def _on(x, device):
    from sdpb_tpu_torch.ops import mpwide as tmw
    return tmw.MPW(tmp.MP(w.limbs.to(device), w.exp.to(device)) for w in x.words)


def _same_wide(x, y) -> bool:
    return len(x.words) == len(y.words) and all(_same(a, b) for a, b in zip(x.words, y.words))


@pytest.mark.parametrize("Kg", [3, 5, 9])
def test_wide_kernel_matches_plain_version(cuda, Kg, monkeypatch):
    """The wide GEMM on the card bit for bit with its plain version on the
    card and on the CPU: a broadcast (padded) batch, Kd = 7 and Kd = 1."""
    from sdpb_tpu_torch.ops import mpwide as tmw
    from torch_parity import small_wide_config

    if Kg == 3:
        monkeypatch.setattr(tmw, "wide_config", small_wide_config)
    rng = np.random.default_rng(300 + Kg)
    for ashape, bshape in (((2, 3, 7), (1, 7, 2)), ((3, 4, 1), (3, 1, 5))):
        a, b = _wide(rng, ashape, 2 * Kg), _wide(rng, bshape, 2 * Kg)
        tk.reset_launches()
        out = tk.mp_matmul_wide(_on(a, cuda), _on(b, cuda))
        assert tk.LAUNCHES["mp_matmul_wide"] == 1
        a4, b4, unflatten = tk._canon_wide_pair(_on(a, cuda), _on(b, cuda))
        assert _same_wide(out, unflatten(tk.mp_matmul_wide_plain(a4, b4)))
        assert _same_wide(out, tk.mp_matmul_wide(a, b))
        assert tk.LAUNCHES["mp_matmul_wide"] == 1


def test_wide_dispatch_raises_on_what_the_kernel_cannot_take(cuda):
    """G = 4 raises on the card (and on the CPU); a wide operand never runs
    the plain version on the card."""
    from sdpb_tpu_torch.ops import mpwide as tmw

    rng = np.random.default_rng(310)
    a = _on(_wide(rng, (2, 2), 10), cuda)
    g4 = tmw.MPW(a.words + a.words)
    tk.reset_launches()
    with pytest.raises(ValueError, match="G = 2 or G = 3"):
        tk.mp_matmul_wide(g4, g4)
    with pytest.raises(ValueError):
        tk.mp_matmul_wide(_on(g4, "cpu"), _on(g4, "cpu"))
    with pytest.raises(TypeError):
        tk.mp_matmul_wide(tmw.MPW(tmp.MP(w.limbs.double(), w.exp) for w in a.words), a)
    assert tk.LAUNCHES["mp_matmul_wide"] == 0


@pytest.mark.parametrize("Kd", [1, 2, 20, 57])
@pytest.mark.parametrize("Kg", [3, 5, 9])
def test_wide_kernel_matches_plain_version_at_edge_shapes(cuda, Kg, Kd, monkeypatch):
    """The two-pass wide GEMM bit for bit with its plain version on the
    card at M, N in {1, 15, 33} and a broadcast batch."""
    from sdpb_tpu_torch.ops import mpwide as tmw
    from torch_parity import small_wide_config

    if Kg == 3:
        monkeypatch.setattr(tmw, "wide_config", small_wide_config)
    rng = np.random.default_rng(600 + 10 * Kg + Kd)
    for M, N, B in ((1, 33, 2), (15, 1, 3), (33, 15, 1)):
        a = _wide_np(rng, (B, M, Kd), Kg)
        b = _wide_np(rng, (1, Kd, N), Kg)
        tk.reset_launches()
        out = tk.mp_matmul_wide(_on(a, cuda), _on(b, cuda))
        assert tk.LAUNCHES["mp_matmul_wide"] == 1
        a4, b4, unflatten = tk._canon_wide_pair(_on(a, cuda), _on(b, cuda))
        assert _same_wide(out, unflatten(tk.mp_matmul_wide_plain(a4, b4))), (M, N, B)


@pytest.mark.parametrize("Kg", [5, 9])
def test_wide_kernel_in_chunks_of_t(cuda, Kg, monkeypatch):
    """A term budget of 2.5 B M N terms: the kernel runs Kd = 7 in chunks
    of 2, 2, 2 and 1 values of t, the accumulator carried through the
    output between them, and the plain version in chunks of 1; bit for bit
    with each other and with the whole contraction in one chunk."""
    rng = np.random.default_rng(650 + Kg)
    B, M, Kd, N = 3, 5, 7, 4
    a, b = _wide_np(rng, (B, M, Kd), Kg), _wide_np(rng, (B, Kd, N), Kg)
    whole = tk.mp_matmul_wide(_on(a, cuda), _on(b, cuda))
    monkeypatch.setattr(tk, "WIDE_TERMS", 5 * B * M * N // 2)
    monkeypatch.setattr(tk, "WIDE_PLAIN_TERMS", B * M * N)
    assert tk.wide_chunk(B, M, Kd, N, tk.WIDE_TERMS) == 2
    tk.reset_launches()
    out = tk.mp_matmul_wide(_on(a, cuda), _on(b, cuda))
    assert tk.LAUNCHES["mp_matmul_wide"] == 1
    assert _same_wide(out, whole)
    assert _same_wide(out, tk.mp_matmul_wide_plain(_on(a, cuda), _on(b, cuda)))


@pytest.mark.parametrize("Kg", [3, 5, 9])
def test_wide_kernel_spill_case(cuda, Kg, monkeypatch):
    """The inputs of test_torch_wide_kernel.py::test_spill_case_against_mpmath
    (word-0 content spread wider than a word): kernel and plain version
    bit for bit on the card, and on the CPU."""
    import mpmath
    from sdpb_tpu_torch.ops import mpwide as tmw
    from torch_parity import mpf_to_f64_limbs, small_wide_config

    if Kg == 3:
        monkeypatch.setattr(tmw, "wide_config", small_wide_config)
    K = 2 * Kg
    with mpmath.workprec(24 * K + 200):
        va = [mpmath.mpf(3) / 7 + mpmath.mpf(5) / 11 * mpmath.mpf(2) ** -100]
        vb = [mpmath.mpf(1) / 3 + mpmath.mpf(2) ** -90 / 7]

    def wide(vals, shape):
        return tmw.wide_parts_to_mp(
            tmw.f64_limbs_to_wide_parts(mpf_to_f64_limbs(vals, shape, 24 * K), K), "cpu")

    a, b = wide(va, (1, 1, 1)), wide(vb, (1, 1))
    out = tk.mp_matmul_wide(_on(a, cuda), _on(b, cuda))
    assert _same_wide(out, tk.mp_matmul_wide(a, b))


@pytest.mark.parametrize("Kw", [10, 18])
def test_wide_elementwise_ops_agree_across_devices(cuda, Kw):
    rng = np.random.default_rng(320 + Kw)
    a = _wide(rng, (64,), Kw, decades=20)
    c = tmp.abs_(_wide(rng, (64,), Kw, decades=20))
    ops = {
        "add": lambda x, y: tmp.add(x, y),
        "mul": lambda x, y: tmp.mul(x, y),
        "div": lambda x, y: tmp.div(x, y),
        "rsqrt": lambda x, y: tmp.rsqrt(y),
        "sqrt": lambda x, y: tmp.sqrt(y),
        "sum": lambda x, y: tmp.sum_(x, axis=0),
        "round_to": lambda x, y: tmp.round_to(x, 7),
    }
    for name, f in ops.items():
        got, want = f(_on(a, cuda), _on(c, cuda)), f(a, c)
        if hasattr(want, "words"):
            assert _same_wide(got, want), name
        else:
            assert _same(got, want), name
    assert torch.equal(tmp.nearest_double(_on(a, cuda)).cpu(), tmp.nearest_double(a))


# ---------------------------------------------------------------------------
# The peak probe and the per-phase profiler


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_peak_probe_matches_plain_version(cuda, dtype):
    """The probe on the card bit for bit with its plain version on the card
    and on the CPU (every multiply and add rounded on its own), an odd
    element count (a partial last block) and the 512 x 512 tile."""
    from sdpb_tpu_torch.tools.profile_phases import PROBE_A, PROBE_B

    rng = np.random.default_rng(13)
    for shape, steps in (((1000,), 333), ((512, 512), 64), ((3,), 0)):
        x = torch.tensor(rng.uniform(0.5, 2.0, shape), dtype=dtype)
        tk.reset_launches()
        got = tk.peak_probe(x.to(cuda), steps, PROBE_A, PROBE_B)
        assert tk.LAUNCHES["peak_probe"] == 1
        assert got.dtype == dtype and got.device.type == "cuda"
        assert torch.equal(got, tk.peak_probe_plain(x.to(cuda), steps, PROBE_A, PROBE_B))
        assert torch.equal(got.cpu(), tk.peak_probe(x, steps, PROBE_A, PROBE_B))
    assert tk.LAUNCHES["peak_probe"] == 1


def test_peak_probe_raises_on_what_it_cannot_take(cuda):
    tk.reset_launches()
    with pytest.raises(TypeError):
        tk.peak_probe(torch.ones(8, dtype=torch.float16, device=cuda), 2, 1.0, 0.0)
    with pytest.raises(TypeError):
        tk.peak_probe(torch.ones(8, dtype=torch.int32, device=cuda), 2, 1.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        tk.peak_probe(torch.ones((8, 8), device=cuda).mT[::2], 2, 1.0, 0.0)
    with pytest.raises(ValueError):
        tk.peak_probe(torch.ones(8, device=cuda), -1, 1.0, 0.0)
    assert tk.LAUNCHES["peak_probe"] == 0


def test_profiler_runs_on_the_card(cuda, tmp_path, capsys):
    """The tool's main on the certificate on the card: every phase timed,
    the peak measured in float64 (classic limbs) by 6 probe launches, the
    card's name and power limit recorded."""
    import json
    from pathlib import Path

    from sdpb_tpu_torch.tools import profile_phases as tpp

    zip_ = Path(__file__).resolve().parents[1] / "fixtures" / "dim2_certificate" / "sdp.zip"
    out = tmp_path / "phases.json"
    tk.reset_launches()
    assert tpp.main(["--fixture", str(zip_), "--scaledLimbs", "0", "--reps", "1",
                     "--device", "cuda", "--json", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["platform"] == "cuda" and rec["card"] and rec["peak_dtype"] == "float64"
    assert rec["peak_gflops_measured"] > 1000
    assert tk.LAUNCHES["peak_probe"] == 6
    assert all(tk.LAUNCHES[tk.counter(n, False)] > 0 for n in tk.KERNEL_NAMES)
    assert all(r["ms"] > 0 and r["pct_of_peak"] is not None for r in rec["phases"][:-1])


# ---------------------------------------------------------------------------
# The chunked loop's CUDA graphs (solver/graphs.py)


def _certificate_on(device, scaled_limbs, max_iterations=7):
    """The certificate SDP (150 bits classic, K=3; scaled_limbs float32
    limbs otherwise) on a device, with its parameters."""
    from pathlib import Path

    from sdpb_tpu_torch.io.sdp_zip import read_sdp
    from sdpb_tpu_torch.models.sdp import build_device_sdp
    from sdpb_tpu_torch.solver.params import SolverParameters

    zip_ = Path(__file__).resolve().parents[1] / "fixtures" / "dim2_certificate" / "sdp.zip"
    host = read_sdp(zip_, 4 if scaled_limbs else 3)
    params = SolverParameters(precision=150 if not scaled_limbs else 24 * scaled_limbs - 8,
                              duality_gap_threshold="1e-12", primal_error_threshold="1e-12",
                              dual_error_threshold="1e-12", initial_matrix_scale_primal="1e2",
                              initial_matrix_scale_dual="1e2", max_iterations=max_iterations)
    return build_device_sdp(host, device, scaled_limbs), params


def _stat_bits(v):
    if isinstance(v, list):
        return tuple(_stat_bits(w) for w in v)
    if isinstance(v, tuple):
        return (np.asarray(v[0]).tobytes(), v[1])
    return v.tobytes() if isinstance(v, np.ndarray) else v


@pytest.mark.parametrize("scaled_limbs", [0, 5])
def test_graph_replays_match_the_eager_iteration(cuda, scaled_limbs):
    """The chunked loop's replays (chunks of 3, the stop inside the third)
    against the host loop's eager iterations on the card: every statistic,
    the reason, the count and the final state bit for bit."""
    from sdpb_tpu_torch.solver.solve import run_solver
    from sdpb_tpu_torch.solver.step import state_tensors

    sdp, params = _certificate_on(cuda, scaled_limbs)
    eager = run_solver(sdp, params, verbosity=0, chunk_iterations=1)
    graphed = run_solver(sdp, params, verbosity=0, chunk_iterations=3)
    assert graphed.graphs and all(g["nodes"][0] > 1000 for g in graphed.graphs.values())
    assert str(eager.terminate_reason) == str(graphed.terminate_reason)
    assert eager.iterations == graphed.iterations == 8
    assert len(eager.history) == len(graphed.history) == 8
    for x, y in zip(eager.history, graphed.history):
        for f in x._fields:
            assert _stat_bits(getattr(x, f)) == _stat_bits(getattr(y, f)), f
    assert all(torch.equal(a, b) for a, b in
               zip(state_tensors(eager.state), state_tensors(graphed.state)))


def test_heal_recaptures_on_the_card(cuda):
    """A KKT threshold no solve meets, the factor pinned at 2 of 3 limbs:
    the first chunk fails, the graphs are captured again at 3 limbs and the
    chunk replays from its start; every statistic and the state equal the
    host loop's on the card, which heals from the same iteration."""
    from sdpb_tpu_torch.solver.solve import run_solver
    from sdpb_tpu_torch.solver.step import state_tensors

    sdp, params = _certificate_on(cuda, 0, max_iterations=3)
    params.factor_limbs = 2
    params.kkt_residual_threshold = "1e-300"
    eager = run_solver(sdp, params, verbosity=0, chunk_iterations=1)
    graphed = run_solver(sdp, params, verbosity=0, chunk_iterations=3)
    assert sorted(graphed.graphs) == [2, 3]
    assert graphed.iterations == eager.iterations == 4
    assert len(graphed.history) == len(eager.history) == 5
    for x, y in zip(eager.history, graphed.history):
        for f in x._fields:
            assert _stat_bits(getattr(x, f)) == _stat_bits(getattr(y, f)), f
    assert all(torch.equal(a, b) for a, b in
               zip(state_tensors(eager.state), state_tensors(graphed.state)))


@pytest.mark.parametrize("scaled_limbs", [0, 5])
def test_resume_from_file_equals_resume_from_memory(cuda, scaled_limbs, tmp_path):
    """A checkpoint of the chunked loop's final state on the card loads
    back bit for bit, and 4 iterations resumed from it equal 4 resumed from
    the state in memory: every statistic, the reason and the state."""
    from sdpb_tpu_torch.solver.checkpoint import load_checkpoint, save_checkpoint
    from sdpb_tpu_torch.solver.solve import run_solver
    from sdpb_tpu_torch.solver.step import state_tensors

    sdp, params = _certificate_on(cuda, scaled_limbs, max_iterations=4)
    first = run_solver(sdp, params, verbosity=0)
    save_checkpoint(tmp_path, sdp, first.state, verbosity=0)
    loaded = load_checkpoint(tmp_path, sdp, verbosity=0)
    assert all(torch.equal(a, b) for a, b in
               zip(state_tensors(loaded), state_tensors(first.state)))
    from_file = run_solver(sdp, params, verbosity=0, initial=loaded)
    from_memory = run_solver(sdp, params, verbosity=0, initial=first.state)
    assert str(from_file.terminate_reason) == str(from_memory.terminate_reason)
    assert len(from_file.history) == len(from_memory.history) == 5
    for x, y in zip(from_file.history, from_memory.history):
        for f in x._fields:
            assert _stat_bits(getattr(x, f)) == _stat_bits(getattr(y, f)), f
    assert all(torch.equal(a, b) for a, b in
               zip(state_tensors(from_file.state), state_tensors(from_memory.state)))


def _runner(cuda):
    """A chunk runner of 4 iterations on the classic certificate."""
    from sdpb_tpu_torch.solver import graphs, solve, state, step
    from sdpb_tpu_torch.utils.strings import str_to_limbs

    sdp, params = _certificate_on(cuda, 0)
    parse = lambda s: str_to_limbs(s, sdp.b.K)
    st = state.initial_state(sdp, parse("1e2"), parse("1e2"))
    cfg = step.StepConfig(
        total_psd_rows=sdp.total_psd_rows, gamma=0.7, feasible_beta_limbs=parse("0.1"),
        infeasible_beta_limbs=parse("0.3"), primal_error_threshold=1e-30,
        dual_error_threshold=1e-30, max_complementarity=1e100,
        factor_limbs=solve.initial_factor_limbs(params, sdp.b.K)[0],
        duality_gap_threshold_limbs=parse("1e-30"))
    return graphs.ChunkRunner(sdp, cfg, st, step.CARRY_START, 4, 100)


def test_replays_count_the_captured_launches(cuda):
    """LAUNCHES after n replays is n times the launches the capture
    recorded (and the capture itself adds none)."""
    tk.reset_launches()
    runner = _runner(cuda)
    warm = dict(tk.LAUNCHES)        # the eager warm-up iteration's
    per = runner.launches
    assert all(per[tk.counter(n, False)] > 0 for n in tk.KERNEL_NAMES), per
    assert warm == per
    runner.run()
    runner.run()
    assert runner.replays == 4
    assert tk.LAUNCHES == {k: warm[k] + 8 * per[k] for k in tk.LAUNCHES}
    runner.close()


def test_a_failed_capture_raises(cuda, monkeypatch):
    """A host read inside the captured iteration fails the capture, which
    raises; nothing falls back to the eager loop."""
    from sdpb_tpu_torch.solver import step

    real = step._stats_finite

    def reads_back(stats):
        ok = real(stats)
        bool(ok)                    # a device-to-host sync
        return ok

    monkeypatch.setattr(step, "_stats_finite", reads_back)
    with pytest.raises(RuntimeError, match="CUDA graph capture of the iteration failed"):
        _runner(cuda)


# ---------------------------------------------------------------------------
# Three words: the GEMM and the elementwise sum and product


def _wide3(rng, shape, Kg, spread=20):
    """A random three-word MPW of Kg-limb words (CPU): float64 limb stacks
    with fresh bits in every limb, staged exactly."""
    from sdpb_tpu_torch.ops import mpwide as tmw
    l64 = rand_limbs(rng, shape, -(-(72 * Kg) // 53) + 3)
    l64 *= 2.0 ** rng.integers(-spread, spread + 1, shape)
    return tmw.wide_parts_to_mp(tmw.f64_limbs_to_wide_parts(l64, 3 * Kg), "cpu")


@pytest.fixture
def three_words(monkeypatch):
    """Three words for any limb count (Kg = 3 is a test size)."""
    from sdpb_tpu_torch.ops import mpwide as tmw
    monkeypatch.setattr(tmw, "wide_config", lambda K: (3, -(-K // 3)))


@pytest.mark.parametrize("Kd", [1, 3, 5, 8, 20, 40, 57])
@pytest.mark.parametrize("Kg", [3, 7, 8, 9])
def test_wide3_kernel_matches_plain_version(cuda, three_words, Kg, Kd, monkeypatch):
    """The three-word GEMM bit for bit with its plain version on the card
    and on the CPU at M, N in {1, 15} and a broadcast batch, and at B = 1
    with 35 outputs (a ragged last block of the kernel's 32); the chunk of
    the word size (39, 7, 5, 4 at Kg = 3, 7, 8, 9: Kd = 57 padded; Kd =
    chunk + 1 at 5, 8 and 40, one unpadded chunk at Kd = 3 and, at Kg = 8,
    at Kd = 5) and, at Kg = 3, a chunk of 4 in the plain
    version's passes of one chunk each."""
    rng = np.random.default_rng(700 + 10 * Kg + Kd)
    for M, N, B in ((1, 15, 2), (15, 1, 3), (5, 7, 1)):
        a, b = _wide3(rng, (B, M, Kd), Kg), _wide3(rng, (1, Kd, N), Kg)
        tk.reset_launches()
        out = tk.mp_matmul_wide(_on(a, cuda), _on(b, cuda))
        assert tk.LAUNCHES["mp_matmul_wide3"] == 1 and tk.LAUNCHES["mp_matmul_wide"] == 0
        a4, b4, unflatten = tk._canon_wide_pair(_on(a, cuda), _on(b, cuda))
        assert _same_wide(out, unflatten(tk.mp_matmul_wide3_plain(a4, b4)))
        assert _same_wide(out, tk.mp_matmul_wide(a, b))
    if Kg == 3:
        monkeypatch.setattr(tk, "wide3_chunk", lambda K: 4)
        monkeypatch.setattr(tk, "WIDE3_TERMS", 1)
        a, b = _wide3(rng, (2, 3, Kd), Kg), _wide3(rng, (2, Kd, 2), Kg)
        out = tk.mp_matmul_wide(_on(a, cuda), _on(b, cuda))
        assert _same_wide(out, tk.mp_matmul_wide(a, b))


@pytest.mark.parametrize("Kg", [3, 7, 8, 9])
def test_wide3_elementwise_kernels_match_plain_versions(cuda, three_words, Kg):
    """The three-word sum and product: one launch each, bit for bit with
    the plain versions on the card and on the CPU, 129 elements (one more
    than a block) and broadcast shapes; the
    Newton ops over them (division, sqrt) the same on card and CPU."""
    rng = np.random.default_rng(800 + Kg)
    for ash, bsh in (((129,), (129,)), ((4, 5), (5,))):
        a, b = _wide3(rng, ash, Kg), _wide3(rng, bsh, Kg)
        A, Bv = _on(a, cuda), _on(b, cuda)
        for op, plain, name in ((tk.mp_wide3_add, tk.mp_wide3_add_plain, "mp_wide3_add"),
                                (tk.mp_wide3_mul, tk.mp_wide3_mul_plain, "mp_wide3_mul")):
            tk.reset_launches()
            out = op(A, Bv)
            assert tk.LAUNCHES[name] == 1
            assert _same_wide(out, plain(A, Bv)) and _same_wide(out, op(a, b))
    pos = tmp.abs_(b)
    assert _same_wide(tmp.div(A, _on(pos, cuda)), tmp.div(a, pos))
    assert _same_wide(tmp.sqrt(_on(pos, cuda)), tmp.sqrt(pos))


@pytest.mark.parametrize("Kg", [7, 8, 9])
def test_wide3_sum_kernel_on_broadcast_and_ragged_operands(cuda, three_words, Kg):
    """The three-word sum kernel bit for bit with mp_wide3_add_plain on the
    card and on the CPU: a scalar with a matrix, a row and a column with a matrix, a batch
    of matrices with one matrix, and the ragged shapes 1, 35 and 129
    elements (blocks of 128 threads); operands spread over 2^-40..2^40,
    with exact cancellations and zero words among them."""
    rng = np.random.default_rng(830 + Kg)
    cases = (((), (5, 7)), ((1, 7), (5, 7)), ((5, 1), (5, 7)), ((3, 4, 6), (4, 6)),
             ((1,), (1,)), ((35,), (35,)), ((129,), (129,)))
    for ash, bsh in cases:
        a, b = _wide3(rng, ash, Kg, spread=40), _wide3(rng, bsh, Kg, spread=40)
        if ash == bsh:
            # exact cancellation in every other element, a zero middle word
            # in every third
            from sdpb_tpu_torch.ops import mpwide as tmw
            words = []
            for g, (wa, wb) in enumerate(zip(a.words, b.words)):
                limbs, exp = wb.limbs.clone(), wb.exp.clone()
                limbs[:, ::2], exp[::2] = -wa.limbs[:, ::2], wa.exp[::2]
                if g == 1:
                    limbs[:, ::3], exp[::3] = 0.0, tmp.EXP_ZERO
                words.append(tmp.MP(limbs, exp))
            b = tmw.MPW(words)
        A, Bv = _on(a, cuda), _on(b, cuda)
        for x, y in ((A, Bv), (Bv, A)):
            tk.reset_launches()
            out = tk.mp_wide3_add(x, y)
            assert tk.LAUNCHES["mp_wide3_add"] == 1
            assert _same_wide(out, tk.mp_wide3_add_plain(x, y)), (ash, bsh)
        assert _same_wide(tk.mp_wide3_add(A, Bv), tk.mp_wide3_add(a, b)), (ash, bsh)


def test_wide3_elementwise_kernels_refuse_two_words(cuda):
    """A two-word operand raises in the three-word kernels' wrappers."""
    rng = np.random.default_rng(810)
    a = _on(_wide(rng, (2, 2), 10), cuda)
    with pytest.raises(ValueError, match="G = 3"):
        tk.mp_wide3_add(a, a)


# ---------------------------------------------------------------------------
# A bootstrap study on the port alone (chip_smoke.py phase 18b)


def test_bootstrap_study_on_the_card(cuda, tmp_path, capsys):
    """The toy PMP of tests/test_spectrum.py through the port's sdp2input
    at 512 bits, solved on the card through the CLI (classic, 96 bits, the
    chunked loop), then the port's spectrum: one zero within 1e-5 of the
    independently computed x0, the solve's kernels launched."""
    import json

    import mpmath

    from sdpb_tpu_torch.cli import sdp2input, sdpb as cli, spectrum

    from test_spectrum import TOY_PMP

    (tmp_path / "toy.json").write_text(json.dumps(TOY_PMP))
    assert sdp2input.convert(tmp_path / "toy.json", tmp_path / "sdp.zip", 512, "json") == 1
    tk.reset_launches()
    res = cli.run(["-s", str(tmp_path / "sdp.zip"), "-o", str(tmp_path / "out"),
                   "-c", str(tmp_path / "ck"), "--precision", "96",
                   "--dualityGapThreshold", "1e-15", "--primalErrorThreshold", "1e-15",
                   "--dualErrorThreshold", "1e-15", "--initialMatrixScalePrimal", "1e2",
                   "--initialMatrixScaleDual", "1e2", "--maxIterations", "250",
                   "--verbosity", "0", "--writeSolution", "x,y"])
    assert str(res.terminate_reason) == "found primal-dual optimal solution"
    assert all(tk.LAUNCHES[tk.counter(n, False)] > 0 for n in tk.KERNEL_NAMES)
    assert spectrum.main(["--input", str(tmp_path / "toy.json"), "--solution",
                          str(tmp_path / "out"), "--precision", "96", "--threshold", "1e-8",
                          "--format", "PMP", "--output", str(tmp_path / "spectrum.json")]) == 0
    doc = json.loads((tmp_path / "spectrum.json").read_text())
    assert len(doc) == 1 and len(doc[0]["zeros"]) == 1
    with mpmath.workprec(200):
        zero = mpmath.mpf(doc[0]["zeros"][0]["zero"])
        assert abs(zero - mpmath.mpf("1.042496785718158120984007")) < mpmath.mpf("1e-5")
