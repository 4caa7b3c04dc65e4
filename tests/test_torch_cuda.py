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


@pytest.mark.parametrize("K", list(range(2, 10)))
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
                           "mp_matmul_wide": 0}
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
    ten = tmp.MP(torch.zeros((10, 1, 3, 3), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        tk.mp_cholesky(ten)
    with pytest.raises(ValueError):
        tk.mp_matmul(tmp.MP(ten.limbs[:2]), tmp.MP(ten.limbs[:2].cpu()))


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
# The wide (two-word) GEMM and the wide elementwise ops


def _wide(rng, shape, K, decades=3):
    """A random MPW of K = 2 Kg limbs (CPU) with content in both words."""
    from sdpb_tpu_torch.ops import mpwide as tmw
    from torch_parity import mpf_to_f64_limbs, rand_wide_vals

    n = int(np.prod(shape))
    vals = rand_wide_vals(rng, n, 24 * K, decades)
    return tmw.wide_parts_to_mp(
        tmw.f64_limbs_to_wide_parts(mpf_to_f64_limbs(vals, shape, 24 * K), K), "cpu")


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
    """G = 3 raises on the card (and on the CPU); a wide operand never runs
    the plain version on the card."""
    from sdpb_tpu_torch.ops import mpwide as tmw

    rng = np.random.default_rng(310)
    a = _on(_wide(rng, (2, 2), 10), cuda)
    g3 = tmw.MPW(a.words + a.words[:1])
    tk.reset_launches()
    with pytest.raises(ValueError, match="G = 2"):
        tk.mp_matmul_wide(g3, g3)
    with pytest.raises(ValueError):
        tk.mp_matmul_wide(_on(g3, "cpu"), _on(g3, "cpu"))
    with pytest.raises(TypeError):
        tk.mp_matmul_wide(tmw.MPW(tmp.MP(w.limbs.double(), w.exp) for w in a.words), a)
    assert tk.LAUNCHES["mp_matmul_wide"] == 0


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
