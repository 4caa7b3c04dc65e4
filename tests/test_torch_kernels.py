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

from sdpb_tpu.ops import mplist as ml, pallas_kernels as pk
from sdpb_tpu_torch.ops import kernels as tk, mpfloat as tmp

from torch_parity import (J, T, limbs_of, parts_of, rand_limbs, rand_scaled, rel_err,
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


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("lower", [True, False])
def test_trsm_plain_column_by_column_is_the_whole_solve(scaled, lower):
    """Each column of X = T^{-1} B depends on T and its own column of B
    alone: the plain solve run one column at a time (m = 1) gives the whole
    solve's bits, limbs and exponents: the columns may be solved in any
    grouping, as the kernel deals the entries of a pivot to its threads."""
    rng = np.random.default_rng(70 + 2 * scaled + lower)
    K, B, n, m = 3, 2, 7, 4
    if scaled:
        L = tk.mp_cholesky(T(_spd_scaled(rng, B, n, K, decades=4.0)))
        Bm = T(rand_scaled(rng, (B, n, m), K, decades=4.0))
    else:
        L = tk.mp_cholesky(T(_spd(rng, B, n, K)))
        Bm = T(rand_limbs(rng, (B, n, m), K))
    t = L if lower else tmp.MP(L.limbs.mT.contiguous(),
                               None if L.exp is None else L.exp.mT.contiguous())
    whole = tk.mp_solve_triangular_plain(t, Bm, lower)
    cols = [tk.mp_solve_triangular_plain(t, Bm[..., c:c + 1], lower) for c in range(m)]
    assert torch.equal(whole.limbs, torch.cat([c.limbs for c in cols], -1))
    if scaled:
        assert torch.equal(whole.exp, torch.cat([c.exp for c in cols], -1))


def test_dispatch_is_by_device_without_fallback():
    """CPU operands run the plain version and launch nothing; operands on
    any other non-CUDA device, or split across devices, raise."""
    rng = np.random.default_rng(1)
    a = T(rand_limbs(rng, (2, 3, 3), 2))
    tk.reset_launches()
    tk.mp_matmul(a, a)
    tk.mp_cholesky(tmp.MP(torch.as_tensor(_spd(rng, 2, 3, 2))))
    tk.mp_solve_triangular(a, a)
    tk.peak_probe(a.limbs, 3, 1.0000001, 1e-7)
    assert tk.LAUNCHES == {"mp_matmul": 0, "mp_cholesky": 0,
                           "mp_solve_triangular": 0, "mp_matmul_scaled": 0,
                           "mp_cholesky_scaled": 0, "mp_solve_triangular_scaled": 0,
                           "mp_matmul_wide": 0, "mp_matmul_wide3": 0, "mp_wide3_add": 0,
                           "mp_wide3_mul": 0, "peak_probe": 0}
    meta = tmp.MP(torch.empty((2, 2, 3, 3), dtype=torch.float64, device="meta"))
    for call in (lambda: tk.mp_matmul(meta, meta), lambda: tk.mp_cholesky(meta),
                 lambda: tk.mp_solve_triangular(meta, meta),
                 lambda: tk.mp_matmul(a, meta),
                 lambda: tk.peak_probe(meta.limbs, 3, 1.0000001, 1e-7)):
        with pytest.raises(ValueError):
            call()


def test_library_names_follow_source_hash():
    paths = {tk.library_path(K) for K in tk.K_RANGE}
    assert len(paths) == len(tk.K_RANGE)
    assert all(p.parent == tk.BUILD_DIR for p in paths)
    assert {p.name for p in tk.CSRC.iterdir()} >= {"mp.cuh", *tk.SOURCES}


def _chunk_sum(products, per_lane):
    """The tree sum of one chunk's 8 products as the GEMM kernel takes it:
    each of 8 / per_lane lanes folds its per_lane products in order, the
    pending left operand of each level held until its right neighbour comes;
    then the lanes are folded by levels, lane l + d the right operand of
    lane l.  Any split gives ((p0+p1)+(p2+p3)) + ((p4+p5)+(p6+p7))."""
    lanes = []
    for lane in range(8 // per_lane):
        held = {}
        for u in range(per_lane):
            v = products[lane * per_lane + u]
            level = 0
            while (u >> level) & 1:
                v = tmp.add(held.pop(level), v)
                level += 1
            held[level] = v
        lanes.append(v)
    d = 1
    while d < len(lanes):
        for lane in range(0, len(lanes), 2 * d):
            lanes[lane] = tmp.add(lanes[lane], lanes[lane + d])
        d *= 2
    return lanes[0]


@pytest.mark.parametrize("per_lane", [1, 2, 4, 8])
@pytest.mark.parametrize("Kd", [1, 8, 9, 20, 57])
@pytest.mark.parametrize("scaled", [False, True])
def test_matmul_plain_chunk_sums_then_accumulate_is_the_one_pass(scaled, Kd, per_lane):
    """The GEMM kernel's order: every chunk's tree sum on its own (products
    split over lanes, per_lane products a lane), then the chunk sums added
    into a zero accumulator in chunk order: the bits of mp_matmul_plain,
    which folds each chunk into the accumulator as soon as it is summed.
    Zero-padded past Kd, exact zeros among the scaled operands."""
    rng = np.random.default_rng(80 + Kd + 100 * scaled + 1000 * per_lane)
    K, B, M, N = 3, 2, 3, 2
    if scaled:
        a, b = rand_scaled(rng, (B, M, Kd), K, decades=6.0), rand_scaled(rng, (B, Kd, N), K, decades=6.0)
        a[0][:, 0, 0, :3] = 0.0
        a[1][0, 0, :3] = tmp.EXP_ZERO
        a, b = T(a), T(b)
    else:
        a, b = T(rand_limbs(rng, (B, M, Kd), K)), T(rand_limbs(rng, (B, Kd, N), K))
    pad = (-Kd) % 8
    ap, bp = tmp.pad_dim(a, 2, pad), tmp.pad_dim(b, 1, pad)
    acc = tmp.zeros((B, M, N), K, "cpu", scaled=scaled)
    for c in range((Kd + pad) // 8):
        products = [tmp.kmul(tmp.expand_dims(ap[..., t], -1), tmp.expand_dims(bp[..., t, :], -2))
                    for t in range(8 * c, 8 * c + 8)]
        acc = tmp.add(acc, _chunk_sum(products, per_lane))
    want = tk.mp_matmul_plain(a, b)
    assert torch.equal(acc.limbs, want.limbs)
    if scaled:
        assert torch.equal(acc.exp, want.exp)


def _cholesky_lookahead(a):
    """The Cholesky kernel's order: the pivot chain computes r_j, then looks
    ahead (L[j+1,j] = W[j+1,j] r_j, W[j+1,j+1] -= L[j+1,j]^2, r_{j+1});
    the workers scale column j, then update column j+1 below the diagonal
    and W[j+2,j+2] first, the rest of the trailing block after."""
    n = a.shape[-1]
    E = Ellipsis
    W = tmp.MP(a.limbs.clone(), None if a.exp is None else a.exp.clone())
    L = tmp.zeros(a.shape, a.K, "cpu", scaled=a.scaled)
    r = tmp.rsqrt(W[E, 0, 0], kernel_order=True)
    for j in range(n):
        tmp.set_block(L, (E, j, j), tmp.kmul(W[E, j, j], r))
        if j + 1 == n:
            break
        col = tmp.kmul(W[E, j + 1:, j], tmp.expand_dims(r, -1))      # L[j+1:, j]
        tmp.set_block(L, (E, slice(j + 1, None), j), col)
        # the chain
        l1 = col[E, 0]
        tmp.set_block(W, (E, j + 1, j + 1), tmp.sub(W[E, j + 1, j + 1], tmp.kmul(l1, l1)))
        r_next = tmp.rsqrt(W[E, j + 1, j + 1], kernel_order=True)
        # the workers
        if j + 2 < n:
            below = col[E, 1:]                                          # L[j+2:, j]
            rows = (E, slice(j + 2, None), j + 1)
            tmp.set_block(W, rows, tmp.sub(W[rows], tmp.kmul(below, tmp.expand_dims(l1, -1))))
            tmp.set_block(W, (E, j + 2, j + 2),
                          tmp.sub(W[E, j + 2, j + 2], tmp.kmul(below[E, 0], below[E, 0])))
            first = W[E, j + 2, j + 2]
            first = tmp.MP(first.limbs.clone(), None if first.exp is None else first.exp.clone())
            trail = (E, slice(j + 2, None), slice(j + 2, None))
            upd = tmp.kmul(tmp.expand_dims(below, -1), tmp.expand_dims(below, -2))
            tmp.set_block(W, trail, tmp.sub(W[trail], upd))
            tmp.set_block(W, (E, j + 2, j + 2), first)                 # updated once, above
        r = r_next
    return L


@pytest.mark.parametrize("n", [1, 2, 7, 20])
@pytest.mark.parametrize("scaled", [False, True])
def test_cholesky_plain_lookahead_is_the_same_factor(scaled, n):
    """The look-ahead order of the Cholesky kernel (pivot j+1's diagonal
    updated and its rsqrt started before the rest of pivot j's trailing
    update) gives the bits of mp_cholesky_plain: every entry still takes its
    updates in pivot order."""
    rng = np.random.default_rng(90 + n + 100 * scaled)
    K = 3
    A = T(_spd_scaled(rng, 2, n, K, decades=4.0)) if scaled else T(_spd(rng, 2, n, K))
    L, want = _cholesky_lookahead(A), tk.mp_cholesky_plain(A)
    assert torch.equal(L.limbs, want.limbs)
    if scaled:
        assert torch.equal(L.exp, want.exp)


def test_shape_tally_counts_the_factor():
    """chip_smoke.py's tally of the wrappers' calls by shape (the per-
    iteration device time of phases 6, 9 and 11 and tools/kernel_times.py)
    counts the factor beside the GEMM and the solve, and leaves the
    wrappers as they were."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rng = np.random.default_rng(5)
    A = T(_spd(rng, 2, 4, 2))
    B = T(rand_limbs(rng, (2, 4, 3), 2))
    wrappers = (tk.mp_matmul, tk.mp_cholesky, tk.mp_solve_triangular)
    with cs._shape_tally(tk) as tally:
        L = tk.mp_cholesky(A)
        tk.mp_cholesky(A)
        tk.mp_matmul(A, B)
        tk.mp_solve_triangular(L, B, lower=False)
    assert (tk.mp_matmul, tk.mp_cholesky, tk.mp_solve_triangular) == wrappers
    assert tally == {("mp_cholesky", "classic", 2, (2, 4, 4), (), None): 2,
                     ("mp_matmul", "classic", 2, (2, 4, 4), (2, 4, 3), None): 1,
                     ("mp_solve_triangular", "classic", 2, (2, 4, 4), (2, 4, 3), False): 1}
    assert cs._call_label(("mp_cholesky", "scaled", 8, (120, 57, 57), (), None)) == \
        "mp_cholesky scaled K=8 [120, 57, 57]"


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("n", [2, 3, 4, 6])
def test_plain_blocks_take_first_last_and_interior_blocks(n):
    """chip_smoke.plain_blocks, the blocks of a batch whose plain version
    runs in the background: the first and the last, n - 2 distinct ones
    between them spread over the batch, sorted; every block of a batch of
    n or fewer."""
    cs = _chip_smoke()
    assert cs.plain_blocks(120) == [0, 40, 79, 119]
    for B in range(1, 300):
        got = cs.plain_blocks(B, n)
        if B <= n:
            assert got == list(range(B))
            continue
        assert len(got) == n and got == sorted(set(got))
        assert got[0] == 0 and got[-1] == B - 1
        # each gap within one of the even spacing (B - 1) / (n - 1)
        gaps = np.diff(got)
        assert gaps.min() >= np.floor((B - 1) / (n - 1)) and \
            gaps.max() <= np.ceil((B - 1) / (n - 1))


def test_background_plain_blocks_are_the_full_batch_blocks():
    """chip_smoke.py's background tasks run a plain version on some blocks
    of a batch and hold the kernel's same blocks to it: every plain version
    works block by block, so those blocks are the full batch's.  The
    classic GEMM, factor and upper solve (_kernel_task's rows at K = 2,
    kernel_phase's operands cut to 20 blocks of n = 6) and a three-word sum
    and GEMM (_wide_task, Kg = 3)."""
    from sdpb_tpu_torch.ops import mpwide as tmw
    cs = _chip_smoke()
    full = cs._kernel_inputs

    def cut(scaled, K=None):
        Kg, Kf, decades, mant, gemms, spd, rhs = full(scaled, K)
        gemms = [(s, a[:, :20, :2, :3], b[:, :20, :3, :2]) for s, a, b in gemms]
        return (Kg, Kf, decades, mant, gemms,
                {n: A[:, :20, :6, :6] for n, A in spd.items()}, rhs[:, :20, :6, :3])

    cs._kernel_inputs = cut
    blocks = [0, 3, 19]
    out = cs._kernel_task(2, blocks)
    _, _, _, _, gemms, spd, rhs = cut(False, 2)
    G = tk.mp_matmul_plain(tmp.MP(torch.as_tensor(gemms[1][1])),
                           tmp.MP(torch.as_tensor(gemms[1][2])))
    assert torch.equal(cs._value(out[1][0]).limbs, cs._blocks_of(G, blocks).limbs)
    L = tk.mp_cholesky_plain(tmp.MP(torch.as_tensor(spd[20])))
    assert torch.equal(cs._value(out[3][0]).limbs, cs._blocks_of(L, blocks).limbs)
    L = tk.mp_cholesky_plain(tmp.MP(torch.as_tensor(spd[57])))
    X = tk.mp_solve_triangular_plain(tmp.MP(L.limbs.mT.contiguous()),
                                     tmp.MP(torch.as_tensor(rhs)), False)
    assert torch.equal(cs._value(out[5][0]).limbs, cs._blocks_of(X, blocks).limbs)
    wide_config = tmw.wide_config
    tmw.wide_config = lambda K: (3, -(-K // 3))
    try:
        for op, ash, bsh in (("add", (6, 2, 3), (6, 2, 3)), ("gemm", (6, 2, 5), (6, 5, 3))):
            a, b, got, _, _ = cs._wide_task(op, 3, 3, ash, bsh, 9, [1, 5])
            a, b = cs._value(a), cs._value(b)
            full_out = tk.mp_wide3_add_plain(a, b) if op == "add" else tk.mp_matmul_wide(a, b)
            want = cs._blocks_of(full_out, [1, 5])
            assert all(torch.equal(x.limbs, y.limbs) and torch.equal(x.exp, y.exp)
                       for x, y in zip(cs._value(got).words, want.words))
    finally:
        tmw.wide_config = wide_config


def _ml(parts, K):
    """Scaled parts as a list-form value of the JAX package (mplist)."""
    return [jnp.asarray(parts[0][k]) for k in range(K)], jnp.asarray(parts[1])


def _scaled_mpf(limbs, exp, idx):
    import mpmath
    return (mpmath.fsum(mpmath.mpf(float(x)) for x in limbs[(slice(None),) + idx])
            * mpmath.mpf(2) ** int(exp[idx]))


@pytest.mark.parametrize("K", [8, 9])
def test_scaled_product_drops_a_limb_far_below_its_slot(K):
    """The scaled product prescales limb i by 2^(24 i - CENTER + 15)
    (mplist.mul; mpfloat.MUL_UNIFORM_EXP) before its TwoProds, so a second
    limb that lies ~190 bits below the first falls below float32's range
    and drops out: (1/2) (1 - 2^-190) comes out as 1/2, in the JAX
    package's list-form product (which the Pallas kernels run) and in the
    port's alike; 1 - 2^-100 keeps its second limb in both."""
    half = tmp.from_double(0.5, K, "cpu", scaled=True)
    one = tmp.from_double(1.0, K, "cpu", scaled=True)
    for t, dropped in ((190, True), (100, False)):
        x = tmp.sub(one, tmp.from_double(2.0 ** -t, K, "cpu", scaled=True))
        port = tmp.kmul(half, x)
        ref = ml.mul(_ml(parts_of(half), K), _ml(parts_of(x), K), K)
        ref = (np.stack([np.asarray(v) for v in ref[0]]), np.array(ref[1]))
        assert same_scaled(port, half) == dropped, t
        assert same_scaled(tmp.MP(torch.from_numpy(ref[0]), torch.from_numpy(ref[1])),
                           half) == dropped, t


def test_scaled_rsqrt_and_factor_stall_near_2_pow_minus_188(monkeypatch):
    """Why the scaled factor reconstructs A to ~2^-188 at Kf = 8 and 9
    alike, where 24 Kf bits would give ~2^-206 at Kf = 9 (chip_smoke.py
    phase 10 holds Kf = 9 to phase 7's Kf = 8 bound, 2^-182): at rsqrt's
    Newton fixed point a r^2 = 1 - d with |d| ~ 2^-190, and the product
    (1/2) (a r^2) drops d (the test above), so r stops improving near
    2^-188.  mplist.rsqrt, the rsqrt the Pallas factor runs at every pivot,
    stalls there as well (its bits differ from the port's on the CPU,
    where XLA also flushes subnormals); the port's plain factor at Kf = 9
    reconstructs A (mpmath) to within 2^-182, and not to 2^-200."""
    import mpmath
    K, n = 9, 15
    rng = np.random.default_rng(909)
    a = rand_scaled(rng, (16,), K, decades=3.0, positive=True)
    ref = ml.rsqrt(_ml(a, K), K)
    ref = (np.stack([np.asarray(v) for v in ref[0]]), np.array(ref[1]))
    monkeypatch.setattr(tmp, "inv_sqrt", lambda m: torch.from_numpy(
        np.array(jax.lax.rsqrt(jnp.asarray(m.numpy())))))
    port = parts_of(tmp.rsqrt(T(a), kernel_order=True))
    monkeypatch.undo()
    with mpmath.workprec(24 * K + 80):
        for limbs, exp in (ref, port):
            worst = max(abs(_scaled_mpf(limbs, exp, (i,)) * mpmath.sqrt(
                _scaled_mpf(*a, (i,))) - 1) for i in range(16))
            assert mpmath.mpf(2) ** -200 < worst < mpmath.mpf(2) ** -182
        A = _spd_scaled(rng, 1, n, K, decades=3.0)
        L = parts_of(tk.mp_cholesky(T(A)))
        worst = mpmath.mpf(0)
        for i in range(n):
            for j in range(i + 1):
                rec = mpmath.fsum(_scaled_mpf(*L, (0, i, t)) * _scaled_mpf(*L, (0, j, t))
                                  for t in range(j + 1))
                scale = mpmath.sqrt(_scaled_mpf(*A, (0, i, i)) * _scaled_mpf(*A, (0, j, j)))
                worst = max(worst, abs(rec - _scaled_mpf(*A, (0, i, j))) / scale)
        assert mpmath.mpf(2) ** -200 < worst < mpmath.mpf(2) ** -182


def _kernel_product(a, b):
    """The classic MP product as csrc/mp.cuh runs it where
    wavefront_product holds (K >= 11: mpk::mul_sweeps, compact), one lane
    per element: the K sweeps as a skewed wavefront (wave_step: at step t
    sweep k works on row M-1-t+k, M = K^2+1), each term made from the limbs
    where sweep 0 reads it, the rows walked from the last (the chained
    tail; then by diagonal n from K-1 down, its products i = n..0, then the
    errors of diagonal n-1 it lists, i = n-1..0), sweep K-1's residue rows
    chain-summed as they leave it."""
    K = a.K
    al, bl = list(a.limbs.unbind(0)), list(b.limbs.unbind(0))

    def two_sum(x, y):
        s = x + y
        v = s - x
        return s, (x - (s - v)) + (y - v)

    def hi(x):
        t = 134217728.0 * x + x
        return t - (t - x)

    ah, bh = [hi(x) for x in al], [hi(x) for x in bl]

    def prod(i, j):
        return al[i] * bl[j]

    def err(i, j):
        p = al[i] * bl[j]
        xl, yl = al[i] - ah[i], bl[j] - bh[j]
        return ((ah[i] * bh[j] - p) + ah[i] * yl + xl * bh[j]) + xl * yl

    M = K * K + 1
    c, v = [None] * K, [None] * K

    def step(t, row, edge):
        out = None
        for k in range(K - 1, -1, -1):
            xin = row if k == 0 else v[k]
            if edge and (t < 2 * k or t > M - 1 + k):
                continue
            if edge and t == 2 * k:
                c[k] = xin
                continue
            c[k], e = two_sum(xin, c[k])
            if k < K - 1:
                v[k + 1] = e
            else:
                out = e
        return out

    tail = al[1] * bl[K - 1]
    for i in range(2, K):
        tail = tail + al[i] * bl[K - i]
    for t in range(2 * K - 1):
        step(t, tail if t == 0 else prod(K - t, t - 1) if t <= K
             else err(2 * K - 1 - t, t - K - 1), True)
    chain = step(0, err(0, K - 2), False)
    for n in range(K - 2, -1, -1):
        for i in range(n, -1, -1):
            chain = chain + step(0, prod(i, n - i), False)
        for i in range(n - 1, -1, -1):
            chain = chain + step(0, err(i, n - 1 - i), False)
    for t in range(M, M + K - 1):
        chain = chain + step(t, torch.zeros_like(chain), True)
    xs = c + [chain]
    for i in range(K):
        s = xs[i] + xs[i + 1]
        xs[i], xs[i + 1] = s, xs[i + 1] - (s - xs[i])
    for i in range(K - 1, 0, -1):
        s = xs[i - 1] + xs[i]
        xs[i - 1], xs[i] = s, xs[i] - (s - xs[i - 1])
    return tmp.MP(torch.stack(xs[:K]))


@pytest.mark.parametrize("K", [2, 5, 11, 12, 13])
def test_kernel_product_schedule_is_the_plain_product(K):
    """The CUDA kernels' wavefront MP product (_kernel_product: the sweeps
    as a skewed wavefront over terms made where they are read; the kernels
    build it at classic K >= 11, the schedule holds at every K) gives the
    bits of the plain product mpfloat.kmul (renorm's sweeps over the stored
    term list): on ladders of fresh limbs, on limbs of any magnitude in any
    order, with exact zeros and with b = -a."""
    rng = np.random.default_rng(700 + K)
    n = 96
    a, b = rand_limbs(rng, (n,), K), rand_limbs(rng, (n,), K)
    a[:, 32:64] = rng.standard_normal((K, 32)) * np.exp2(rng.integers(-80, 80, (K, 32)))
    a[:, :8] = 0.0
    b[:, 8:16] = -a[:, 8:16]
    a, b = T(a), T(b)
    got, want = _kernel_product(a, b), tmp.kmul(a, b)
    assert torch.equal(got.limbs.view(torch.int64), want.limbs.view(torch.int64))


def test_sum_need_counts_the_plain_sums_word_two_sums():
    """tools/kernel_times.py's sum_need (--ladder-sums): over the first
    `elements` elements of each sum, broadcast operands counted at the
    broadcast shape, the word TwoSums with work per element are the 20 of
    renormalize<6> less those the plain version's SkipTally counts as left
    as they were; per warp (the last one partial) a walk of each element's
    own list runs no more than renormalize's order."""
    from sdpb_tpu_torch.ops import mpwide_kernel as wk
    from sdpb_tpu_torch.tools import kernel_times as kt
    cs = _chip_smoke()
    rng = np.random.default_rng(41)
    a, b = (cs._wide_operand(rng, (2, 5, 7), 9, 2.0, G=3) for _ in range(2))
    c = cs._wide_operand(rng, (7,), 9, 2.0, G=3)
    out = kt.sum_need(torch, tk, [(a, b), (a, c)], elements=40)
    skipped = 0
    for x, y in ((a, b), (a, c)):
        words = [[(l.reshape(l.shape[0], -1)[:, :40], e.reshape(-1)[:40])
                  for l, e in tk._wide3_words(v, (2, 5, 7))] for v in (x, y)]
        tally = wk.SkipTally()
        wk.wadd_g_c(*words, 9, tally.skip())
        skipped += tally.count
    assert out["elements_sampled"] == 80 and len(out["need_by_site"]) == 20
    assert out["two_sums_per_element"] == pytest.approx(20 - skipped / 80)
    assert 0 < out["two_sums_per_warp_walk"] <= out["two_sums_per_warp_renormalize"] <= 20


def test_captured_returns_what_a_task_printed():
    """chip_smoke._captured, the wrapper of a pool task whose prints the
    phase that waits for it shows: (what it printed, its result)."""
    cs = _chip_smoke()
    assert cs._captured(lambda x: print("built", x) or x + 1, 2) == ("built 2\n", 3)


@pytest.mark.parametrize("K", [10, 11, 12, 13])
def test_classic_product_and_matmul_plain_against_mpmath(K):
    """At the classic limb counts of --precision 531-681, the plain product
    (mpfloat.kmul, the kernels' order) and mp_matmul_plain against mpmath
    on seeded inputs whose limbs all carry fresh bits.  The truncated
    product drops the limb products a_i b_j with i + j > K and the errors
    of those with i + j = K; with |a_i| < 2^-53i |a_0| they add up to less
    than K^2 2^-53(K+1) |a_0 b_0|, and the K result limbs round the rest at
    about 2^-53K: |r - a b| <= 2^-(53K-3) |a_0 b_0| (these inputs reach
    2^-(53K+1.2)).  A GEMM output adds
    the Kd products and Kd - 1 sums of such errors: |r - sum a_t b_t| <=
    2^-(53K-10) sum |a_t b_t| (chip_smoke.py's spot check)."""
    import mpmath
    rng = np.random.default_rng(1000 + K)
    n = 24
    a, b = rand_limbs(rng, (n,), K), rand_limbs(rng, (n,), K)
    r = limbs_of(tmp.kmul(T(a), T(b)))
    Bb, Mm, Kd, Nn = 2, 2, 11, 2
    x, y = rand_limbs(rng, (Bb, Mm, Kd), K), rand_limbs(rng, (Bb, Kd, Nn), K)
    g = limbs_of(tk.mp_matmul_plain(T(x), T(y)))

    def val(limbs, idx):
        return mpmath.fsum(mpmath.mpf(float(v)) for v in limbs[(slice(None),) + idx])

    with mpmath.workprec(53 * K + 120):
        worst = max(abs(val(r, (i,)) - val(a, (i,)) * val(b, (i,)))
                    / abs(mpmath.mpf(float(a[0, i])) * float(b[0, i])) for i in range(n))
        assert worst <= mpmath.mpf(2) ** -(53 * K - 3), float(mpmath.log(worst, 2))
        worst = mpmath.mpf(0)
        for bi in range(Bb):
            for mi in range(Mm):
                for ni in range(Nn):
                    terms = [val(x, (bi, mi, t)) * val(y, (bi, t, ni)) for t in range(Kd)]
                    worst = max(worst, abs(val(g, (bi, mi, ni)) - mpmath.fsum(terms))
                                / mpmath.fsum(abs(t) for t in terms))
        assert worst <= mpmath.mpf(2) ** -(53 * K - 10), float(mpmath.log(worst, 2))
