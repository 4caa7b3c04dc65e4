"""The three-word slice of the port on the CPU: the three-word GEMM's plain
version (kernels.mp_matmul_wide3_plain, the kernel's order) against the
JAX package's composite (sdpb_tpu/ops/linalg.py:32-74, run op by op) and
mpmath; checkpoint files of three-word states; the precision limits of the
CLIs.  tests/test_torch_wide3_iteration.py runs the iteration and a
resume, tests/test_torch_wide3_cli.py the CLI.

Both packages' wide_config is widened to three words of Kg = 3 limbs
(PREC = 216 bits) where the JAX package is run (its eager three-word
arithmetic is slow and maps memory without bound, see
tests/test_torch_mpwide3.py); the port alone also runs at Kg = 9.

Tolerances:
  * the GEMM against mpmath: within 2^-(PREC-26) of the sum of the terms'
    magnitudes (tests/test_torch_wide_kernel.py's bound); against the JAX
    composite within the same bound wherever the composite meets it (the
    JAX package's three-word product misses mpmath on dense words,
    tests/test_torch_mpwide3.py).  The plain version follows the
    composite's order (the products, the halving tree over each chunk of 4,
    the chunks added in order into a zero accumulator, the zero padding),
    but its word ops are the compact ones of the kernels, so its bits are
    not the composite's;
  * the plain GEMM in several passes over the contraction: bit-identical
    with one pass;
  * checkpoints: a three-word state's file written by either package loads
    in the other word for word, the port's npz arrays byte for byte the
    JAX package's.
"""
import mpmath
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdpb_tpu.models import sdp as jsdp
from sdpb_tpu.ops import mpfloat as jmp, mpwide as jmw
from sdpb_tpu.solver import checkpoint as jck
from sdpb_tpu_torch import interop
from sdpb_tpu_torch.cli import approx_objective as acli, sdpb as cli
from sdpb_tpu_torch.io.sdp_zip import read_sdp
from sdpb_tpu_torch.models import sdp as tsdp
from sdpb_tpu_torch.ops import kernels as tk, mpfloat as tmp, mpwide as tmw, mpwide_kernel as wk
from sdpb_tpu_torch.solver import checkpoint as tck
from sdpb_tpu_torch.utils.strings import str_to_scaled_limbs

from test_torch_mpwide3 import _bits, _held, dense, three  # noqa: F401 (fixture)
from test_torch_slice import CERTIFICATE
from torch_parity import JW, wide_parts_of, wide_to_mpf

torch.set_num_threads(1)

K = 9
PREC = 24 * K


def _jax_composite(ja, jb, chunk):
    """sdpb_tpu/ops/linalg.py:32-74 for wide operands, op by op (its
    fori_loop over the chunks unrolled): a contraction of at most `chunk`
    terms summed by mp.sum_'s halving tree, else zero-padded to whole
    chunks, each chunk's tree added in order into a zero accumulator."""
    Kd = ja.shape[-1]

    def expand(x, y):
        terms = jmp.mul(jmp.expand_dims(x, -1), jmp.expand_dims(y, -3))
        return jmp.sum_(terms, axis=terms.ndim - 2)

    if Kd <= chunk:
        return expand(ja, jb)
    nch = -(-Kd // chunk)
    a = jmp.pad_dim(ja, ja.ndim - 1, nch * chunk - Kd)
    b = jmp.pad_dim(jb, jb.ndim - 2, nch * chunk - Kd)
    acc = jmw.zeros(a.shape[:-1] + (b.shape[-1],), ja.K, jnp.float32)
    for i in range(nch):
        acc = jmp.add(acc, expand(jmp.dynamic_slice_in_dim(a, i * chunk, chunk, a.ndim - 1),
                                  jmp.dynamic_slice_in_dim(b, i * chunk, chunk, b.ndim - 2)))
    return acc


def _gemm_exact(a, b, prec):
    """(exact values, sum of the terms' magnitudes) of a @ b, flattened."""
    B, M, Kd = a.shape
    N = b.shape[-1]
    ha = np.array(wide_to_mpf(a, prec), dtype=object).reshape(B, M, Kd)
    hb = np.array(wide_to_mpf(b, prec), dtype=object).reshape(-1, Kd, N)
    exact, scale = [], []
    with mpmath.workprec(prec + 200):
        for i in range(B):
            for m in range(M):
                for n in range(N):
                    terms = [ha[i, m, t] * hb[i % hb.shape[0], t, n] for t in range(Kd)]
                    exact.append(mpmath.fsum(terms))
                    scale.append(mpmath.fsum(abs(t) for t in terms) or mpmath.mpf(1))
    return exact, scale


@pytest.mark.parametrize("Kd", [1, 6])
def test_plain_gemm_against_the_jax_composite(three, monkeypatch, Kd):
    """[2,2,Kd] @ [1,Kd,3] (a broadcast batch), the composite's chunk of 4
    (its chunk at K = 27; here chunk=13 gives max(4, 13*25 // 81) = 4): Kd
    = 1 one unpadded product, Kd = 6 two chunks, the second padded with two
    zero terms.  No launch is counted on the CPU."""
    monkeypatch.setattr(tk, "wide3_chunk", lambda K: 4)
    rng = np.random.default_rng(30 + Kd)
    a, b = dense(rng, (2, 2, Kd)), dense(rng, (1, Kd, 3))
    tk.reset_launches()
    out = tk.mp_matmul_wide(a, b)
    assert out.shape == (2, 2, 3) and out.G == 3
    assert tk.LAUNCHES["mp_matmul_wide3"] == 0
    assert tk.wide3_plan(2, 2, Kd, 3, K, tk.WIDE3_TERMS)[:2] == \
        ((1, 1) if Kd == 1 else (4, 2))
    ref = _jax_composite(JW(wide_parts_of(a)), JW(wide_parts_of(b)), 4)
    exact, scale = _gemm_exact(a, b, PREC)
    _held(out, ref, exact, scale, PREC, -(PREC - 26))


@pytest.mark.parametrize("Kd", [1, 6])
def test_plain_gemm_against_mpmath_at_three_words_of_9(Kd):
    """3 x 9 (--precision 640): the composite's chunk of 4 at K = 27, Kd = 6
    in two chunks (the second padded), within 2^-(648-26) of mpmath."""
    Kw = 27
    assert tk.wide3_chunk(Kw) == 4 and tk.wide3_chunk(21) == 7 and tk.wide3_chunk(9) == 39
    rng = np.random.default_rng(40 + Kd)
    a, b = dense(rng, (1, 2, Kd), Kw), dense(rng, (1, Kd, 2), Kw)
    out = tk.mp_matmul_wide(a, b)
    exact, scale = _gemm_exact(a, b, 24 * Kw)
    assert _bits(wide_to_mpf(out, 24 * Kw), exact, scale, 24 * Kw) < -(24 * Kw - 26)


def test_plain_gemm_in_passes_equals_one_pass(three, monkeypatch):
    """A term budget of one chunk of every output: Kd = 9 (chunks of 4,
    padded to 12) in three passes, bit-identical with one pass; so the
    kernel's passes over its scratch change no bit either."""
    monkeypatch.setattr(tk, "wide3_chunk", lambda K: 4)
    rng = np.random.default_rng(50)
    a, b = dense(rng, (2, 3, 9)), dense(rng, (2, 9, 2))
    a4, b4, _ = tk._canon_wide_pair(a, b)
    one = tk.mp_matmul_wide3_plain(a4, b4)
    monkeypatch.setattr(tk, "WIDE3_TERMS", 2 * 3 * 2 * 4)
    assert tk.wide3_plan(2, 3, 9, 2, K, tk.WIDE3_TERMS) == (4, 3, 4)
    assert all(torch.equal(x.limbs, y.limbs) and torch.equal(x.exp, y.exp)
               for x, y in zip(tk.mp_matmul_wide3_plain(a4, b4).words, one.words))


def test_plain_gemm_tally_counts_the_work_the_product_needs(three, monkeypatch):
    """The word TwoSums the three-word GEMM's bound takes off (those of
    words more than 24 Kg digits apart, which the kernel skips) are counted
    over the work the product needs.  Chunks of 4, Kd = 6 (two zero terms
    of padding): the six products, the first chunk's three sums, the sum of
    the second chunk's two partial sums that each hold a term, the add of
    the second chunk into the accumulator; not the padding's products, the
    sums with a zero partial, nor the first add into the zero accumulator.
    The plain version's order written out here gives its bits and its
    count; counting every op counts more; passes of one chunk count the
    same."""
    monkeypatch.setattr(tk, "wide3_chunk", lambda K: 4)
    rng = np.random.default_rng(60)
    a, b = dense(rng, (1, 2, 6)), dense(rng, (1, 6, 2))
    a4, b4, _ = tk._canon_wide_pair(a, b)
    tally = wk.SkipTally()
    out = tk.mp_matmul_wide3_plain(a4, b4, tally)
    ap, bp = tmp.pad_dim(a4, 2, 2), tmp.pad_dim(b4, 1, 2)
    S = slice(None)
    want, every = wk.SkipTally(), wk.SkipTally()

    def counted(needed):
        def skip(far):
            every.skip()(far)
            if needed:
                want.skip()(far)
        return skip

    p = [wk.wmul_g_c(tk._sv_words(ap, (S, S, slice(t, t + 1), None)),
                     tk._sv_words(bp, (S, None, slice(t, t + 1), S)), a4.Kg, counted(t < 6))
         for t in range(8)]

    def add(x, y, needed):
        return wk.wadd_g_c(x, y, a4.Kg, counted(needed))

    c0 = add(add(p[0], p[2], True), add(p[1], p[3], True), True)
    c1 = add(add(p[4], p[6], False), add(p[5], p[7], False), True)
    zero = tuple(wk.wzeros(c0[0][1].shape, a4.Kg, torch.device("cpu"))[0] for _ in range(3))
    acc = add(add(zero, c0, False), c1, True)
    assert all(torch.equal(w.limbs, l[..., 0, :]) and torch.equal(w.exp, e[..., 0, :])
               for w, (l, e) in zip(out.words, acc))
    assert tally.count == want.count < every.count
    monkeypatch.setattr(tk, "WIDE3_TERMS", 1 * 2 * 2 * 4)
    assert tk.wide3_plan(1, 2, 6, 2, K, tk.WIDE3_TERMS) == (4, 2, 4)
    passes = wk.SkipTally()
    tk.mp_matmul_wide3_plain(a4, b4, passes)
    assert passes.count == tally.count


@pytest.mark.parametrize("kind", ["diagonal", "spd"])
def test_refined_solve_reaches_three_words(kind):
    """linalg.PosdefSolver at 3 x 9 (the factor on word 0 at 9 limbs, ~188
    bits): each refinement pass gains about the factor's bits, and three
    passes reach the 648 bits on these well-conditioned matrices (the
    solver takes four, solver/params.py::refinement_passes: an iteration's
    matrices cost a pass some of the factor's bits), on the
    iteration's first matrix, 100 I (its residual cancels to a lower word:
    a renormalization without the closing bottom-up pass left word 0 zero
    and the refinement stalled at 2^-456), and on a dense SPD matrix."""
    Kw, prec, n = 27, 648, 4
    rng = np.random.default_rng(60)
    with mpmath.workprec(prec + 200):
        if kind == "diagonal":
            A = [[mpmath.mpf(100) * (i == j) for j in range(n)] for i in range(n)]
        else:
            G = rng.standard_normal((n, n))
            top = G @ G.T + n * np.eye(n)
            A = [[mpmath.mpf(top[i, j]) + mpmath.mpf(rng.uniform(-1, 1)) * 2 ** -60
                  for j in range(n)] for i in range(n)]
            A = [[(A[i][j] + A[j][i]) / 2 for j in range(n)] for i in range(n)]
    from torch_parity import mpf_to_f64_limbs
    stage = lambda v, shape: tmw.wide_parts_to_mp(
        tmw.f64_limbs_to_wide_parts(mpf_to_f64_limbs(v, shape, prec), Kw), "cpu")
    Aw = stage([A[i][j] for i in range(n) for j in range(n)], (1, n, n))
    b = dense(rng, (1, n, 1), Kw)
    hA = wide_to_mpf(Aw, prec)
    hb = wide_to_mpf(b, prec)
    with mpmath.workprec(prec + 200):
        x = mpmath.lu_solve(mpmath.matrix([hA[i * n:(i + 1) * n] for i in range(n)]),
                            mpmath.matrix(hb))
        exact = [x[i] for i in range(n)]
    from sdpb_tpu_torch.ops import linalg
    sol = linalg.PosdefSolver(Aw, 9)
    errs = [_bits(wide_to_mpf(sol.solve(b, passes), prec), exact, [abs(e) for e in exact], prec)
            for passes in range(4)]
    assert errs[0] < -180 and errs[1] < -360 and errs[3] < -(prec - 30), errs


def test_wide_gemm_takes_two_or_three_words(three):
    """G = 2 and G = 3 operands alike, four words raise; Kd = 0 gives
    zeros."""
    rng = np.random.default_rng(8)
    a = dense(rng, (2, 2))
    with pytest.raises(ValueError, match="G = 2 or G = 3"):
        tk.mp_matmul_wide(tmw.MPW(a.words + a.words[:1]), tmw.MPW(a.words + a.words[:1]))
    with pytest.raises(ValueError, match="G = 2 or G = 3"):
        tk.mp_matmul_wide(a, tmw.MPW(a.words[:2]))
    z = tk.mp_matmul_wide(a[:, :0], a[:0, :])
    assert z.shape == (2, 2) and z.G == 3
    assert all(bool((w.limbs == 0).all()) and bool((w.exp == tmp.EXP_ZERO).all())
               for w in z.words)


def _words(state):
    return [w for v in [state.y] + [getattr(b, f) for b in state.buckets
                                    for f in ("x", "X_even", "X_odd", "Y_even", "Y_odd")]
            for w in v.words]


def _same_state(a, b) -> bool:
    return all(np.array_equal(np.asarray(x.limbs), np.asarray(y.limbs)) and
               np.array_equal(np.asarray(x.exp), np.asarray(y.exp))
               for x, y in zip(_words(a), _words(b)))


def test_three_word_checkpoints_cross_between_the_packages(tmp_path):
    """3 x 7 (21 limbs; 11 float64 host limbs; a value stores
    ceil(24*21/53) + 1 = 11 float64 limbs): the certificate's initial
    state with Omega_d = 1/3 (all three words nonzero), saved by the JAX
    package, loads in the port word for word as in the JAX package; the
    port's file of it is the JAX file byte for byte."""
    host = read_sdp(CERTIFICATE, 11)
    jsdp_ = jsdp.build_device_sdp(host, scaled_limbs=21)
    tsdp_ = tsdp.build_device_sdp(host, "cpu", scaled_limbs=21)
    assert tsdp_.b.G == 3 and tsdp_.b.Kg == 7
    om_p, om_d = str_to_scaled_limbs("1e20", 21), str_to_scaled_limbs("0." + "3" * 200, 21)
    assert len(om_d) == 3 and om_d[2][0][0] != 0
    from sdpb_tpu.solver import state as jstate
    state = jstate.initial_state(jsdp_, om_p, om_d)
    jck.save_checkpoint(tmp_path / "jax", jsdp_, state, verbosity=0)
    mine = tck.load_checkpoint(tmp_path / "jax", tsdp_, verbosity=0)
    assert _same_state(mine, jck.load_checkpoint(tmp_path / "jax", jsdp_, verbosity=0))
    port_state = interop.state_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    assert all(v.G == 3 for v in [port_state.y] + [port_state.buckets[0].x])
    tck.save_checkpoint(tmp_path / "port", tsdp_, port_state, verbosity=0)
    with np.load(tmp_path / "port" / "checkpoint_0.npz") as a, \
            np.load(tmp_path / "jax" / "checkpoint_0.npz") as b:
        assert a.files == b.files
        assert all(a[k].shape[0] == 11 and a[k].tobytes() == b[k].tobytes() for k in a.files)
    assert _same_state(jck.load_checkpoint(tmp_path / "port", jsdp_, verbosity=0),
                       jck.load_checkpoint(tmp_path / "jax", jsdp_, verbosity=0))


@pytest.mark.parametrize("argv,limit", [
    (["--arithmetic", "scaled", "--precision", "641"], "at most 27"),
    (["--arithmetic", "scaled", "--precision", "700", "--device", "cpu"], "at most 27"),
    (["--precision", "682"], "at most 13"),
    (["--precision", "700", "--device", "cuda:0"], "ROADMAP A23"),
])
def test_clis_refuse_past_their_limits_before_reading(argv, limit, tmp_path):
    """Scaled above 27 limbs (--precision 641 on) anywhere, classic above 13
    limbs (682 on) on a card: the sdpb and approx_objective CLIs stop
    naming the limit before they read the SDP (the path given does not
    exist) and whether or not a card is there.  Classic at 700 bits on the
    CPU goes on to read it."""
    missing = str(tmp_path / "no.zip")
    with pytest.raises(SystemExit, match=limit):
        cli.run(["-s", missing, "-c", str(tmp_path / "ck"), *argv])
    with pytest.raises(SystemExit, match=limit):
        acli.run(["--sdp", missing, "--newSdp", missing, *argv])
    assert cli.check_precision("scaled", 640) == 27
    assert cli.check_precision("classic", 681) == 0
    with pytest.raises(FileNotFoundError):
        cli.run(["-s", missing, "-c", str(tmp_path / "ck"), "--precision", "700",
                 "--device", "cpu"])


def test_profiler_takes_three_words():
    """tools/profile_phases.py takes --scaledLimbs 0 or 2-27 and stops on
    28 before it reads anything."""
    from sdpb_tpu_torch.tools import profile_phases
    with pytest.raises(SystemExit):
        profile_phases.main(["--fixture", "no.zip", "--scaledLimbs", "28"])
    assert "19-27" in profile_phases.__doc__


def test_refinement_passes_count_the_factors_bits():
    """solver/params.py::refinement_passes: none with every limb factored;
    classic, the JAX package's ceil(K / Kf); scaled, the working bits over
    the factor's, at most SCALED_FACTOR_BITS: unchanged for one word (K32 =
    9, Kf = 8) and wherever 24 Kf <= 188, one more pass for two words of 9
    at 400 bits and three words of 9 at 640 bits."""
    from sdpb_tpu_torch.solver.params import SCALED_FACTOR_BITS, refinement_passes
    assert SCALED_FACTOR_BITS == 188
    jax_rule = lambda K, kf: 0 if K <= kf else -(-K // kf)
    for K in range(2, 14):
        for kf in range(2, K + 1):
            assert refinement_passes(K, kf, False) == jax_rule(K, kf)
    for K in range(2, 28):
        for kf in range(2, min(K, 7) + 1):
            assert refinement_passes(K, kf, True) == jax_rule(K, kf)
    assert refinement_passes(9, 9, True) == 0
    assert refinement_passes(9, 8, True) == jax_rule(9, 8) == 2
    assert (refinement_passes(18, 9, True), jax_rule(18, 9)) == (3, 2)
    assert (refinement_passes(27, 9, True), jax_rule(27, 9)) == (4, 3)
    assert (refinement_passes(27, 8, True), jax_rule(27, 8)) == (4, 4)
