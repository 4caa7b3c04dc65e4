"""The port's approx_objective (tools/approx_objective.py, the CLI) against
the JAX package's on the CPU.

The problem: four blocks from sdpb_tpu/tools/gen_pmp.py --solvable (two
1x1 and two 2x2, degree 2, N = 3; two buckets), converted by the JAX
package's sdp2input at 200 bits, solved by the port's CLI at 150 bits.  The
new SDPs perturb b, c and B by 1e-6 relative (torch_parity.perturbed_sdp).

Findings these tests are built around:
  * The frozen Schur solve loses about 3 log10(1/gap) digits: cond(S) ~
    1/gap^2, and dx = S^{-1}(...) cancels terms 1/gap times its size.  At 150
    bits (K = 3) from this problem's solution at gap 1e-20 the quadratic
    term of a c or B perturbation comes out wrong by a factor ~1e6 in both
    packages; at --precision 300 (K = 6) from the same solution it is right
    (tests/test_torch_approx_resolve.py holds it to a re-solve there).  So
    the parity tests read the state of iteration 25 of the solve.
  * The JAX package's PosdefSolver.solve runs its refinement in a
    lax.fori_loop, which XLA:CPU compiles; on a nearly singular X of this
    problem's optimum that loop returns a residual of 2e4 where the same
    operations run one by one give 1e-28 (as the port does).  The JAX
    functions are therefore called op by op (no jax.jit), with the
    refinement unrolled into the same Python loop (_unrolled_solve).

Tolerances (classic, K = 3):
  * FrozenSchur: every array within 2^-(53K-24) of its largest entry
    (relative).  The port's products, factors and solves follow the
    kernels' order, the JAX package's XLA path another, so the last limb
    differs; the solves against S and Q of the iteration-25 state amplify
    that by their conditioning (~1e4 here).
  * objective and d_objective: the same decimal strings (their sums and
    products are short enough to round alike); dd_objective within
    2^-(53K-40) relative.
  * scaled (K32 = 3, --precision 64) and wide (two words of 3 float32
    limbs, --precision 128) against the JAX classic tool at 150 bits:
    objective and d_objective within 2^-(24 K32 - 24) relative, dd_objective
    within 2^-(24 K32 - 40) (the frozen solves' conditioning at the scaled
    precision).
"""
import contextlib
import copy
import io
import json

import mpmath
import numpy as np
import pytest
import torch

import jax

from sdpb_tpu.io import text_blocks as jtext
from sdpb_tpu.io.sdp_zip import read_sdp as jread_sdp, write_sdp
from sdpb_tpu.models.sdp import build_device_sdp as jbuild
from sdpb_tpu.ops import linalg as jla, mpfloat as jmp
from sdpb_tpu.solver.checkpoint import load_text_checkpoint as jload_text
from sdpb_tpu.tools import approx_objective as jao
from sdpb_tpu.utils.strings import mp_host_to_mpf
from sdpb_tpu_torch.cli import approx_objective as tcli, sdpb as sdpb_cli
from sdpb_tpu_torch.io import text_blocks as ttext
from sdpb_tpu_torch.io.sdp_zip import read_sdp
from sdpb_tpu_torch.models.sdp import build_device_sdp
from sdpb_tpu_torch.ops import linalg as tla, mpfloat as tmp, mpwide as tmw
from sdpb_tpu_torch.solver.checkpoint import load_text_checkpoint
from sdpb_tpu_torch.tools import approx_objective as tao

from torch_parity import limbs_of, perturbed_sdp, small_wide_config

torch.set_num_threads(1)

K = 3
PREC = "150"
DELTA = 1e-6
EARLY_ITERATIONS = 25
SOLVE = ("--device", "cpu", "--precision", PREC, "--dualityGapThreshold", "1e-20",
         "--primalErrorThreshold", "1e-20", "--dualErrorThreshold", "1e-20",
         "--initialMatrixScalePrimal", "1e4", "--initialMatrixScaleDual", "1e4",
         "--timingRun", "never", "--verbosity", "0", "--maxIterations", "300")


def _problem_pmp() -> dict:
    from sdpb_tpu.tools.gen_pmp import generate_pmp

    pmp = generate_pmp(2, 1, 3, 2, num_poles=2, seed=0, solvable=True)
    pmp["PositiveMatrixWithPrefactorArray"] += generate_pmp(
        2, 2, 3, 2, num_poles=2, seed=1, solvable=True)["PositiveMatrixWithPrefactorArray"]
    return pmp


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The problem, its state after EARLY_ITERATIONS iterations (early/)
    and two perturbed problems (new1.zip, new2.zip, both listed in
    new.nsv)."""
    from sdpb_tpu.cli.sdp2input import convert

    d = tmp_path_factory.mktemp("approx")
    (d / "pmp.json").write_text(json.dumps(_problem_pmp()))
    convert(d / "pmp.json", d / "sdp.zip", 200, "json")
    res = sdpb_cli.run(["-s", str(d / "sdp.zip"), "-o", str(d / "early"), "-c", str(d / "ck"),
                        "--writeSolution", "x,y,X,Y"] + list(SOLVE)[:-1]
                       + [str(EARLY_ITERATIONS)])
    assert str(res.terminate_reason) == "maxIterations exceeded"
    host = jread_sdp(d / "sdp.zip", 5, np.float64)
    for i in (1, 2):
        write_sdp(d / f"new{i}.zip", perturbed_sdp(host, DELTA, seed=i))
    (d / "new.nsv").write_bytes(b"new1.zip\0new2.zip\0")
    return d


def _unrolled_solve(self, B, n_refine):
    """sdpb_tpu.ops.linalg.PosdefSolver.solve with its refinement loop
    unrolled in Python (the same operations, one by one)."""
    x = jmp.round_to(self.solve_lo(jmp.round_to(B, self.Kf)), B.K)
    for _ in range(n_refine):
        r = jmp.sub(B, jla.matmul(self.A, x))
        x = jmp.add(x, jmp.round_to(self.solve_lo(jmp.round_to(r, self.Kf)), B.K))
    return x


@pytest.fixture(scope="module")
def jax_early(case):
    """The JAX package's FrozenSchur and objectives of new1.zip from the
    early state (classic, K = 3), its functions called op by op."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jla.PosdefSolver, "solve", _unrolled_solve)
    try:
        host = jread_sdp(case / "sdp.zip", K, np.float64)
        sdp = jbuild(host)
        state = jload_text(case / "early", sdp, verbosity=0)
        frozen = jao.make_setup_fn(K, 1)(sdp, state)
        values = _jax_objectives(case, sdp, state, frozen, host, "new1.zip")
    finally:
        mp.undo()
    return frozen, values


def _jax_objectives(case, sdp, state, frozen, host, new):
    host_new = jread_sdp(case / new, K, np.float64)
    d_cs, d_Bs = jao.sdp_delta_buckets(sdp, host, host_new, K, np.float64)
    out = jao.make_approx_fn(K, 1)(
        sdp, state, frozen, jao.stage_host_mp(host_new.objective_const - host.objective_const),
        jao.stage_host_mp(host_new.b - host.b), d_cs, d_Bs, True)
    return [_jax_str(v) for v in out]


def _jax_str(v) -> str:
    return mpmath.nstr(mp_host_to_mpf(jax.tree.map(np.asarray, v)), int(int(PREC) * 0.30103) + 1,
                       strip_zeros=False, min_fixed=1, max_fixed=0)


def _port(case, *extra, sol="early", new="new1.zip", precision=PREC):
    return tcli.run(["--sdp", str(case / "sdp.zip"), "--newSdp", str(case / new),
                     "--precision", precision, "--solutionDir", str(case / sol),
                     "--device", "cpu"] + list(extra))


def _values(result) -> list:
    return [result["objective"], result["d_objective"], result["dd_objective"]]


def _rel(a, b, prec=400):
    with mpmath.workprec(prec):
        a, b = mpmath.mpf(a), mpmath.mpf(b)
        return abs(a - b) / abs(b) if b else abs(a)


def _close(got, want, rel):
    """|got - want| <= rel * max|want|, elementwise at full MP precision,
    for classic JAX / port values."""
    g, w = limbs_of(got), limbs_of(want)
    assert g.shape == w.shape
    d = tmp.to_float_array(tmp.sub(tmp.MP(torch.tensor(g)), tmp.MP(torch.tensor(w)))).numpy()
    scale = np.max(np.abs(w[0]))
    assert np.max(np.abs(d)) <= rel * scale, (np.max(np.abs(d)) / scale, rel)


def _assert_frozen_close(port, ref, rel):
    for name in ("Ss", "S_Ls", "S_dinvs", "SinvBs"):
        assert len(getattr(port, name)) == len(getattr(ref, name)) == 2
        for p, r in zip(getattr(port, name), getattr(ref, name)):
            _close(p, r, rel)
    for name in ("Q", "Q_L", "Q_dinv"):
        _close(getattr(port, name), getattr(ref, name), rel)


def test_frozen_schur_and_objectives_match_jax(case, jax_early):
    """setup_frozen_schur and approx_objective against make_setup_fn and
    make_approx_fn from the same problem and state (the port's own readers
    and the JAX package's)."""
    jfrozen, jvalues = jax_early
    sdp = build_device_sdp(read_sdp(case / "sdp.zip", K), "cpu")
    state = load_text_checkpoint(case / "early", sdp, verbosity=0)
    frozen = tao.setup_frozen_schur(sdp, state, K, 1)
    _assert_frozen_close(frozen, jfrozen, 2.0 ** -(53 * K - 24))
    values = _values(_port(case)[0])
    assert values[:2] == jvalues[:2]
    assert _rel(values[2], jvalues[2]) <= 2.0 ** -(53 * K - 40), (values, jvalues)
    assert 0 < abs(mpmath.mpf(values[2])) < 1e-9


def test_linear_nsv_and_shape_mismatch(case, tmp_path):
    """--linear gives the quadratic run's d_objective and a zero
    dd_objective; an .nsv of two new SDPs gives each one's own result, in
    order; new SDPs whose blocks differ in shape or number raise."""
    quad = _port(case, new="new.nsv")
    assert [r["path"] for r in quad] == [str(case / "new1.zip"), str(case / "new2.zip")]
    for i, r in enumerate(quad):
        assert r == dict(_port(case, new=f"new{i + 1}.zip")[0], path=r["path"])
        lin = _port(case, "--linear", new=f"new{i + 1}.zip")[0]
        assert lin["d_objective"] == r["d_objective"]
        assert mpmath.mpf(lin["dd_objective"]) == 0
        with mpmath.workprec(400):
            # the same value, each printed to 46 digits
            assert _rel(lin["objective"], mpmath.mpf(r["objective"])
                        - mpmath.mpf(r["dd_objective"])) < 1e-45
    assert quad[0]["objective"] != quad[1]["objective"]
    host = jread_sdp(case / "sdp.zip", K, np.float64)
    other = perturbed_sdp(host, DELTA, seed=3)
    other.blocks[0] = copy.deepcopy(other.blocks[2])      # a 2x2 block for a 1x1 one
    other.blocks[0].index = 0
    write_sdp(tmp_path / "bad.zip", other)
    with pytest.raises(ValueError, match="shapes differ"):
        _port(case, new=tmp_path / "bad.zip")
    other.blocks.pop()
    write_sdp(tmp_path / "fewer.zip", other)
    with pytest.raises(ValueError, match="different blocks"):
        _port(case, new=tmp_path / "fewer.zip")


def test_scaled_and_wide_match_jax_classic(case, jax_early, monkeypatch):
    """--arithmetic scaled at --precision 64 (K32 = 3) and, with the wide
    representation narrowed to two words of 3 limbs, --precision 128 (K32
    = 6, wide): the objectives against the JAX classic tool at 150 bits."""
    _, jvalues = jax_early
    for precision, K32 in (("64", 3), ("128", 6)):
        if K32 > 5:
            monkeypatch.setattr(tmp, "MAX_SCALED_K", 5)
            monkeypatch.setattr(tmw, "wide_config", small_wide_config)
        values = _values(_port(case, "--arithmetic", "scaled", precision=precision)[0])
        for i, (v, j) in enumerate(zip(values, jvalues)):
            tol = 2.0 ** -(24 * K32 - (40 if i == 2 else 24))
            assert _rel(v, j) <= tol, (precision, i, v, j)


def test_solver_state_file_crosses_packages(case, jax_early, tmp_path):
    """--writeSolverState: a second call loads solver_state.npz and prints
    the same JSON.  The npz holds the JAX package's keys in its order; the
    port reads a JAX-written file, and the JAX package the port's, each to
    the objectives it computes from its own."""
    sol = tmp_path / "sol"
    sol.mkdir()
    for f in (case / "early").iterdir():
        (sol / f.name).write_bytes(f.read_bytes())
    timings = {}
    first = tcli.run(["--sdp", str(case / "sdp.zip"), "--newSdp", str(case / "new1.zip"),
                      "--precision", PREC, "--solutionDir", str(sol), "--device", "cpu",
                      "--writeSolverState"], timings=timings)
    assert timings["frozen"] == "setup" and (sol / "solver_state.npz").exists()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(["--sdp", str(case / "sdp.zip"), "--newSdp", str(case / "new1.zip"),
                          "--precision", PREC, "--solutionDir", str(sol), "--device", "cpu"]) == 0
    assert json.loads(buf.getvalue()) == first
    (tmp_path / "port.npz").write_bytes((sol / "solver_state.npz").read_bytes())
    port_file = np.load(tmp_path / "port.npz")
    # the JAX package writes its own FrozenSchur to the same keys
    jfrozen, jvalues = jax_early
    jao.save_solver_state(tmp_path / "jax.npz", jfrozen, K)
    jax_file = np.load(tmp_path / "jax.npz")
    assert port_file.files == jax_file.files
    assert all(port_file[k].dtype == jax_file[k].dtype and
               port_file[k].shape == jax_file[k].shape for k in port_file.files)
    # the port reads the JAX file: the JAX package's objectives
    (sol / "solver_state.npz").write_bytes((tmp_path / "jax.npz").read_bytes())
    timings = {}
    got = tcli.run(["--sdp", str(case / "sdp.zip"), "--newSdp", str(case / "new1.zip"),
                    "--precision", PREC, "--solutionDir", str(sol), "--device", "cpu"],
                   timings=timings)
    assert timings["frozen"] == "npz"
    assert _values(got[0])[:2] == jvalues[:2]
    assert _rel(got[0]["dd_objective"], jvalues[2]) <= 2.0 ** -(53 * K - 40)
    # the JAX package reads the port's file: the port's objectives
    mp = pytest.MonkeyPatch()
    mp.setattr(jla.PosdefSolver, "solve", _unrolled_solve)
    try:
        jfrozen2, kf = jao.load_solver_state(tmp_path / "port.npz")
        assert kf == K
        host = jread_sdp(case / "sdp.zip", K, np.float64)
        sdp = jbuild(host)
        state = jload_text(case / "early", sdp, verbosity=0)
        values = _jax_objectives(case, sdp, state, jfrozen2, host, "new1.zip")
    finally:
        mp.undo()
    assert values[:2] == _values(first[0])[:2]
    assert _rel(values[2], first[0]["dd_objective"]) <= 2.0 ** -(53 * K - 40)


@pytest.mark.parametrize("upper", [False, True])
def test_reference_text_factors_load_alike(case, jax_early, tmp_path, upper):
    """load_reference_solver_state: S and Q's full-precision factors written
    by write_text_matrix (Q's upper when `upper`, as the reference stores
    it; S's lower) load in both packages to the same FrozenSchur, within
    the FrozenSchur tolerance, and near the one set up directly."""
    jfrozen, _ = jax_early
    sdp = build_device_sdp(read_sdp(case / "sdp.zip", K), "cpu")
    state = load_text_checkpoint(case / "early", sdp, verbosity=0)
    frozen = tao.setup_frozen_schur(sdp, state, K, 1)
    for bk, S in zip(sdp.buckets, frozen.Ss):
        L = tla.cholesky(S).limbs.numpy()
        for i, rs in enumerate(bk.real_sizes):
            ttext.write_text_matrix(tmp_path / f"schur_complement_cholesky_{rs.block_index}.txt",
                                    L[:, i])
    QL = tla.cholesky(frozen.Q).limbs.numpy()
    ttext.write_text_matrix(tmp_path / "Q_cholesky.txt",
                            np.swapaxes(QL, -1, -2) if upper else QL)
    port = tao.load_reference_solver_state(tmp_path, sdp, K, 1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jla.PosdefSolver, "solve", _unrolled_solve)
    try:
        ref = jao.load_reference_solver_state(tmp_path, jbuild(jread_sdp(case / "sdp.zip", K,
                                                                          np.float64)), K, 1)
    finally:
        mp.undo()
    _assert_frozen_close(port, ref, 2.0 ** -(53 * K - 24))
    for a, b in ((port.Q, frozen.Q), (port.Ss[1], frozen.Ss[1]),
                 (port.SinvBs[1], frozen.SinvBs[1])):
        _close(a, b, 1e-13)
    assert jtext.read_text_matrix(tmp_path / "Q_cholesky.txt", K).shape == (K, 3, 3)


def test_cli_refuses_a_missing_card(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tcli.run(["--sdp", str(case / "sdp.zip"), "--newSdp", str(case / "new1.zip"),
                  "--precision", PREC, "--solutionDir", str(case / "early")])
