"""The port's approx_objective at a solved state, on the CPU: against an
independent re-solve, and, in the scaled representation, against the JAX
package's scaled tool.

The dim-2 certificate (fixtures/dim2_certificate/sdp.zip) solved by the
port's CLI at 150 bits to gap 1e-16 with x, y, X and Y written; b, c and B
perturbed by DELTA = 1e-5 relative (torch_parity.perturbed_sdp); the
perturbed problem re-solved the same way.  The quadratic approximation's
error is the third-order term, ~5 DELTA^3 here (5.9e-15 measured; 5.4e-18
at DELTA = 1e-6 and gap 1e-20), plus the two solutions' distance from
their optima (~gap): bound 1e-13, as tests/test_approx_objective.py:62
bounds the JAX package's at 1e-17 for a perturbation of b alone.  The
linear error, ~DELTA^2 (1.1e-10 measured), must be at least 1e3 times the
quadratic one.

The frozen Schur solve needs about 3 log2(1/gap) bits (cond(S) ~ 1/gap^2,
and dx cancels 1/gap times its size): ~161 at this solution's gap.  The
scaled representation at --precision 64 (3 float32 limbs, 72 bits) falls
far short, and its quadratic term is noise in both packages: each
package's scaled dd_objective is off from the classic one by more than
10 times the classic value, and the two errors lie within a factor 100 of
each other (measured: 7.1e-8 and 4.6e-8 against -1.09e-10).  The linear
part involves no solve and agrees with classic within 2^-(24 K32 - 24).
"""
import mpmath
import numpy as np
import pytest
import torch

from sdpb_tpu.io.sdp_zip import read_sdp, write_sdp
from sdpb_tpu_torch.cli import approx_objective, sdpb as cli

from test_torch_slice import CERTIFICATE
from torch_parity import perturbed_sdp

torch.set_num_threads(1)

DELTA = 1e-5
SCALED_K32, SCALED_PREC = 3, "64"
SOLVE = ("--device", "cpu", "--precision", "150", "--dualityGapThreshold", "1e-16",
         "--primalErrorThreshold", "1e-16", "--dualErrorThreshold", "1e-16",
         "--initialMatrixScalePrimal", "1e2", "--initialMatrixScaleDual", "1e2",
         "--timingRun", "never", "--verbosity", "0")


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """The certificate's solution (out/), the perturbed problem (new.zip)
    and the perturbed problem's re-solve."""
    d = tmp_path_factory.mktemp("resolve")
    res = cli.run(["-s", str(CERTIFICATE), "-o", str(d / "out"), "-c",
                   str(d / "ck"), "--writeSolution", "x,y,X,Y"] + list(SOLVE))
    assert str(res.terminate_reason) == "found primal-dual optimal solution"
    write_sdp(d / "new.zip", perturbed_sdp(read_sdp(CERTIFICATE, 5, np.float64),
                                           DELTA, seed=1))
    res2 = cli.run(["-s", str(d / "new.zip"), "-o", str(d / "out2"), "-c",
                    str(d / "ck2")] + list(SOLVE))
    assert str(res2.terminate_reason) == "found primal-dual optimal solution"
    return d, res2


def _approx(d, *extra, timings=None):
    return approx_objective.run(["--sdp", str(CERTIFICATE), "--newSdp", str(d / "new.zip"),
                                 "--solutionDir", str(d / "out"), "--device", "cpu"]
                                + list(extra), timings=timings)[0]


def test_quadratic_matches_a_resolve(solved):
    d, res2 = solved
    timings = {}
    r = _approx(d, "--precision", "150", timings=timings)
    assert timings["warning"] is None
    with mpmath.workprec(400):
        quad = abs(mpmath.mpf(r["objective"]) - res2.dual_objective)
        lin = abs(mpmath.mpf(r["objective"]) - mpmath.mpf(r["dd_objective"])
                  - res2.dual_objective)
        assert quad < mpmath.mpf("1e-13"), (quad, r)
        assert lin > 1000 * quad, (lin, quad)
        assert 0 < abs(mpmath.mpf(r["dd_objective"])) < mpmath.mpf("1e-9")


def _jax_scaled(d):
    """(d_objective, dd_objective) of the JAX package's scaled tool from the
    same solution and new SDP, its functions called op by op with the
    refinement unrolled (test_torch_approx_objective._unrolled_solve)."""
    import jax

    from sdpb_tpu.models.sdp import build_device_sdp
    from sdpb_tpu.ops import linalg as jla
    from sdpb_tpu.solver.checkpoint import load_text_checkpoint
    from sdpb_tpu.tools import approx_objective as jao
    from sdpb_tpu.utils.strings import mp_host_to_mpf

    from test_torch_approx_objective import _unrolled_solve

    K = -(-(24 * SCALED_K32) // 53) + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jla.PosdefSolver, "solve", _unrolled_solve)
        host = read_sdp(CERTIFICATE, K, np.float64)
        sdp = build_device_sdp(host, scaled_limbs=SCALED_K32)
        state = load_text_checkpoint(d / "out", sdp, verbosity=0)
        frozen = jao.make_setup_fn(SCALED_K32, 1)(sdp, state)
        new = read_sdp(d / "new.zip", K, np.float64)
        d_cs, d_Bs = jao.sdp_delta_buckets(sdp, host, new, K, np.float64, SCALED_K32)
        _, d_obj, dd_obj = jao.make_approx_fn(SCALED_K32, 1)(
            sdp, state, frozen,
            jao.stage_host_mp(new.objective_const - host.objective_const, SCALED_K32),
            jao.stage_host_mp(new.b - host.b, SCALED_K32), d_cs, d_Bs, True)
    return [mp_host_to_mpf(jax.tree.map(np.asarray, v)) for v in (d_obj, dd_obj)]


def test_scaled_quadratic_term_fails_alike_in_both_packages(solved):
    """Scaled at 72 bits from a solution at gap ~1e-16: the port warns, its
    quadratic term is noise, and so is the JAX package's, by as much."""
    d, _ = solved
    classic = _approx(d, "--precision", "150")
    timings = {}
    port = _approx(d, "--precision", SCALED_PREC, "--arithmetic", "scaled", timings=timings)
    assert "frozen Schur solve" in timings["warning"]
    jax_d, jax_dd = _jax_scaled(d)
    with mpmath.workprec(400):
        want_d, want_dd = mpmath.mpf(classic["d_objective"]), mpmath.mpf(classic["dd_objective"])
        tol = mpmath.mpf(2) ** -(24 * SCALED_K32 - 24)
        for got in (mpmath.mpf(port["d_objective"]), jax_d):
            assert abs(got - want_d) <= tol * abs(want_d), (got, want_d)
        errs = [abs(mpmath.mpf(port["dd_objective"]) - want_dd), abs(jax_dd - want_dd)]
        assert min(errs) > 10 * abs(want_dd), (errs, want_dd)
        assert max(errs) < 100 * min(errs), errs
