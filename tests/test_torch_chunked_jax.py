"""The port's chunked run loop against the JAX package's
(sdpb_tpu/solver/solve.py::_solve_chunked, run_solver with
chunk_iterations=3) on the CPU: the same reason, iteration count and heal
lines (the KKT residual a warning quotes sits at the rounding floor, where
the packages' matmul orders differ), every statistic of the result within
1e-8 relative, as tests/test_torch_slice.py holds the host loops (the step
lengths come from LAPACK calls that differ between the packages).
"""
import re

import torch

from sdpb_tpu.models import sdp as jsdp
from sdpb_tpu.models.synthetic import random_sdp
from sdpb_tpu.solver import solve as jsolve
from sdpb_tpu.solver.params import SolverParameters as JaxParameters
from sdpb_tpu_torch.models import sdp as tsdp
from sdpb_tpu_torch.solver import solve as tsolve
from sdpb_tpu_torch.solver.params import SolverParameters

from test_torch_slice import _floor, _problem

torch.set_num_threads(1)


def _jax_chunked(host, params, capsys):
    """The JAX package's chunked loop (chunks of 3) and what it printed."""
    jparams = JaxParameters(**params.to_dict())
    res = jsolve.run_solver(jsdp.build_device_sdp(host), jparams, verbosity=1,
                            chunk_iterations=3)
    return res, capsys.readouterr().out


def _heal_lines(out):
    return [re.sub(r"residual \S+", "residual <r>", ln) for ln in out.splitlines()
            if ln.startswith(("conditioning exceeded", "non-finite", "WARNING"))]


def _assert_close_to_jax(got, ref, K):
    assert str(got.terminate_reason) == str(ref.terminate_reason)
    assert got.iterations == ref.iterations
    for f in ("primal_objective", "dual_objective", "duality_gap"):
        a, b = float(getattr(got, f)), float(getattr(ref, f))
        assert abs(a - b) <= 1e-8 * abs(b) or abs(a - b) <= _floor(K), f
    for f in ("primal_error_P", "primal_error_p", "dual_error"):
        a, b = getattr(got, f), float(getattr(ref, f))
        assert abs(a - b) <= 1e-8 * abs(b) or abs(a - b) <= _floor(K), f


def test_heal_matches_jax_chunked_loop(capsys):
    """A KKT threshold no solve meets trips the guard in every iteration:
    below the cap (factor pinned at 2 of 3 limbs) the first chunk heals
    and replays from its start at 3 limbs; at the cap the guard warns
    once and the run goes on to maxIterations."""
    host = random_sdp(num_blocks=3, dim=1, num_points=4, dual_dim=3, K=3, seed=1)
    params = SolverParameters(precision=150, initial_matrix_scale_primal="1e2",
                              initial_matrix_scale_dual="1e2", factor_limbs=2,
                              kkt_residual_threshold="1e-300", max_iterations=4)
    got = tsolve.run_solver(tsdp.build_device_sdp(host, "cpu"), params, verbosity=1)
    mine = _heal_lines(capsys.readouterr().out)
    ref, out = _jax_chunked(host, params, capsys)
    assert mine == _heal_lines(out)
    assert mine[0] == ("conditioning exceeded factor range; increasing factor "
                       "precision to 3 limbs (replaying from iteration 1)")
    assert len(mine) == 2 and mine[1].startswith("WARNING: KKT solve residual")
    assert str(got.terminate_reason) == "maxIterations exceeded"
    _assert_close_to_jax(got, ref, 3)
    # the healing chunk's failed row, then the five iterations at the cap
    assert len(got.history) == 1 + 5 and sorted(got.graphs) == [2, 3]


def test_certificate_matches_jax_chunked_loop(capsys):
    host, params, K = _problem("cert_K3")
    params.max_iterations = 5
    got = tsolve.run_solver(tsdp.build_device_sdp(host, "cpu"), params, verbosity=0)
    ref, _ = _jax_chunked(host, params, capsys)
    _assert_close_to_jax(got, ref, K)
    assert got.iterations == 6
