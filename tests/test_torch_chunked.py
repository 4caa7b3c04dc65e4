"""The port's chunked run loop (solver/solve.py::_solve_chunked over
solver/graphs.py::ChunkRunner, the eager body on the CPU) against the port's
host loop, on the CPU (tests/test_torch_chunked_jax.py holds it against the
JAX package's chunked loop).

Tolerances:
  * chunked against the port's host loop: every HostStats field of every
    iteration, the reason, the iteration count and the final state bit for
    bit (the same operations in the same order; only the termination
    checks moved to the device).  The device checks compare the error
    norms with the thresholds in the norms' dtype (float32 in a scaled
    run, as the JAX package's chunked loop does) and the gap as an MP
    difference, where the host loop compares both exactly in mpmath: the
    two part only for a norm between a threshold and its float32 rounding,
    or a gap within the gap's last limb of its threshold, which these
    problems never meet.  maxRuntime is checked at chunk boundaries only,
    so there the chunked loop runs to the end of its chunk (the JAX
    package's semantics).
"""
import numpy as np
import pytest
import torch

from sdpb_tpu.models.synthetic import random_sdp
from sdpb_tpu_torch.io.sdp_zip import read_sdp
from sdpb_tpu_torch.models import sdp as tsdp
from sdpb_tpu_torch.ops import mpfloat as tmp, mpwide as tmw
from sdpb_tpu_torch.solver import graphs, solve as tsolve, state as tstate, step as tstep
from sdpb_tpu_torch.solver.params import SolverParameters
from sdpb_tpu_torch.utils.strings import str_to_limbs, str_to_scaled_limbs

from test_torch_slice import CERTIFICATE, _problem
from torch_parity import small_wide_config

torch.set_num_threads(1)


def _bits(v):
    """A HostStats field as exactly comparable Python values."""
    if isinstance(v, list):
        return tuple(_bits(w) for w in v)
    if isinstance(v, tuple):
        return (np.asarray(v[0]).tobytes(), v[1])
    if isinstance(v, np.ndarray):
        return v.tobytes()
    return v


def _same_runs(a, b, n_history=None):
    """Two SolveResults with bit-identical statistics (the first n_history
    rows of each, by default all of them and as many)."""
    ha, hb = a.history, b.history
    if n_history is None:
        assert len(ha) == len(hb)
    for i, (x, y) in enumerate(zip(ha[:n_history], hb[:n_history])):
        for f in x._fields:
            assert _bits(getattr(x, f)) == _bits(getattr(y, f)), (i + 1, f)


def _same_states(a, b):
    ta, tb = tstep.state_tensors(a), tstep.state_tensors(b)
    assert len(ta) == len(tb)
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))


@pytest.mark.parametrize("chunk", [3, 4])
@pytest.mark.parametrize("name", ["cert_K3", "dim2_K3"])
def test_chunked_matches_host_loop(name, chunk):
    """maxIterations 5: six iterations run, the sixth stops the loop inside
    the second chunk (of 4) or at its end (of 3)."""
    host, params, K = _problem(name)
    params.max_iterations = 5
    ref = tsolve.run_solver(tsdp.build_device_sdp(host, "cpu"), params, verbosity=0,
                            chunk_iterations=1)
    got = tsolve.run_solver(tsdp.build_device_sdp(host, "cpu"), params, verbosity=0,
                            chunk_iterations=chunk)
    assert str(got.terminate_reason) == str(ref.terminate_reason) == "maxIterations exceeded"
    assert got.iterations == ref.iterations == 6
    _same_runs(got, ref)
    _same_states(got.state, ref.state)
    assert (got.primal_objective, got.dual_objective, got.duality_gap) == \
        (ref.primal_objective, ref.dual_objective, ref.duality_gap)
    assert [c[0] for c in got.chunks] == ([3, 3] if chunk == 3 else [4, 2])
    assert len(got.iteration_seconds) == len(got.history)


def _random1():
    return random_sdp(num_blocks=3, dim=1, num_points=4, dual_dim=3, K=2, seed=1)


def _certificate_K2():
    return read_sdp(CERTIFICATE, 2)


# (reason, problem, parameters, the iteration that stops).  The random
# problem takes full primal steps from iteration 2, is primal feasible from
# iteration 3 and its dual error falls below 50 at iteration 4; mu passes
# 2e4 at iteration 8, the primal step is 0.743 at iteration 1 and the dual
# step 0.019 at 7.  The certificate takes a full dual step at iteration 6.
REASONS = [
    ("found primal-dual optimal solution", _random1,
     dict(duality_gap_threshold="2", primal_error_threshold="1e-20",
          dual_error_threshold="50"), 4),
    ("maxIterations exceeded", _random1, dict(max_iterations=4), 5),
    ("primal step too small", _random1, dict(min_primal_step="0.75"), 2),
    ("dual step too small", _random1, dict(min_dual_step="0.1"), 8),
    ("primal feasible jump detected", _random1, dict(detect_primal_feasible_jump=True), 3),
    ("dual feasible jump detected", _certificate_K2,
     dict(detect_dual_feasible_jump=True, duality_gap_threshold="1e-12",
          primal_error_threshold="1e-12", dual_error_threshold="1e-12"), 7),
    ("found primal feasible solution", _random1,
     dict(find_primal_feasible=True, primal_error_threshold="1e-20"), 3),
    ("found dual feasible solution", _random1,
     dict(find_dual_feasible=True, dual_error_threshold="50"), 4),
    ("maxComplementarity exceeded", _random1, dict(max_complementarity="2e4"), 8),
]


@pytest.mark.parametrize("reason, problem, extra, stop", REASONS,
                         ids=[r[0].replace(" ", "_") for r in REASONS])
def test_each_reason_matches_host_loop(reason, problem, extra, stop):
    params = SolverParameters(**{"precision": 98, "initial_matrix_scale_primal": "1e2",
                                 "initial_matrix_scale_dual": "1e2",
                                 "max_iterations": 12, **extra})
    host = problem()
    ref = tsolve.run_solver(tsdp.build_device_sdp(host, "cpu"), params, verbosity=0,
                            chunk_iterations=1)
    got = tsolve.run_solver(tsdp.build_device_sdp(host, "cpu"), params, verbosity=0,
                            chunk_iterations=3)
    assert str(ref.terminate_reason) == str(got.terminate_reason) == reason
    assert got.iterations == ref.iterations == stop
    _same_runs(got, ref)
    _same_states(got.state, ref.state)


def test_max_runtime_at_a_chunk_boundary():
    """maxRuntime 0: the host loop stops at its first check, the chunked
    loop after its first chunk, with the state advanced by it."""
    host = _random1()
    params = SolverParameters(precision=98, initial_matrix_scale_primal="1e2",
                              initial_matrix_scale_dual="1e2", max_iterations=12,
                              max_runtime=0)
    got = tsolve.run_solver(tsdp.build_device_sdp(host, "cpu"), params, verbosity=0,
                            chunk_iterations=3)
    assert str(got.terminate_reason) == "maxRuntime exceeded"
    assert got.iterations == 4 and len(got.history) == 3
    params.max_runtime = 10 ** 9
    params.max_iterations = 3
    ref = tsolve.run_solver(tsdp.build_device_sdp(host, "cpu"), params, verbosity=0,
                            chunk_iterations=1)
    _same_runs(got, ref, n_history=3)
    _same_states(got.state, ref.state)
    assert got.primal_objective == tsolve.host_mpf(ref.history[2].primal_objective)


def test_heal_matches_host_loop():
    """A KKT threshold no solve meets, the factor pinned at 2 of 3 limbs:
    both loops fail their first iteration, raise the factor to 3 limbs,
    replay from iteration 1 (the chunk's start, and the host loop's
    snapshot) and run on at the cap, to the same bits."""
    host = random_sdp(num_blocks=3, dim=1, num_points=4, dual_dim=3, K=3, seed=1)
    params = SolverParameters(precision=150, initial_matrix_scale_primal="1e2",
                              initial_matrix_scale_dual="1e2", factor_limbs=2,
                              kkt_residual_threshold="1e-300", max_iterations=3)
    ref = tsolve.run_solver(tsdp.build_device_sdp(host, "cpu"), params, verbosity=0,
                            chunk_iterations=1)
    got = tsolve.run_solver(tsdp.build_device_sdp(host, "cpu"), params, verbosity=0,
                            chunk_iterations=3)
    assert str(got.terminate_reason) == str(ref.terminate_reason) == "maxIterations exceeded"
    assert got.iterations == ref.iterations == 4 and len(got.history) == 5
    assert sorted(got.graphs) == [2, 3]
    _same_runs(got, ref)
    _same_states(got.state, ref.state)


def test_heal_at_the_cap_ends_the_run(capsys):
    """A failed iteration at the factor cap ends the run as
    maxComplementarity exceeded, with the JAX package's message, its state
    frozen at the failed iteration's input."""
    host = random_sdp(num_blocks=3, dim=1, num_points=4, dual_dim=3, K=2, seed=1)
    params = SolverParameters(precision=98, initial_matrix_scale_primal="1e2",
                              initial_matrix_scale_dual="1e2", max_iterations=12)
    sdp = tsdp.build_device_sdp(host, "cpu")
    real = tstep.Iteration.back
    calls = []

    def failing(self, sdp_, state, front, eigvals):
        calls.append(1)
        stats, new_state = real(self, sdp_, state, front, eigvals)
        if len(calls) == 5:
            stats = stats._replace(primal_step=stats.primal_step * float("nan"))
        return stats, new_state

    tstep.Iteration.back = failing
    try:
        got = tsolve.run_solver(sdp, params, verbosity=1, chunk_iterations=3)
    finally:
        tstep.Iteration.back = real
    out = capsys.readouterr().out
    assert "non-finite iteration at full factor precision; increase --precision" in out
    assert str(got.terminate_reason) == "maxComplementarity exceeded"
    assert got.iterations == 5 and len(got.history) == 5
    assert np.isnan(got.history[-1].primal_step)
    params.max_iterations = 4
    ref = tsolve.run_solver(tsdp.build_device_sdp(host, "cpu"), params, verbosity=0,
                            chunk_iterations=1)
    _same_runs(got, ref, n_history=4)
    _same_states(got.state, ref.state)


def test_non_finite_step_matrix_gives_nan_lambda():
    """eigvalsh refuses a non-finite matrix on the CPU and the card; the
    step-length input zeroes it and marks it, and its lambda reads NaN
    (what jnp.linalg.eigvalsh gives), so a failed iteration heals."""
    from sdpb_tpu_torch.ops import linalg

    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4, 4))
    a = a + np.swapaxes(a, -1, -2)
    limbs = np.zeros((2, 3, 4, 4))
    limbs[0] = a
    limbs[0, 1, 2, 1] = np.nan
    lam = linalg.min_eigenvalue_estimate(tmp.MP(torch.from_numpy(limbs)))
    want = np.linalg.eigvalsh(a[[0, 2]])[:, 0]
    assert torch.isnan(lam[1]) and np.allclose(lam[[0, 2]].numpy(), want, rtol=1e-13)


def _scaled_problem(K32):
    host = random_sdp(num_blocks=3, dim=2, num_points=4, dual_dim=3, K=4, seed=2)
    sdp = tsdp.build_device_sdp(host, "cpu", scaled_limbs=K32)
    parse = lambda s: str_to_scaled_limbs(s, K32)
    return sdp, parse


@pytest.mark.parametrize("rep", ["classic", "scaled", "wide"])
def test_body_makes_no_host_constant_after_warm_up(rep, monkeypatch):
    """What a CUDA graph replays cannot read a host buffer: after one
    warm-up call, the chunked body makes no tensor from host data."""
    if rep == "classic":
        host, params, K = _problem("cert_K3")
        sdp = tsdp.build_device_sdp(host, "cpu")
        parse = lambda s: str_to_limbs(s, K)
    else:
        if rep == "wide":
            monkeypatch.setattr(tmw, "wide_config", small_wide_config)
            monkeypatch.setattr(tmp, "MAX_SCALED_K", 5)
        sdp, parse = _scaled_problem(6 if rep == "wide" else 3)
    state = tstate.initial_state(sdp, parse("1e2"), parse("1e2"))
    cfg = tstep.StepConfig(
        total_psd_rows=sdp.total_psd_rows, gamma=0.7, feasible_beta_limbs=parse("0.1"),
        infeasible_beta_limbs=parse("0.3"), primal_error_threshold=1e-30,
        dual_error_threshold=1e-30, max_complementarity=1e100,
        factor_limbs=3, n_refine=1 if rep == "wide" else 0,
        duality_gap_threshold_limbs=parse("1e-30"), kkt_residual_threshold=1e-2)
    runner = graphs.ChunkRunner(sdp, cfg, state, tstep.CARRY_START, 1, 10)
    runner.run()

    def refuse(*args, **kw):
        raise AssertionError("a tensor made from host data inside the iteration")

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    rows = runner.run()
    assert rows[-1, 0] == 3.0 and rows[0, -1] == 1.0
