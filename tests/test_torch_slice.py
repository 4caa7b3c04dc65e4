"""The port's sdpb slice (one interior-point iteration, the host run loop,
the CLI) against the JAX package on the CPU; its problem staging and
initial state are held equal to the JAX package's in test_torch_build.py,
with this file's bucket comparisons.

Tolerances:
  * one iteration from the same problem and state (carried across with
    sdpb_tpu_torch.interop): the MP statistics computed before the step
    (objectives, gap, mu) within 2^-(53K-20) relative; the error norms,
    step lengths, corrector beta, KKT residual and the next state within
    1e-12 relative.  The step lengths come from a float64 eigvalsh whose
    LAPACK calls differ between the packages, and the port's matmul,
    factor and solves run the Pallas kernels' order, not the XLA path's.
  * five free-running iterations through each package's host loop: every
    IterationStats field within 1e-8 relative, the same terminate reason.
  * the CLI's out.txt: objectives within 1e-8 relative of the JAX run's.
  * the scaled representation (float32 limbs, int32 exponents): the JAX
    package's scaled iteration takes minutes to compile for the CPU, so
    one scaled iteration (K32 = 3, 72 bits) is run from the JAX classic
    state rounded into scaled parts and held to
    the JAX classic iteration from that state: MP statistics within
    2^-(24K-24) relative, step lengths and the next state within 1e-12
    relative (both packages take the steps from float64 matrices, which
    the rounding into 72 bits moves by an ulp here and there), error
    norms (float32 in the scaled run) within 2^-20 relative; and the
    scaled CLI's out.txt after 3 iterations within 1e-12 relative of the
    JAX classic run's objectives.
  * the wide representation (two scaled words): one wide iteration (two
    words of Kg = 3 limbs, 144 bits, through a widened wide_config; the
    JAX wide iteration compiles for far too long
    on the CPU) from the JAX classic state rounded into wide parts, held to
    the JAX classic iteration (159 bits): MP statistics within
    2^-(PREC-24) relative, step lengths and the next state within 1e-12
    relative, float32 error norms within 2^-20.  The CLI at --precision 216
    takes two words of 5 limbs on the CPU.
Quantities that sit at the rounding floor of the arithmetic (residuals
of an exact step, ~2^-53K) are compared with an absolute floor of
2^-(53K-40) in place of the relative bound, since their last bits are
rounding noise in either package.
"""
import functools
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import mpmath
import numpy as np
import pytest
import torch

import jax

from sdpb_tpu.io.sdp_zip import read_sdp
from sdpb_tpu.io.solution import save_solution as jax_save_solution
from sdpb_tpu.models import sdp as jsdp
from sdpb_tpu.models.synthetic import random_sdp
from sdpb_tpu.solver import solve as jsolve, state as jstate, step as jstep
from sdpb_tpu.solver.params import SolverParameters
from sdpb_tpu.utils.strings import limbs_to_mpf, str_to_limbs
from sdpb_tpu.ops import mpfloat as jmp
from sdpb_tpu_torch import interop
from sdpb_tpu_torch.models import sdp as tsdp
from sdpb_tpu_torch.ops import mpfloat as tmp
from sdpb_tpu_torch.solver import solve as tsolve, state as tstate, step as tstep
from sdpb_tpu_torch.utils.strings import scaled_limbs_to_mpf, str_to_scaled_limbs

from sdpb_tpu.ops import mpwide as jmw
from sdpb_tpu_torch.ops import mpwide as tmw

from torch_parity import (limbs_of, parts_of, rel_err, same_scaled, same_wide,
                          scaled_rel_err, small_wide_config)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LADDER = REPO / "fixtures" / "ising_ladder_120" / "sdp.zip"
CERTIFICATE = REPO / "fixtures" / "dim2_certificate" / "sdp.zip"

# (kind, dim, K, factor_limbs); factor 2 at K = 3 exercises refinement
PROBLEMS = {
    "dim1_K2": ("random", 1, 2, 0),
    "dim1_K3": ("random", 1, 3, 2),
    "dim2_K2": ("random", 2, 2, 0),
    "dim2_K3": ("random", 2, 3, 2),
    "cert_K3": ("certificate", 2, 3, 0),
}


def _floor(K):
    return 2.0 ** -(53 * K - 40)


@functools.lru_cache(maxsize=None)
def _certificate_zip():
    from test_dim2_certificate import PMP
    from sdpb_tpu.cli.sdp2input import convert

    d = Path(tempfile.mkdtemp(prefix="sdpb_torch_cert_"))
    (d / "dim2.json").write_text(json.dumps(PMP))
    convert(d / "dim2.json", d / "sdp.zip", 400, "json")
    return d / "sdp.zip"


def _problem(name):
    kind, dim, K, factor = PROBLEMS[name]
    if kind == "random":
        host = random_sdp(num_blocks=3, dim=dim, num_points=4, dual_dim=3, K=K,
                          seed=dim)
        params = SolverParameters(
            precision=53 * K - 8, initial_matrix_scale_primal="1e2",
            initial_matrix_scale_dual="1e2", factor_limbs=factor)
    else:
        host = read_sdp(_certificate_zip(), K, np.float64)
        params = SolverParameters(
            precision=150, duality_gap_threshold="1e-12",
            primal_error_threshold="1e-12", dual_error_threshold="1e-12",
            initial_matrix_scale_primal="1e2", initial_matrix_scale_dual="1e2")
    return host, params, K


def _jax_cfg(sdp, params, K):
    """The StepConfig the JAX host loop builds (solve.py:175-201), so the
    compiled iteration is shared with run_solver through the persistent
    compilation cache."""
    parse = lambda s: str_to_limbs(s, K, np.float64)
    kf, cap = jsolve.initial_factor_limbs(params, K, False, np.float64)
    f = lambda s: float(mpmath.mpf(s))
    return jstep.StepConfig(
        kkt_residual_threshold=f(params.kkt_residual_threshold),
        kkt_heal=kf < cap, total_psd_rows=sdp.total_psd_rows, axis=None,
        factor_limbs=kf, n_refine=0 if K <= kf else -(-K // kf),
        gamma=f(params.step_length_reduction),
        feasible_beta_limbs=parse(params.feasible_centering_parameter),
        infeasible_beta_limbs=parse(params.infeasible_centering_parameter),
        primal_error_threshold=f(params.primal_error_threshold),
        dual_error_threshold=f(params.dual_error_threshold),
        max_complementarity=f(params.max_complementarity),
        duality_gap_threshold_limbs=parse(params.duality_gap_threshold),
        find_primal_feasible=params.find_primal_feasible,
        find_dual_feasible=params.find_dual_feasible,
        detect_primal_feasible_jump=params.detect_primal_feasible_jump,
        detect_dual_feasible_jump=params.detect_dual_feasible_jump,
        min_primal_step=f(params.min_primal_step),
        min_dual_step=f(params.min_dual_step))


@functools.lru_cache(maxsize=None)
def _jax_iteration(name):
    """The JAX package's jitted iteration for a problem (compiled once per
    test process and shared by every test of that problem)."""
    host, params, K = _problem(name)
    sdp = jsdp.build_device_sdp(host)
    return sdp, jax.jit(jstep.make_iteration(_jax_cfg(sdp, params, K)))


@functools.lru_cache(maxsize=None)
def _jax_two_iterations(name):
    """JAX: state 1 (after one iteration from the initial state), and the
    statistics and state of the iteration from state 1."""
    _, params, K = _problem(name)
    sdp, it = _jax_iteration(name)
    parse = lambda s: str_to_limbs(s, K, np.float64)
    st0 = jstate.initial_state(sdp, parse(params.initial_matrix_scale_primal),
                               parse(params.initial_matrix_scale_dual))
    _, st1 = it(sdp, st0)
    s2, st2 = it(sdp, st1)
    tree = lambda x: jax.tree.map(np.asarray, x)
    return tree(sdp), tree(st1), tree(s2), tree(st2)


def _cmp(name, got, want, rel, floor, is_mp=False):
    """|got - want| <= rel * max|want|, or below the absolute floor.  MP
    limb stacks are differenced at full MP precision."""
    got, want = limbs_of(got), limbs_of(want)
    if is_mp:
        err = rel_err(got, want)
        scale = float(np.max(np.abs(want[0] + want[1]))) if want.size else 0.0
        err *= scale or 1.0
    else:
        err = float(np.max(np.abs(got - want))) if got.size else 0.0
        scale = float(np.max(np.abs(want))) if want.size else 0.0
    assert err <= rel * scale or err <= floor, (name, err, scale)


def _assert_buckets_equal(port, ref):
    assert len(port.buckets) == len(ref.buckets)
    assert np.array_equal(limbs_of(port.b), limbs_of(ref.b))
    assert np.array_equal(limbs_of(port.objective_const), limbs_of(ref.objective_const))
    assert port.total_psd_rows == ref.total_psd_rows
    for pb, rb in zip(port.buckets, ref.buckets):
        assert (pb.shape.dim, pb.shape.num_points, pb.shape.h_even, pb.shape.h_odd) == \
            (rb.shape.dim, rb.shape.num_points, rb.shape.h_even, rb.shape.h_odd)
        assert [tuple(vars(r).values()) for r in pb.real_sizes] == \
            [tuple(vars(r).values()) for r in rb.real_sizes]
        for f in ("bases_even", "bases_odd", "emb_even", "emb_odd", "Bmat", "c",
                  "mask", "row_mask", "psd_mask_even", "psd_mask_odd"):
            a, b = limbs_of(getattr(pb, f)), limbs_of(getattr(rb, f))
            assert a.shape == b.shape and np.array_equal(a, b), f


def _assert_scaled_buckets_equal(port, ref):
    """Layout, masks, limbs and exponents equal."""
    assert len(port.buckets) == len(ref.buckets)
    assert same_scaled(port.b, ref.b) and same_scaled(port.objective_const,
                                                      ref.objective_const)
    for pb, rb in zip(port.buckets, ref.buckets):
        assert (pb.shape.dim, pb.shape.num_points, pb.shape.h_even, pb.shape.h_odd) == \
            (rb.shape.dim, rb.shape.num_points, rb.shape.h_even, rb.shape.h_odd)
        for f in ("bases_even", "bases_odd", "emb_even", "emb_odd", "Bmat", "c"):
            assert same_scaled(getattr(pb, f), getattr(rb, f)), f
        for f in ("mask", "row_mask", "psd_mask_even", "psd_mask_odd"):
            a, b = getattr(pb, f).numpy(), np.asarray(getattr(rb, f))
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), f


def _assert_wide_buckets_equal(port, ref):
    """Layout, masks, and every word's limbs and exponents equal."""
    assert len(port.buckets) == len(ref.buckets)
    assert isinstance(port.b, tmw.MPW) and port.b.G == ref.b.G == 2
    assert same_wide(port.b, ref.b) and same_wide(port.objective_const,
                                                  ref.objective_const)
    for pb, rb in zip(port.buckets, ref.buckets):
        for f in ("bases_even", "bases_odd", "emb_even", "emb_odd", "Bmat", "c"):
            assert same_wide(getattr(pb, f), getattr(rb, f)), f
        for f in ("mask", "row_mask", "psd_mask_even", "psd_mask_odd"):
            a, b = getattr(pb, f).numpy(), np.asarray(getattr(rb, f))
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), f


def test_one_wide_iteration_from_jax_classic_state(monkeypatch):
    """The port's wide iteration (two words of Kg = 3 limbs) from the JAX
    classic state after one iteration of the smallest random problem,
    rounded into wide parts, against the JAX classic iteration from that
    state (tolerances in the module docstring)."""
    monkeypatch.setattr(tmp, "MAX_SCALED_K", 5)
    monkeypatch.setattr(tmw, "wide_config", small_wide_config)
    Kw = 6
    host, params, K = _problem("dim1_K3")
    sdp_np, st1_np, s2, st2 = _jax_two_iterations("dim1_K3")
    sdp = interop.device_sdp_from_numpy(sdp_np, "cpu")
    wide = lambda x: tmw.wide_parts_to_mp(tmw.f64_limbs_to_wide_parts(limbs_of(x), Kw),
                                          "cpu")
    sdp = tsdp.DeviceSDP(objective_const=wide(sdp.objective_const), b=wide(sdp.b),
                         buckets=[tsdp.Bucket(**{
                             **{f: wide(getattr(bk, f)) for f in (
                                 "bases_even", "bases_odd", "emb_even", "emb_odd",
                                 "Bmat", "c")},
                             **{f: getattr(bk, f).to(torch.float32) for f in (
                                 "mask", "row_mask", "psd_mask_even", "psd_mask_odd")},
                             "real_sizes": bk.real_sizes, "shape": bk.shape})
                             for bk in sdp.buckets])
    st1 = tstate.SolverState(
        y=wide(st1_np.y.limbs),
        buckets=[tstate.BucketState(*(wide(getattr(bs, f).limbs) for f in (
            "x", "X_even", "X_odd", "Y_even", "Y_odd"))) for bs in st1_np.buckets])
    jcfg = _jax_cfg(sdp_np, params, K)
    parse = lambda v: str_to_scaled_limbs(v, Kw)
    assert isinstance(parse("0.3"), list)
    tcfg = tstep.StepConfig(
        total_psd_rows=sdp.total_psd_rows, gamma=jcfg.gamma,
        feasible_beta_limbs=parse(params.feasible_centering_parameter),
        infeasible_beta_limbs=parse(params.infeasible_centering_parameter),
        primal_error_threshold=jcfg.primal_error_threshold,
        dual_error_threshold=jcfg.dual_error_threshold,
        max_complementarity=jcfg.max_complementarity,
        factor_limbs=3, n_refine=2, kkt_residual_threshold=jcfg.kkt_residual_threshold,
        kkt_heal=False)
    stats, new = tstep.make_iteration(tcfg)(sdp, st1)
    h = tsolve.to_host(stats)
    assert isinstance(h.mu, list) and len(h.mu) == 2
    with mpmath.workprec(300):
        for f in ("primal_objective", "dual_objective", "duality_gap", "mu"):
            mine, ref = tsolve.host_mpf(getattr(h, f)), limbs_to_mpf(getattr(s2, f).limbs)
            assert abs(mine - ref) <= mpmath.mpf(2) ** -(24 * Kw - 24) * abs(ref), f
    for f in ("primal_step", "dual_step"):
        _cmp(f, getattr(h, f), getattr(s2, f), 1e-12, 0.0)
    for f in ("primal_error_P", "primal_error_p", "dual_error"):
        _cmp(f, getattr(h, f), getattr(s2, f), 2.0 ** -20, 2.0 ** -(24 * Kw - 40))
    assert h.is_pd_feasible == bool(s2.is_pd_feasible)
    back = lambda m: tmp.host_f64_limbs(m, K)
    _cmp("y", back(new.y), st2.y.limbs, 1e-12, 2.0 ** -(24 * Kw - 40), True)
    for gb, jb in zip(new.buckets, st2.buckets):
        for f in ("x", "X_even", "X_odd", "Y_even", "Y_odd"):
            _cmp(f, back(getattr(gb, f)), getattr(jb, f).limbs, 1e-12,
                 2.0 ** -(24 * Kw - 40), True)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_one_iteration_from_identical_state(name):
    _, params, K = _problem(name)
    sdp_np, st1_np, s2, st2 = _jax_two_iterations(name)
    sdp = interop.device_sdp_from_numpy(sdp_np, "cpu")
    st1 = interop.state_from_numpy(st1_np, "cpu")
    cfg = _jax_cfg(sdp_np, params, K)
    tcfg = tstep.StepConfig(
        total_psd_rows=sdp.total_psd_rows, gamma=cfg.gamma,
        feasible_beta_limbs=cfg.feasible_beta_limbs,
        infeasible_beta_limbs=cfg.infeasible_beta_limbs,
        primal_error_threshold=cfg.primal_error_threshold,
        dual_error_threshold=cfg.dual_error_threshold,
        max_complementarity=cfg.max_complementarity,
        factor_limbs=cfg.factor_limbs, n_refine=cfg.n_refine,
        kkt_residual_threshold=cfg.kkt_residual_threshold, kkt_heal=cfg.kkt_heal)
    stats, new = tstep.make_iteration(tcfg)(sdp, st1)
    h = tsolve.to_host(stats)
    bound = mpmath.mpf(2) ** -(53 * K - 20)
    with mpmath.workprec(60 * K + 64):
        for f, exact in _exact_mp_stats(sdp_np, st1_np).items():
            mine, ref = limbs_to_mpf(getattr(h, f)), limbs_to_mpf(getattr(s2, f).limbs)
            tol = bound * abs(exact) + _floor(K)
            # the port is right, and agrees with JAX unless JAX is not
            assert abs(mine - exact) <= tol, (f, mine, exact)
            assert abs(mine - ref) <= tol or abs(ref - exact) > tol, (f, mine, ref)
    for f in ("primal_error_P", "primal_error_p", "dual_error", "primal_step",
              "dual_step", "beta_corrector", "kkt_residual"):
        _cmp(f, getattr(h, f), getattr(s2, f), 1e-12, _floor(K))
    assert h.is_pd_feasible == bool(s2.is_pd_feasible)
    _cmp("y", new.y, st2.y.limbs, 1e-12, _floor(K), True)
    for gb, jb in zip(new.buckets, st2.buckets):
        for f in ("x", "X_even", "X_odd", "Y_even", "Y_odd"):
            _cmp(f, getattr(gb, f), getattr(jb, f).limbs, 1e-12, _floor(K), True)


def _to_scaled(x, K32):
    return tmp.from_parts(*tmp.f64_limbs_to_scaled_parts(limbs_of(x), K32), "cpu")


def test_one_scaled_iteration_from_jax_classic_state():
    """The port's scaled iteration (K32 = 3) from the JAX classic state
    after one iteration of the certificate, rounded into scaled parts,
    against the JAX classic iteration from that state (tolerances in the
    module docstring)."""
    K32 = 3
    host, params, K = _problem("cert_K3")
    sdp_np, st1_np, s2, st2 = _jax_two_iterations("cert_K3")
    sdp = tsdp.build_device_sdp(host, "cpu", scaled_limbs=K32)
    st1 = tstate.SolverState(
        y=_to_scaled(st1_np.y.limbs, K32),
        buckets=[tstate.BucketState(*(_to_scaled(getattr(bs, f).limbs, K32) for f in (
            "x", "X_even", "X_odd", "Y_even", "Y_odd"))) for bs in st1_np.buckets])
    kf, _ = tsolve.initial_factor_limbs(params, K32, scaled=True)
    jcfg = _jax_cfg(sdp_np, params, K)
    parse = lambda v: str_to_scaled_limbs(v, K32)
    tcfg = tstep.StepConfig(
        total_psd_rows=sdp.total_psd_rows, gamma=jcfg.gamma,
        feasible_beta_limbs=parse(params.feasible_centering_parameter),
        infeasible_beta_limbs=parse(params.infeasible_centering_parameter),
        primal_error_threshold=jcfg.primal_error_threshold,
        dual_error_threshold=jcfg.dual_error_threshold,
        max_complementarity=jcfg.max_complementarity,
        factor_limbs=kf, n_refine=0 if K32 <= kf else -(-K32 // kf),
        kkt_residual_threshold=jcfg.kkt_residual_threshold, kkt_heal=False)
    stats, new = tstep.make_iteration(tcfg)(sdp, st1)
    h = tsolve.to_host(stats)
    with mpmath.workprec(200):
        for f in ("primal_objective", "dual_objective", "duality_gap", "mu"):
            mine, ref = tsolve.host_mpf(getattr(h, f)), limbs_to_mpf(getattr(s2, f).limbs)
            assert abs(mine - ref) <= mpmath.mpf(2) ** -(24 * K32 - 24) * abs(ref), f
    for f in ("primal_step", "dual_step"):
        _cmp(f, getattr(h, f), getattr(s2, f), 1e-12, 0.0)
    for f in ("primal_error_P", "primal_error_p", "dual_error"):
        _cmp(f, getattr(h, f), getattr(s2, f), 2.0 ** -20, 2.0 ** -(24 * K32 - 40))
    assert h.is_pd_feasible == bool(s2.is_pd_feasible)
    back = lambda m: tmp.host_f64_limbs(m, K)
    _cmp("y", back(new.y), st2.y.limbs, 1e-12, 2.0 ** -(24 * K32 - 40), True)
    for gb, jb in zip(new.buckets, st2.buckets):
        for f in ("x", "X_even", "X_odd", "Y_even", "Y_odd"):
            _cmp(f, back(getattr(gb, f)), getattr(jb, f).limbs, 1e-12,
                 2.0 ** -(24 * K32 - 40), True)


def _exact_mp_stats(sdp, st):
    """Objectives, gap and mu of a state, exactly (mpmath) from its limbs."""
    val = lambda limbs: limbs_to_mpf(limbs)
    oc = val(sdp.objective_const.limbs)
    p_obj = oc
    mu_num = mpmath.mpf(0)
    for bk, bs in zip(sdp.buckets, st.buckets):
        c, x = bk.c.limbs, bs.x.limbs
        for b, p in zip(*np.nonzero(bk.row_mask)):
            p_obj += val(c[:, b, p]) * val(x[:, b, p])
        for m, X, Y in ((bk.psd_mask_even, bs.X_even, bs.Y_even),
                        (bk.psd_mask_odd, bs.X_odd, bs.Y_odd)):
            om = m[:, :, None] * m[:, None, :]
            for b, i, j in zip(*np.nonzero(om)):
                mu_num += val(X.limbs[:, b, i, j]) * val(Y.limbs[:, b, i, j])
    d_obj = oc + mpmath.fsum(val(sdp.b.limbs[:, n]) * val(st.y.limbs[:, n])
                             for n in range(sdp.b.limbs.shape[1]))
    gap = abs(p_obj - d_obj) / max(abs(p_obj) + abs(d_obj), 1)
    return {"primal_objective": p_obj, "dual_objective": d_obj,
            "duality_gap": gap, "mu": mu_num / sdp.total_psd_rows}


class _RecordingJax:
    """Stands in for the `jax` module inside sdpb_tpu.solver.solve: keeps
    every host copy of the iteration statistics its loop makes, and hands
    its first jit the iteration already compiled for the same config (a
    factor bump's new config compiles normally)."""

    def __init__(self, compiled):
        self.rows = []
        self.compiled = compiled

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        compiled, self.compiled = self.compiled, None
        return compiled if compiled is not None else jax.jit(fn, **kw)

    def device_get(self, x):
        h = jax.device_get(x)
        self.rows.append(h)
        return h


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_five_iterations_match_host_loop(name, monkeypatch):
    host, params, K = _problem(name)
    params.max_iterations = 5
    rec = _RecordingJax(_jax_iteration(name)[1])
    monkeypatch.setattr(jsolve, "jax", rec)
    jres = jsolve.run_solver(jsdp.build_device_sdp(host), params, verbosity=0,
                             chunk_iterations=1)
    tres = tsolve.run_solver(tsdp.build_device_sdp(host, "cpu"), params,
                             verbosity=0, chunk_iterations=1)
    assert str(tres.terminate_reason) == str(jres.terminate_reason)
    assert tres.iterations == jres.iterations
    assert len(tres.history) == len(rec.rows) == 6
    for i, (mine, ref) in enumerate(zip(tres.history, rec.rows)):
        for f in mine._fields:
            want = getattr(ref, f)
            _cmp(f"iteration {i + 1} {f}", getattr(mine, f), want, 1e-8,
                 _floor(K), hasattr(want, "limbs"))


def test_cli_on_cpu_matches_jax(tmp_path, monkeypatch):
    """python -m sdpb_tpu_torch.cli.sdpb --device cpu on the certificate SDP
    for 3 iterations; the JAX side is the same host loop + save_solution
    the JAX CLI runs (chunk_iterations=1, sharing the compiled iteration)."""
    sdp_zip = _certificate_zip()
    args = ["-s", str(sdp_zip), "--precision", "150", "--maxIterations", "3",
            "--dualityGapThreshold", "1e-12", "--primalErrorThreshold", "1e-12",
            "--dualErrorThreshold", "1e-12", "--initialMatrixScalePrimal", "1e2",
            "--initialMatrixScaleDual", "1e2"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "sdpb_tpu_torch.cli.sdpb", "--device", "cpu",
         "-o", str(tmp_path / "port"), "-c", str(tmp_path / "ck"), *args],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "maxIterations exceeded" in proc.stdout
    assert f"Saving checkpoint to    : {tmp_path / 'ck'}" in proc.stdout
    assert (tmp_path / "ck" / "checkpoint_0.npz").exists()

    monkeypatch.setattr(jsolve, "jax", _RecordingJax(_jax_iteration("cert_K3")[1]))
    _, params, K = _problem("cert_K3")
    params.max_iterations = 3
    jsdp_ = jsdp.build_device_sdp(read_sdp(sdp_zip, K, np.float64))
    jres = jsolve.run_solver(jsdp_, params, verbosity=0, chunk_iterations=1)
    jax_save_solution(tmp_path / "jax", jres, jsdp_, verbosity=0)

    def values(path):
        out = {}
        for line in (path / "out.txt").read_text().splitlines():
            key, val = line.rstrip(";").split("=", 1)
            out[key.strip()] = val.strip().strip('"')
        return out

    mine, ref = values(tmp_path / "port"), values(tmp_path / "jax")
    assert mine["terminateReason"] == ref["terminateReason"]
    with mpmath.workprec(200):
        for key in ("primalObjective", "dualObjective"):
            a, b = mpmath.mpf(mine[key]), mpmath.mpf(ref[key])
            assert abs(a - b) <= mpmath.mpf("1e-8") * abs(b), key
    assert (tmp_path / "port" / "y.txt").read_text().splitlines()[0] == "1 1"


def _out_values(path):
    out = {}
    for line in (path / "out.txt").read_text().splitlines():
        key, val = line.rstrip(";").split("=", 1)
        out[key.strip()] = val.strip().strip('"')
    return out


def test_scaled_cli_on_cpu_matches_jax(tmp_path, monkeypatch):
    """python -m sdpb_tpu_torch.cli.sdpb --arithmetic scaled --device cpu on
    the certificate SDP at 64 bits (3 float32 limbs), 3 iterations, against
    the JAX classic run of test_cli_on_cpu_matches_jax (the JAX scaled
    iteration takes minutes to compile for the CPU)."""
    sdp_zip = _certificate_zip()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "sdpb_tpu_torch.cli.sdpb", "--device", "cpu",
         "--arithmetic", "scaled", "-s", str(sdp_zip), "-o", str(tmp_path / "port"),
         "-c", str(tmp_path / "ck"), "--precision", "64", "--maxIterations", "3", "--dualityGapThreshold", "1e-12",
         "--primalErrorThreshold", "1e-12", "--dualErrorThreshold", "1e-12",
         "--initialMatrixScalePrimal", "1e2", "--initialMatrixScaleDual", "1e2"],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "precision       : 64 bits (3 scaled float32 limbs + exponent)" in proc.stdout
    assert "maxIterations exceeded" in proc.stdout

    monkeypatch.setattr(jsolve, "jax", _RecordingJax(_jax_iteration("cert_K3")[1]))
    _, params, K = _problem("cert_K3")
    params.max_iterations = 3
    jsdp_ = jsdp.build_device_sdp(read_sdp(sdp_zip, K, np.float64))
    jres = jsolve.run_solver(jsdp_, params, verbosity=0, chunk_iterations=1)
    jax_save_solution(tmp_path / "jax", jres, jsdp_, verbosity=0)

    mine, ref = _out_values(tmp_path / "port"), _out_values(tmp_path / "jax")
    assert mine["terminateReason"] == ref["terminateReason"]
    assert len(mine["primalObjective"].lstrip("-").split("e")[0]) - 1 == 22  # digits of 72 bits
    with mpmath.workprec(200):
        for key in ("primalObjective", "dualObjective"):
            a, b = mpmath.mpf(mine[key]), mpmath.mpf(ref[key])
            assert abs(a - b) <= mpmath.mpf("1e-12") * abs(b), key
    assert (tmp_path / "port" / "y.txt").read_text().splitlines()[0] == "1 1"


def test_scaled_cli_refuses_the_wide_path_and_a_missing_card(tmp_path):
    """Above 27 float32 limbs (--precision > 640, past three wide words)
    the scaled CLI stops and names the limit; --device cuda without CUDA
    stops too."""
    from sdpb_tpu_torch.cli import sdpb as cli

    assert cli.limbs_for_precision(208, 24) == 9
    assert cli.limbs_for_precision(209, 24) == 10
    assert cli.limbs_for_precision(424, 24) == 18
    assert cli.limbs_for_precision(425, 24) == 19
    assert cli.limbs_for_precision(640, 24) == 27
    assert cli.limbs_for_precision(641, 24) == 28
    for prec in ("641", "700"):
        with pytest.raises(SystemExit, match="at most 27"):
            cli.run(["-s", str(CERTIFICATE), "-c", str(tmp_path / "ck"), "--arithmetic",
                     "scaled", "--device", "cpu", "--precision", prec])
    if not torch.cuda.is_available():
        for arith in ("classic", "scaled"):
            with pytest.raises(SystemExit, match="CUDA is not available"):
                cli.run(["-s", str(CERTIFICATE), "-c", str(tmp_path / "ck"),
                         "--arithmetic", arith])


def test_wide_cli_on_cpu(tmp_path):
    """python -m sdpb_tpu_torch.cli.sdpb --arithmetic scaled --precision 216
    --device cpu (two words of 5 float32 limbs) on a small random SDP for
    one iteration: the two-word banner, out.txt at the wide digit count.
    The factor is pinned at 3 limbs (4 refinement passes): the plain
    factorizations at the default 9 limbs would take a minute here."""
    from sdpb_tpu.io.sdp_zip import write_sdp

    write_sdp(tmp_path / "sdp.zip", random_sdp(num_blocks=2, dim=1, num_points=3,
                                                dual_dim=2, K=6, seed=3))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "sdpb_tpu_torch.cli.sdpb", "--device", "cpu",
         "--arithmetic", "scaled", "-s", str(tmp_path / "sdp.zip"),
         "-o", str(tmp_path / "out"), "-c", str(tmp_path / "ck"), "--timingRun", "never",
         "--precision", "216", "--maxIterations", "1",
         "--initialMatrixScalePrimal", "1e2", "--initialMatrixScaleDual", "1e2",
         "--factorLimbs", "3"],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "precision       : 216 bits (2 words × 5 scaled float32 limbs)" in proc.stdout
    assert "maxIterations exceeded" in proc.stdout
    out = _out_values(tmp_path / "out")
    assert len(out["primalObjective"].lstrip("-").split("e")[0]) - 1 == 73  # 240 bits
    assert (tmp_path / "out" / "y.txt").read_text().splitlines()[0] == "2 1"


def test_committed_certificate_matches_sdp2input():
    """fixtures/dim2_certificate/sdp.zip (what chip_smoke.py and the port's
    tests read, so that the port never runs the JAX converter) is what
    sdpb_tpu.cli.sdp2input makes from the certificate PMP at 400 bits."""
    from sdpb_tpu_torch.io.sdp_zip import read_sdp as port_read_sdp

    fresh = _certificate_zip()
    for K in (3, 8):
        for a, b in ((port_read_sdp(CERTIFICATE, K), read_sdp(fresh, K, np.float64)),
                     (read_sdp(CERTIFICATE, K, np.float64), read_sdp(fresh, K, np.float64))):
            assert np.array_equal(a.objective_const, b.objective_const)
            assert np.array_equal(a.b, b.b) and len(a.blocks) == len(b.blocks) == 1
            for x, y in zip(a.blocks, b.blocks):
                assert (x.index, x.dim, x.num_points) == (y.index, y.dim, y.num_points)
                for f in ("bases_even", "bases_odd", "c", "B"):
                    assert np.array_equal(getattr(x, f), getattr(y, f)), f


def test_kkt_guard_heals_then_warns(capsys):
    """A KKT threshold no solve can meet trips the guard on every
    iteration: below the factor cap the host loop bumps the factor
    precision and replays from its snapshot; at the cap it warns once and
    goes on to the normal termination."""
    host = random_sdp(num_blocks=3, dim=1, num_points=4, dual_dim=3, K=3, seed=1)
    params = SolverParameters(
        precision=150, initial_matrix_scale_primal="1e2",
        initial_matrix_scale_dual="1e2", factor_limbs=2,
        kkt_residual_threshold="1e-300", max_iterations=2)
    res = tsolve.run_solver(tsdp.build_device_sdp(host, "cpu"), params)
    out = capsys.readouterr().out
    assert "increasing factor precision to 3 limbs (replaying from iteration 1)" in out
    assert out.count("WARNING: KKT solve residual") == 1
    assert str(res.terminate_reason) == "maxIterations exceeded"
    assert len(res.history) == 4    # one healed + three at the cap


def test_cli_refuses_what_is_not_ported(tmp_path):
    """A run of several processes needs all of its flags, and stops at a
    block above --maxBlockMemory (row sharding, ROADMAP A25)."""
    from sdpb_tpu_torch.cli import sdpb as cli
    from sdpb_tpu_torch.parallel.mesh import check_block_memory

    with pytest.raises(SystemExit, match="needs --coordinator, --processId too"):
        cli.run(["-s", str(LADDER), "-c", str(tmp_path / "ck"), "--device", "cpu",
                 "--numProcesses", "2"])
    sdp = tsdp.build_device_sdp(random_sdp(num_blocks=2, dim=2, num_points=3, dual_dim=3,
                                           K=2, seed=1), "cpu", pad_to=2)
    check_block_memory(sdp, 1 << 30)
    with pytest.raises(SystemExit, match="ROADMAP A25"):
        check_block_memory(sdp, 4096)


_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys

class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sdpb_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocked())
import sdpb_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sdpb_tpu_torch.__path__, "sdpb_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("parallel.planner", "parallel.timing", "parallel.distributed",
             "parallel.mesh", "io.ref_checkpoint", "solver.checkpoint",
             "cli.approx_objective", "cli.outer_limits", "cli.sdp2functions",
             "tools.approx_objective", "tools.outer_limits", "tools.functions",
             "tools.mesh", "tools.spectrum", "convert.pmp", "convert.poly",
             "cli.sdp2input", "cli.pvm2sdp", "cli.pvm2functions", "cli.spectrum",
             "cli.block_grid_mapping", "convert.dual_constraint_group",
             "convert.mathematica", "convert.xml_input", "tools.gen_pmp",
             "tools.write_bootstrap_sdp", "models.synthetic"):
    assert "sdpb_tpu_torch." + name in names, name
from sdpb_tpu_torch.cli import sdpb as cli
for arith in ("classic", "scaled"):
    res = cli.run(["-s", sys.argv[1], "-o", sys.argv[2] + "/" + arith, "--device", "cpu",
                   "-c", sys.argv[2] + "/" + arith + ".ck", "--precision", "64",
                   "--arithmetic", arith, "--maxIterations", "2", "--verbosity", "0",
                   "--writeSolution", "x,y,X,Y"])
    assert str(res.terminate_reason) == "maxIterations exceeded", res.terminate_reason
# approx_objective from that state (the problem against itself: no change),
# and sdp2functions on the certificate's PMP
from sdpb_tpu_torch.cli import approx_objective, sdp2functions
out = approx_objective.run(["--sdp", sys.argv[1], "--newSdp", sys.argv[1], "--precision",
                            "64", "--solutionDir", sys.argv[2] + "/classic", "--device", "cpu"])
assert float(out[0]["d_objective"]) == 0.0 == float(out[0]["dd_objective"]), out
assert sdp2functions.main(["-i", sys.argv[3], "-o", sys.argv[2] + "/f.json",
                           "--precision", "64"]) == 0
# a resume from the checkpoint, and the timing run on a two-block problem
from sdpb_tpu_torch.solver.checkpoint import load_checkpoint
from sdpb_tpu_torch.parallel.timing import timing_run
from sdpb_tpu_torch.io.sdp_zip import read_sdp
from sdpb_tpu_torch.models.sdp import build_device_sdp
host = read_sdp(sys.argv[1], 2)
assert load_checkpoint(sys.argv[2] + "/classic.ck", build_device_sdp(host, "cpu"),
                       verbosity=0) is not None
host.blocks.append(host.blocks[0])
params = cli.solver_params_from_args(cli.build_parser().parse_args(["-s", sys.argv[1]]))
assert timing_run(host, params, "cpu", verbosity=0)["chosen"]["policy"] in ("quantized", "exact")
# the front and back ends of a bootstrap study: sdp2input of the certificate
# gives the committed zip, gen_pmp, pvm2sdp of a port-written XML, spectrum
# of the toy PMP (sys.argv[4]) from a 2-iteration solve, block_grid_mapping
import json
import mpmath
from pathlib import Path
from sdpb_tpu_torch.cli import block_grid_mapping, pvm2sdp, sdp2input, spectrum
from sdpb_tpu_torch.convert.pmp import read_pmp_input
from sdpb_tpu_torch.io.sdp_zip import entries
from sdpb_tpu_torch.tools import gen_pmp, write_bootstrap_sdp
tmp = Path(sys.argv[2])
assert sdp2input.main(["-i", sys.argv[3], "-o", str(tmp / "cert.zip"), "--precision", "400",
                       "--outputFormat", "json"]) == 0
assert list(entries(tmp / "cert.zip").items()) == list(entries(sys.argv[1]).items())
assert gen_pmp.main(["--blocks", "2", "--dim", "2", "--dual", "3", "--degree", "4",
                     "--solvable", "-o", str(tmp / "gen.json")]) == 0
with mpmath.workprec(64):
    write_bootstrap_sdp.write_bootstrap_sdp(tmp / "cert.xml", *read_pmp_input(sys.argv[3]))
assert pvm2sdp.main(["bin", "64", str(tmp / "cert.xml"), str(tmp / "pvm.zip")]) == 0
assert read_sdp(tmp / "pvm.zip", 2).blocks[0].B.shape == read_sdp(sys.argv[1], 2).blocks[0].B.shape
assert sdp2input.main(["-i", sys.argv[4], "-o", str(tmp / "toy.zip"), "--precision", "128"]) == 0
cli.run(["-s", str(tmp / "toy.zip"), "-o", str(tmp / "toy"), "--device", "cpu",
         "-c", str(tmp / "toy.ck"), "--precision", "64", "--maxIterations", "2",
         "--verbosity", "0", "--writeSolution", "x,y"])
assert spectrum.main(["--input", sys.argv[4], "--solution", str(tmp / "toy"), "--precision",
                      "64", "--threshold", "1e-8", "--format", "PMP", "--output",
                      str(tmp / "spectrum.json")]) == 0
assert len(json.loads((tmp / "spectrum.json").read_text())) == 1
assert block_grid_mapping.main(["4", "2", "100", "5", "5", "300"]) == 0
# a run of one process through a gloo group (parallel/, the collectives),
# resumed from its checkpoint rewritten as a reference binary one
res = cli.run(["-s", sys.argv[1], "-o", str(tmp / "w1"), "--device", "cpu", "-c",
               str(tmp / "w1.ck"), "--precision", "64", "--maxIterations", "1",
               "--verbosity", "0", "--coordinator", "file://" + str(tmp / "rendezvous"),
               "--numProcesses", "1", "--processId", "0"], chunk_iterations=1)
from sdpb_tpu_torch.io.solution import host_blocks
from sdpb_tpu_torch.ops import mpfloat
from torch_parity import write_reference_checkpoint
sdp = build_device_sdp(read_sdp(sys.argv[1], 2), "cpu")
write_reference_checkpoint(tmp / "ref", host_blocks(sdp, res.state),
                           mpfloat.host_f64_limbs(res.state.y), 192)
assert load_checkpoint(tmp / "ref", sdp, verbosity=0) is not None
# the wide path: staging, a wide product through the GEMM wrapper, a division
import numpy as np
from sdpb_tpu_torch.ops import kernels, linalg, mpfloat as mp, mpwide
a = mp.from_double(np.arange(1.0, 7.0).reshape(2, 3) / 7, 18, "cpu", scaled=True)
prod = linalg.matmul(a, a.mT)
assert isinstance(prod, mpwide.MPW) and prod.shape == (2, 2)
assert float(mp.to_double(mp.div(prod, prod))[0, 0]) == 1.0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sdpb_tpu"))
assert not bad, bad
print(len(names))
"""


def _jax_package_references(path: Path, root: Path = REPO) -> list:
    """Imports of jax or of the JAX package (sdpb_tpu, not sdpb_tpu_torch)
    in a source file: its import statements, relative imports that leave
    sdpb_tpu_torch, and dotted module names or `-m sdpb_tpu` anywhere in
    its text (strings a subprocess or importlib would run)."""
    import ast
    import re

    text = path.read_text()
    found = []
    rel = path.relative_to(root)
    depth = len(rel.parts) - 1            # packages above the module
    for node in ast.walk(ast.parse(text)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level and (rel.parts[0] != "sdpb_tpu_torch" or node.level > depth):
                found.append(f"{rel}:{node.lineno}: relative import leaves the port")
            names = [node.module or ""] if not node.level else []
        for n in names:
            if n.split(".")[0] in ("jax", "jaxlib", "sdpb_tpu"):
                found.append(f"{rel}:{node.lineno}: import {n}")
    for m in re.finditer(r"(?<![\w/.])(sdpb_tpu\.[A-Za-z_]|-m\s+sdpb_tpu\b)", text):
        found.append(f"{rel}:{text.count(chr(10), 0, m.start()) + 1}: {m.group(0)}")
    return found


def test_port_never_imports_jax(tmp_path):
    """With jax and the JAX package blocked at import, every module of the
    port (the wide ones, parallel/, solver/checkpoint.py, the tools that
    drive the solver and the front and back ends included) imports, the CLI
    solves (2 iterations of the certificate, classic and scaled, each with
    its final checkpoint), approx_objective and sdp2functions run, a
    checkpoint loads, the timing run runs, a run through a one-rank gloo
    group solves and its state loads from a reference binary checkpoint,
    sdp2input writes the committed
    certificate zip, gen_pmp, pvm2sdp (of an XML the port writes), spectrum
    (of the toy PMP after a 2-iteration solve) and block_grid_mapping run,
    and the wide ops run; no source of the port, nor
    chip_smoke.py, names the JAX package as a module."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]),
               OMP_NUM_THREADS="1")
    from test_spectrum import TOY_PMP

    (tmp_path / "toy.json").write_text(json.dumps(TOY_PMP))
    proc = subprocess.run([sys.executable, "-c", _GUARD, str(CERTIFICATE), str(tmp_path),
                           str(CERTIFICATE.with_name("pmp.json")), str(tmp_path / "toy.json")],
                          capture_output=True, text=True, env=env, cwd=str(REPO),
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 58
    sources = sorted((REPO / "sdpb_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) >= 20
    found = [f for p in sources for f in _jax_package_references(p)]
    assert not found, found
    # the scan finds what it looks for
    probe = tmp_path / "sdpb_tpu_torch" / "io" / "probe.py"
    probe.parent.mkdir(parents=True)
    probe.write_text("from sdpb_tpu.io import sdp_zip\nfrom ...sdpb_tpu import x\n"
                     "import jax.numpy\nrun = 'python -m sdpb_tpu.cli.sdp2input'\n")
    lines = {f.split(":")[1] for f in _jax_package_references(probe, tmp_path)}
    assert lines == {"1", "2", "3", "4"}
