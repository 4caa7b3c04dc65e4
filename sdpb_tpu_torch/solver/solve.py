"""The solver run loop on the host around the iteration (port of the host
loop of sdpb_tpu/solver/solve.py::run_solver).

The host reads back a few numbers per iteration, applies the ordered
termination checks of compute_feasible_and_termination.cxx:20-65, heals
conditioning failures by raising the factor precision and replaying from
a lagged snapshot, and prints the iteration table.  The JAX package's
device-resident chunked loop (several iterations per dispatch) is not
ported yet.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import mpmath
import numpy as np
import torch

from ..models.sdp import DeviceSDP
from ..ops import mpfloat as mp
from ..ops.mpwide import MPW
from ..utils.strings import (limbs_to_mpf, scaled_limbs_to_mpf, str_to_limbs,
                             str_to_scaled_limbs, wide_limbs_to_mpf)
from ..utils.timers import Timers
from .params import SolverParameters
from .state import SolverState, initial_state
from .step import IterationStats, StepConfig, make_iteration


class TerminateReason(enum.Enum):
    PrimalDualOptimal = "found primal-dual optimal solution"
    PrimalFeasible = "found primal feasible solution"
    DualFeasible = "found dual feasible solution"
    PrimalFeasibleJumpDetected = "primal feasible jump detected"
    DualFeasibleJumpDetected = "dual feasible jump detected"
    MaxComplementarityExceeded = "maxComplementarity exceeded"
    MaxIterationsExceeded = "maxIterations exceeded"
    MaxRuntimeExceeded = "maxRuntime exceeded"
    PrimalStepTooSmall = "primal step too small"
    DualStepTooSmall = "dual step too small"

    def __str__(self):
        return self.value


class HostStats(NamedTuple):
    """IterationStats on the host: MP fields as float64 limb arrays [K]
    (classic), (float32 limbs [K], exponent) pairs (scaled) or lists of such
    pairs, one per word (wide); the rest as Python numbers."""
    primal_objective: np.ndarray
    dual_objective: np.ndarray
    duality_gap: np.ndarray
    primal_error_P: float
    primal_error_p: float
    dual_error: float
    mu: np.ndarray
    primal_step: float
    dual_step: float
    beta_corrector: float
    is_pd_feasible: bool
    max_complementarity_exceeded: bool
    kkt_residual: float


_MP_FIELDS = ("primal_objective", "dual_objective", "duality_gap", "mu")


def to_host(stats: IterationStats) -> HostStats:
    """One device-to-host copy of every field (float32 limbs and int32
    exponents are exact in float64)."""
    words = stats.mu.words if isinstance(stats.mu, MPW) else (stats.mu,)
    K, scaled = words[0].K, stats.mu.scaled
    parts = []
    for name in IterationStats._fields:
        v = getattr(stats, name)
        if name in _MP_FIELDS:
            for w in (v.words if isinstance(v, MPW) else (v,)):
                parts.append(w.limbs.to(torch.float64))
                if scaled:
                    parts.append(w.exp.to(torch.float64).reshape(1))
        else:
            parts.append(v.to(torch.float64).reshape(1))
    flat = torch.cat(parts).cpu().numpy()
    out, pos = {}, 0
    for name in IterationStats._fields:
        n = (K + scaled) * len(words) if name in _MP_FIELDS else 1
        v = flat[pos:pos + n]
        pos += n
        if name in _MP_FIELDS:
            hw = [(w[:K].astype(np.float32), int(w[K])) if scaled else w.copy()
                  for w in v.reshape(len(words), K + scaled)]
            out[name] = hw if isinstance(stats.mu, MPW) else hw[0]
        elif name in ("is_pd_feasible", "max_complementarity_exceeded"):
            out[name] = bool(v[0])
        else:
            out[name] = float(v[0])
    return HostStats(**out)


@dataclass
class SolveResult:
    terminate_reason: TerminateReason
    state: SolverState
    primal_objective: mpmath.mpf
    dual_objective: mpmath.mpf
    duality_gap: mpmath.mpf
    primal_error_P: float
    primal_error_p: float
    dual_error: float
    iterations: int
    runtime: float
    # wall seconds of each iteration including the host read-back
    iteration_seconds: List[float] = field(default_factory=list)
    # host statistics of every iteration that ran, in order (replayed
    # iterations after a factor bump included)
    history: List[HostStats] = field(default_factory=list)

    @property
    def primal_error(self) -> float:
        return max(self.primal_error_P, self.primal_error_p)


def host_mpf(v) -> mpmath.mpf:
    """Exact mpmath value of a HostStats MP field."""
    if isinstance(v, list):
        return wide_limbs_to_mpf(v)
    return scaled_limbs_to_mpf(*v) if isinstance(v, tuple) else limbs_to_mpf(v)


def _finite(v) -> bool:
    if isinstance(v, list):
        return all(_finite(w) for w in v)
    return bool(np.all(np.isfinite(v[0] if isinstance(v, tuple) else v)))


def initial_factor_limbs(params: SolverParameters, K: int,
                         scaled: bool = False) -> tuple:
    """(factor_limbs, factor_cap) of the mixed-precision solves: the
    empirical sizing law of the JAX package, bits >= max(4 log2 Omega,
    2 (log2 Omega + log2 1/gap)) + 30 in limbs of p_bits (53 classic, 24
    scaled), clamped to [max(2, (K+2)//2), K]; params.factor_limbs > 0 pins
    it.  A wide run (scaled, K > 9) caps the factor at 9 limbs: the
    factorizations stay on one scaled word and the refinement's wide
    products recover the rest.  Scaled float32 arithmetic saturates instead
    of producing NaN, so there the exploding corrector beta is what
    triggers the heal."""
    p_bits = 24 if scaled else 53
    factor_cap = mp.MAX_SCALED_K if scaled and K > mp.MAX_SCALED_K else K
    if params.factor_limbs > 0:
        return min(factor_cap, max(2, params.factor_limbs)), factor_cap
    with mpmath.workprec(64):
        log2_omega = float(mpmath.log(max(
            abs(mpmath.mpf(params.initial_matrix_scale_primal)),
            abs(mpmath.mpf(params.initial_matrix_scale_dual)), 2), 2))
        gap_thr = mpmath.mpf(params.duality_gap_threshold)
        log2_gap_inv = float(-mpmath.log(gap_thr, 2)) if gap_thr > 0 else 0.0
    bits = max(4 * log2_omega, 2 * (log2_omega + log2_gap_inv)) + 30
    cond_limbs = -(-int(bits) // p_bits)
    return min(factor_cap, max(2, (K + 2) // 2, cond_limbs)), factor_cap


def print_iteration_line(it: int, elapsed: float, st: HostStats) -> None:
    """One line of the iteration table (run/print_iteration.cxx:16-56)."""
    mu = host_mpf(st.mu)
    print(
        f"{it:<4d} {int(elapsed):>8d} "
        f"{mpmath.nstr(mu, 2, min_fixed=1, max_fixed=0):<8s} "
        f"{float(host_mpf(st.primal_objective)):+.3e} "
        f"{float(host_mpf(st.dual_objective)):+.3e} "
        f"{float(host_mpf(st.duality_gap)):.3e} "
        f"{st.primal_error_P:+.3e} {st.primal_error_p:+.3e} "
        f"{st.dual_error:+.3e} "
        f"{min(st.primal_step, 1.0):.3g}    {min(st.dual_step, 1.0):.3g}    "
        f"{st.beta_corrector:.3g}")


def run_solver(sdp: DeviceSDP, params: SolverParameters, verbosity: int = 1,
               initial: Optional[SolverState] = None,
               timers: Optional[Timers] = None) -> SolveResult:
    K = sdp.b.K
    scaled = sdp.b.scaled
    timers = timers if timers is not None else Timers()

    def parse(s: str):
        """Decimal string -> host MP parts in the problem's representation."""
        return str_to_scaled_limbs(s, K) if scaled else str_to_limbs(s, K)

    state = initial if initial is not None else initial_state(
        sdp, parse(params.initial_matrix_scale_primal),
        parse(params.initial_matrix_scale_dual))
    factor_limbs, factor_cap = initial_factor_limbs(params, K, scaled)

    def make_cfg(kf: int) -> StepConfig:
        return StepConfig(
            kkt_residual_threshold=float(mpmath.mpf(params.kkt_residual_threshold)),
            kkt_heal=kf < factor_cap,
            total_psd_rows=sdp.total_psd_rows,
            factor_limbs=kf,
            n_refine=0 if K <= kf else -(-K // kf),
            gamma=float(mpmath.mpf(params.step_length_reduction)),
            feasible_beta_limbs=parse(params.feasible_centering_parameter),
            infeasible_beta_limbs=parse(params.infeasible_centering_parameter),
            primal_error_threshold=float(mpmath.mpf(params.primal_error_threshold)),
            dual_error_threshold=float(mpmath.mpf(params.dual_error_threshold)),
            max_complementarity=float(mpmath.mpf(params.max_complementarity)))

    cfg = make_cfg(factor_limbs)
    iteration = make_iteration(cfg)

    gap_threshold = mpmath.mpf(params.duality_gap_threshold)
    primal_thr = mpmath.mpf(params.primal_error_threshold)
    dual_thr = mpmath.mpf(params.dual_error_threshold)
    min_p_step = mpmath.mpf(params.min_primal_step)
    min_d_step = mpmath.mpf(params.min_dual_step)

    start = time.time()
    prev_p_step, prev_d_step = 0.0, 0.0
    reason = TerminateReason.MaxIterationsExceeded
    nan = mpmath.mpf("nan")
    p_obj = d_obj = gap = nan
    perr_P = perr_p = derr = float("nan")
    iteration_seconds, history = [], []

    if verbosity >= 1:
        print("\n          time    mu     P-obj       D-obj      gap     "
                 "    P-err       p-err       D-err      P-step   D-step  beta")

    it = 1
    kkt_warned = False
    # lagged snapshot: a poisoned direction corrupts the state one
    # iteration before any statistic shows it, so a heal replays from a
    # state up to 8 iterations old
    snap = (state, it, prev_p_step, prev_d_step)
    while True:
        with timers.scope("run.iteration"):
            t_it = time.time()
            stats, new_state = iteration(sdp, state)
            st = to_host(stats)
            t_it = time.time() - t_it
        iteration_seconds.append(t_it)
        history.append(st)
        if verbosity >= 2:
            print(f"  -- iteration {it}: {t_it:.3f} s device+sync")

        finite = all(_finite(getattr(st, name)) for name in (
            "primal_objective", "dual_objective", "duality_gap", "mu",
            "primal_error_P", "primal_error_p", "dual_error", "primal_step",
            "dual_step"))
        # an exploding corrector beta is the same conditioning failure (the
        # only sign of it in scaled arithmetic, which saturates)
        if finite and st.beta_corrector > 1e4:
            finite = False
        # tripped KKT residual guard: heal below the factor cap, warn at it
        if finite and cfg.kkt_residual_threshold > 0 and \
                st.kkt_residual > cfg.kkt_residual_threshold:
            if cfg.kkt_heal:
                finite = False
            elif not kkt_warned:
                kkt_warned = True
                if verbosity >= 1:
                    print(f"WARNING: KKT solve residual {st.kkt_residual:.2e} "
                             f"exceeds {cfg.kkt_residual_threshold:.0e} at full "
                             f"factor precision — results may be degraded; "
                             f"increase --precision")
        if not finite:
            if factor_limbs >= factor_cap:
                reason = TerminateReason.MaxComplementarityExceeded
                if verbosity >= 1:
                    print("non-finite iteration at full factor precision; "
                             "increase --precision")
                break
            factor_limbs += 1
            state, it, prev_p_step, prev_d_step = snap
            if verbosity >= 1:
                print(f"conditioning exceeded factor range; increasing "
                         f"factor precision to {factor_limbs} limbs "
                         f"(replaying from iteration {it})")
            cfg = make_cfg(factor_limbs)
            iteration = make_iteration(cfg)
            continue

        p_obj = host_mpf(st.primal_objective)
        d_obj = host_mpf(st.dual_objective)
        gap = host_mpf(st.duality_gap)
        perr_P, perr_p, derr = st.primal_error_P, st.primal_error_p, st.dual_error
        primal_error = max(perr_P, perr_p)

        # ordered termination checks (compute_feasible_and_termination.cxx:20-65)
        is_dual_feasible = derr < dual_thr
        is_primal_feasible = primal_error < primal_thr
        is_optimal = gap < gap_threshold
        terminate = True
        if is_primal_feasible and is_dual_feasible and is_optimal:
            reason = TerminateReason.PrimalDualOptimal
        elif is_dual_feasible and params.find_dual_feasible:
            reason = TerminateReason.DualFeasible
        elif is_primal_feasible and params.find_primal_feasible:
            reason = TerminateReason.PrimalFeasible
        elif prev_d_step == 1.0 and params.detect_dual_feasible_jump:
            reason = TerminateReason.DualFeasibleJumpDetected
        elif prev_p_step == 1.0 and params.detect_primal_feasible_jump:
            reason = TerminateReason.PrimalFeasibleJumpDetected
        elif it > params.max_iterations:
            reason = TerminateReason.MaxIterationsExceeded
        elif (time.time() - start) >= params.max_runtime:
            reason = TerminateReason.MaxRuntimeExceeded
        elif it > 1 and prev_p_step < min_p_step:
            reason = TerminateReason.PrimalStepTooSmall
        elif it > 1 and prev_d_step < min_d_step:
            reason = TerminateReason.DualStepTooSmall
        else:
            terminate = False
        if terminate:
            break
        if st.max_complementarity_exceeded:
            reason = TerminateReason.MaxComplementarityExceeded
            break

        if verbosity >= 1:
            print_iteration_line(it, time.time() - start, st)
        state = new_state
        prev_p_step, prev_d_step = st.primal_step, st.dual_step
        it += 1
        if it % 8 == 0:
            snap = (state, it, prev_p_step, prev_d_step)

    return SolveResult(
        terminate_reason=reason, state=state, primal_objective=p_obj,
        dual_objective=d_obj, duality_gap=gap, primal_error_P=perr_P,
        primal_error_p=perr_p, dual_error=derr, iterations=it,
        runtime=time.time() - start, iteration_seconds=iteration_seconds,
        history=history)
