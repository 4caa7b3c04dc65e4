"""The solver run loops around the iteration (port of
sdpb_tpu/solver/solve.py::run_solver and _solve_chunked).

The default loop is the chunked one: up to `chunk` iterations run on the
device between two host reads (on a CUDA card as replays of the captured
iteration, solver/graphs.py), with the ordered termination checks of
compute_feasible_and_termination.cxx:20-65 decided on the device; the host
reads the chunk's stats rows and carry in one copy, checks maxRuntime at
chunk boundaries, heals conditioning failures by raising the factor
precision and replaying the chunk, and prints the iteration table.
`chunk_iterations=1` runs the host loop: one iteration at a time, the
termination checks on the host in exact arithmetic.  Either loop hands its
state to `checkpoint_fn` once `checkpointInterval` seconds have passed
since the last checkpoint: the host loop before an iteration, the chunked
loop before a chunk, as the JAX package's loops do.

With a `group` (a run of several processes, parallel/distributed.py) every
rank runs the loop on its shards.  Every decision comes from statistics
the ranks share (reduced over the ranks in the iteration): termination, the heal of a
failed iteration, the end of a chunk; the two taken on each rank's own
clock, a checkpoint's time and maxRuntime, are agreed over the ranks
(Group.agree).  So no rank leaves the others' sequence of collectives.
Only rank 0 prints.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional

import mpmath
import numpy as np

from ..models.sdp import DeviceSDP
from ..ops import mpfloat as mp
from ..utils.strings import (limbs_to_mpf, scaled_limbs_to_mpf, str_to_limbs,
                             str_to_scaled_limbs, wide_limbs_to_mpf)
from ..utils.timers import Timers
from .params import SolverParameters, refinement_passes
from .state import SolverState, initial_state
from .step import (CARRY_START, MP_FIELDS, REASON_NONE, REASON_RETRY, IterationStats,
                   StatsLayout, StepConfig, make_iteration, pack_stats, stats_layout)


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


def unpack_stats(row: np.ndarray, layout: StatsLayout) -> HostStats:
    """HostStats from a row of pack_stats."""
    K, scaled = layout.K, layout.scaled
    out, pos = {}, 0
    for name in IterationStats._fields:
        n = (K + scaled) * layout.G if name in MP_FIELDS else 1
        v = row[pos:pos + n]
        pos += n
        if name in MP_FIELDS:
            hw = [(w[:K].astype(np.float32), int(w[K])) if scaled else w.copy()
                  for w in v.reshape(layout.G, K + scaled)]
            out[name] = hw if layout.wide else hw[0]
        elif name in ("is_pd_feasible", "max_complementarity_exceeded"):
            out[name] = bool(v[0])
        else:
            out[name] = float(v[0])
    return HostStats(**out)


def to_host(stats: IterationStats) -> HostStats:
    """One device-to-host copy of every field."""
    return unpack_stats(pack_stats(stats).cpu().numpy(), stats_layout(stats.mu))


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
    # the chunked loop: (iterations executed, iterations run, seconds) per
    # chunk, the capture of its CUDA graphs per factor limb count
    # (ChunkRunner.info) and, on the card, the device ms of each replay's
    # graph A, eigvalsh calls and graph B (ChunkRunner.replay_ms)
    chunks: List[tuple] = field(default_factory=list)
    graphs: dict = field(default_factory=dict)
    replay_ms: List[tuple] = field(default_factory=list)

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


def _agreed(group, flag: bool) -> bool:
    """A decision on the host's clock: `flag`, or in a run of several
    processes true on every rank when it is on any (Group.agree)."""
    return flag if group is None else group.agree(flag)


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
               timers: Optional[Timers] = None,
               chunk_iterations: int = 0,
               checkpoint_fn: Optional[Callable] = None, group=None) -> SolveResult:
    """Solve from `initial` (default: the initial point of `params`).
    chunk_iterations: 0 runs the chunked loop in chunks of 8, n > 1 in
    chunks of n, 1 the host loop.  checkpoint_fn(state, iteration), when
    given, is called at most every params.checkpoint_interval seconds, with
    the state the next iteration (or chunk) starts from.  With a group
    (parallel/distributed.py::Group) sdp and `initial` are this rank's
    shards (parallel/mesh.py), every rank calls run_solver, and the
    result's state is the rank's shard."""
    K = sdp.b.K
    scaled = sdp.b.scaled
    timers = timers if timers is not None else Timers()
    total_psd_rows = sdp.total_psd_rows
    if group is not None:
        total_psd_rows = group.sum_int(total_psd_rows)
        if not group.is_coordinator:
            verbosity = 0

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
            total_psd_rows=total_psd_rows,
            factor_limbs=kf,
            n_refine=refinement_passes(K, kf, scaled),
            gamma=float(mpmath.mpf(params.step_length_reduction)),
            feasible_beta_limbs=parse(params.feasible_centering_parameter),
            infeasible_beta_limbs=parse(params.infeasible_centering_parameter),
            primal_error_threshold=float(mpmath.mpf(params.primal_error_threshold)),
            dual_error_threshold=float(mpmath.mpf(params.dual_error_threshold)),
            max_complementarity=float(mpmath.mpf(params.max_complementarity)),
            duality_gap_threshold_limbs=parse(params.duality_gap_threshold),
            find_primal_feasible=params.find_primal_feasible,
            find_dual_feasible=params.find_dual_feasible,
            detect_primal_feasible_jump=params.detect_primal_feasible_jump,
            detect_dual_feasible_jump=params.detect_dual_feasible_jump,
            min_primal_step=float(mpmath.mpf(params.min_primal_step)),
            min_dual_step=float(mpmath.mpf(params.min_dual_step)))

    if chunk_iterations != 1:
        return _solve_chunked(sdp, params, state, make_cfg, factor_limbs, factor_cap,
                              chunk_iterations or 8, verbosity, timers, checkpoint_fn, group)

    cfg = make_cfg(factor_limbs)
    iteration = make_iteration(cfg, group)

    gap_threshold = mpmath.mpf(params.duality_gap_threshold)
    primal_thr = mpmath.mpf(params.primal_error_threshold)
    dual_thr = mpmath.mpf(params.dual_error_threshold)
    min_p_step = mpmath.mpf(params.min_primal_step)
    min_d_step = mpmath.mpf(params.min_dual_step)

    start = time.time()
    last_checkpoint = start
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
        if checkpoint_fn is not None and \
                _agreed(group, time.time() - last_checkpoint >= params.checkpoint_interval):
            checkpoint_fn(state, it)
            last_checkpoint = time.time()
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
            iteration = make_iteration(cfg, group)
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
        elif _agreed(group, time.time() - start >= params.max_runtime):
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


# ---------------------------------------------------------------------------
# The chunked run loop (sdpb_tpu/solver/solve.py:430-639)

_REASON_MAP = {
    1: TerminateReason.PrimalDualOptimal,
    2: TerminateReason.DualFeasible,
    3: TerminateReason.PrimalFeasible,
    4: TerminateReason.DualFeasibleJumpDetected,
    5: TerminateReason.PrimalFeasibleJumpDetected,
    6: TerminateReason.MaxIterationsExceeded,
    8: TerminateReason.PrimalStepTooSmall,
    9: TerminateReason.DualStepTooSmall,
    10: TerminateReason.MaxComplementarityExceeded,
}


def _solve_chunked(sdp: DeviceSDP, params: SolverParameters, state: SolverState,
                   make_cfg, factor_limbs: int, factor_cap: int, chunk: int,
                   verbosity: int, timers: Timers, checkpoint_fn: Optional[Callable],
                   group) -> SolveResult:
    """Up to `chunk` iterations on the device between two host reads.  The
    ten ordered termination reasons are decided on the device (comparing
    the error norms in their own dtype, float32 in a scaled run, where the
    host loop compares exactly); the host checks maxRuntime at chunk
    boundaries and heals a failed iteration by raising the factor
    precision and replaying the chunk from its start, at the cap ending
    the run as MaxComplementarityExceeded.  A checkpoint reads the
    runner's state buffers between chunks, after run()'s host copy has
    synchronized, so no capture sees it and the next replay reads the
    same buffers; after a heal the test runs again, on the state the
    chunk is replayed from."""
    from .graphs import ChunkRunner

    layout = stats_layout(sdp.b)
    cfg = make_cfg(factor_limbs)
    with timers.scope("run.initialize"):
        runner = ChunkRunner(sdp, cfg, state, CARRY_START, chunk, params.max_iterations,
                             group)
    graphs = {factor_limbs: runner.info}

    start = time.time()
    last_checkpoint = start
    reason = TerminateReason.MaxIterationsExceeded
    final_row = None
    kkt_warned = False
    it_global = 1
    iteration_seconds, history, chunks, replay_ms = [], [], [], []

    if verbosity >= 1:
        print("\n          time    mu     P-obj       D-obj      gap     "
              "    P-err       p-err       D-err      P-step   D-step  beta")

    while True:
        if checkpoint_fn is not None and \
                _agreed(group, time.time() - last_checkpoint >= params.checkpoint_interval):
            checkpoint_fn(runner.state, it_global)
            last_checkpoint = time.time()
        # a heal replays the chunk from its start: a poisoned search
        # direction corrupts the state one iteration before its statistics
        # show it, so the stopping iteration's input may be lost already
        chunk_start = runner.snapshot()
        with timers.scope("run.chunk"):
            t0 = time.time()
            rows = runner.run()
            dt = time.time() - t0
        it_new, reason_code = int(rows[-1, 0]), int(rows[-1, 4])
        stopped = reason_code != REASON_NONE
        n_advanced = it_new - it_global
        n_exec = n_advanced + stopped
        stats = [unpack_stats(rows[i], layout) for i in range(n_exec)]
        history += stats
        iteration_seconds += [dt / max(n_exec, 1)] * n_exec
        chunks.append((n_exec, runner.replays, dt))
        replay_ms += runner.replay_ms
        if verbosity >= 2:
            print(f"  -- chunk: {n_exec} iterations in {dt:.3f} s device+sync "
                  f"({dt / max(n_exec, 1):.4f} s/it)")

        if reason_code == REASON_RETRY:
            if factor_limbs >= factor_cap:
                reason = TerminateReason.MaxComplementarityExceeded
                if verbosity >= 1:
                    print("non-finite iteration at full factor precision; "
                          "increase --precision")
                it_global = it_new
                final_row = stats[-1]
                break
            factor_limbs += 1
            if verbosity >= 1:
                print(f"conditioning exceeded factor range; increasing factor "
                      f"precision to {factor_limbs} limbs (replaying from "
                      f"iteration {it_global})")
            cfg = make_cfg(factor_limbs)
            runner.close()
            with timers.scope("run.initialize"):
                runner = ChunkRunner(sdp, cfg, *chunk_start, chunk, params.max_iterations,
                                     group)
            graphs[factor_limbs] = runner.info
            continue

        elapsed = time.time() - start
        if verbosity >= 1:
            for i in range(n_advanced):
                print_iteration_line(it_global + i, elapsed, stats[i])
            worst = max((st.kkt_residual for st in stats), default=0.0)
            if cfg.kkt_residual_threshold > 0 and not cfg.kkt_heal and not kkt_warned \
                    and worst > cfg.kkt_residual_threshold:
                kkt_warned = True
                print(f"WARNING: KKT solve residual {worst:.2e} exceeds "
                      f"{cfg.kkt_residual_threshold:.0e} at full factor precision — "
                      f"results may be degraded; increase --precision")
        it_global = it_new
        if stats:
            final_row = stats[-1]
        if stopped:
            reason = _REASON_MAP[reason_code]
            break
        if _agreed(group, time.time() - start >= params.max_runtime):
            reason = TerminateReason.MaxRuntimeExceeded
            break

    state = runner.state
    runner.close()
    nan = mpmath.mpf("nan")
    p_obj = d_obj = gap = nan
    perr_P = perr_p = derr = float("nan")
    if final_row is not None:
        p_obj = host_mpf(final_row.primal_objective)
        d_obj = host_mpf(final_row.dual_objective)
        gap = host_mpf(final_row.duality_gap)
        perr_P, perr_p = final_row.primal_error_P, final_row.primal_error_p
        derr = final_row.dual_error
    return SolveResult(
        terminate_reason=reason, state=state, primal_objective=p_obj,
        dual_objective=d_obj, duality_gap=gap, primal_error_P=perr_P,
        primal_error_p=perr_p, dual_error=derr, iterations=it_global,
        runtime=time.time() - start, iteration_seconds=iteration_seconds,
        history=history, chunks=chunks, graphs=graphs, replay_ms=replay_ms)
