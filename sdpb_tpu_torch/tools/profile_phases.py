"""Per-phase time breakdown of one interior-point iteration, against the CUDA-core peak.

Port of sdpb_tpu/tools/profile_phases.py.  It runs each phase of the
iteration on its own on a real fixture (the X and Y factors, the bilinear
pairings, the Schur complement S, its factor, the S^{-1}B solves and Q, the
Q factor, the step-length eigenvalues), then the whole iteration, times
each warm, and reports each phase's throughput against a peak measured on
the card by the hand-written probe kernel (csrc/peak_probe.cu).

Why the CUDA cores and not the tensor cores: the MP kernels are error-free
transforms, correct only with every add and multiply rounded on its own,
so their speed of light is the rate of unfused float adds and multiplies:
float64 for the classic representation, float32 for the scaled and wide
ones (the probe's dtype follows the limbs).

Flop model: the JAX package's, copied verbatim (renorm_flops .. trsm_ops),
so that the tool's output means what the JAX tool's meant.  It counts what
the arithmetic executes (Dekker TwoProds included), not the least work.

Usage (on the card; `--device cpu` runs on the CPU and measures no peak):
    python -m sdpb_tpu_torch.tools.profile_phases \\
        --fixture fixtures/ising_ladder_120/sdp.zip --scaledLimbs 9 --quant 8 \\
        --omega 1e4 --reps 2 --json phases.json

`--scaledLimbs`: 0 classic float64 (K = 4), 2-9 one scaled word, 10-18 the
wide representation of two words of ceil(K/2) limbs, 19-27 of three words
of ceil(K/3).  The JAX tool's
compile cache (`--noCache`) has no counterpart: the port runs eagerly.
"""
import argparse
import json
import subprocess
import time

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Analytic flop model of the MP arithmetic (sdpb_tpu/tools/profile_phases.py)


def renorm_flops(m: int, K: int) -> int:
    """renorm_list over m terms into K limbs: two_sum passes (6 flops each)
    + 2K quick_two_sums (3 flops each)."""
    two_sums = max(0, K * m - K - K * (K - 1) // 2)
    return 6 * two_sums + 6 * K


def mul_flops(K: int, scaled: bool = True) -> int:
    """One MP elementwise multiply."""
    prescale = 2 * K if scaled else 0
    splits = 8 * K
    prods = (K * (K + 1) // 2) * (9 + (4 if scaled else 0))
    tail = 2 * K
    n_terms = K * (K + 1) // 2 + K * (K - 1) // 2 + 1
    norm = (5 * K + 10) if scaled else 0
    return prescale + splits + prods + tail + renorm_flops(n_terms, K) + norm


def add_flops(K: int, scaled: bool = True) -> int:
    """One MP elementwise add."""
    align = (8 * K + 2) if scaled else 0
    norm = (5 * K + 10) if scaled else 0
    return align + renorm_flops(2 * K, K) + norm


def matmul_ops(B, M, Kd, N) -> float:
    """MP element-op count of [B,M,Kd] @ [B,Kd,N]: one mul + one add per
    contraction element."""
    return float(B) * M * N * Kd


def cholesky_ops(B, n) -> float:
    """Blocked right-looking factorization ~ n^3/3 mul+add pairs, plus the
    masked whole-matrix sweep overhead of the fori_loop formulation (the
    rank-1 update touches all n^2 elements on each of n steps -> n^3)."""
    return float(B) * n ** 3


def trsm_ops(B, n, m) -> float:
    """Triangular solve with n rhs-rows x m cols: the row-sweep touches
    n * (n x m) elements."""
    return float(B) * n * n * m


# ---------------------------------------------------------------------------
# CUDA-core peak


# the chain's constants (those of the JAX tool's Pallas kernel)
PROBE_A, PROBE_B = 1.0000001, 1e-7


def cuda_core_peak_gflops(reps: int = 5, steps: int = 65536, tile=(512, 512),
                          dtype=torch.float32, device="cuda") -> float:
    """Measured rate of unfused adds and multiplies on the CUDA cores, in
    GFLOP/s: the peak probe kernel (ops/kernels.py::peak_probe) runs
    `steps` dependent passes of x * a + b over a tile (2 flops per element
    per step), timed with CUDA events around `reps` back-to-back launches
    after one warm-up.  The counterpart of the JAX tool's vpu_peak_gflops.
    `steps` is 65536 where the JAX tool took 2048: at 2048 a float32 launch
    at the data-sheet rate takes 32 us, on the scale of clock ramp-up and
    launch jitter; at 65536 it takes ~1.03 ms (float64 ~2.06 ms)."""
    from ..ops import kernels

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the peak is measured on a CUDA device, got {device}")
    x = torch.ones(tile, dtype=dtype, device=device)
    kernels.peak_probe(x, steps, PROBE_A, PROBE_B)
    with torch.cuda.device(device):
        torch.cuda.synchronize(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            kernels.peak_probe(x, steps, PROBE_A, PROBE_B)
        e1.record()
        torch.cuda.synchronize(device)
    dt = e0.elapsed_time(e1) / 1e3 / reps
    flops = 2.0 * steps * tile[0] * tile[1]
    return flops / dt / 1e9


# ---------------------------------------------------------------------------
# Phase harness


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn, args, reps: int, device: torch.device):
    """(seconds per call, last output): one warm call, then `reps` calls
    timed on the host clock, closed by a device synchronize (the phases
    are eager and host-bound, so the wall clock is the phase's time)."""
    out = fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / reps, out


def _time_samples(fn, args, reps: int, device: torch.device):
    """(seconds of each of `reps` calls, last output): one warm call, then
    each call timed on its own, closed by a device synchronize, as the
    solver's loop reads its statistics back after every iteration.  The
    whole iteration is timed so: on a shared host a slow stretch of
    seconds can hold back every call of a batch, and calls timed one by
    one show which were held back."""
    out = fn(*args)
    _sync(device)
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(device)
        samples.append(time.perf_counter() - t0)
    return samples, out


def profile_fixture(fixture: str, scaled_limbs: int, quant: int, omega: str,
                    reps: int, device):
    """[(phase, seconds, flops)] and the seconds of each of `reps` calls of
    the whole iteration, from the initial state of `fixture` at Omega =
    omega.  The factor precision is the JAX tool's choice for this omega,
    capped at mp.MAX_SCALED_K for a wide run (the factors stay on one
    scaled word, as solve.py::initial_factor_limbs caps them)."""
    from ..io.sdp_zip import read_sdp
    from ..models.sdp import build_device_sdp
    from ..ops import linalg
    from ..ops import mpfloat as mp
    from ..solver.params import refinement_passes
    from ..solver.state import initial_state
    from ..solver.step import (StepConfig, _compute_pairings, _psd_pair,
                               _schur_complement, _step_length_lambda,
                               make_iteration)
    from ..utils.strings import str_to_limbs, str_to_scaled_limbs

    device = torch.device(device)
    if scaled_limbs:
        K = scaled_limbs
        K64 = -(-(24 * scaled_limbs) // 53) + 1
        host = read_sdp(fixture, K64, np.float64)
        sdp = build_device_sdp(host, device, scaled_limbs=scaled_limbs, quant=quant)
        om = str_to_scaled_limbs(omega, scaled_limbs)
        beta_f = str_to_scaled_limbs("0.1", K)
        beta_i = str_to_scaled_limbs("0.3", K)
    else:
        K = 4
        host = read_sdp(fixture, K, np.float64)
        sdp = build_device_sdp(host, device, quant=quant)
        om = str_to_limbs(omega, K, np.float64)
        beta_f = str_to_limbs("0.1", K, np.float64)
        beta_i = str_to_limbs("0.3", K, np.float64)
    state = initial_state(sdp, om, om)
    # match run_solver's factor choice for THIS omega
    log2_om = np.log2(abs(float(omega)))
    p_bits = 24 if scaled_limbs else 53
    Kf = min(K, max(2, (K + 2) // 2, -(-int(2 * log2_om + 30) // p_bits)))
    if scaled_limbs:
        Kf = min(Kf, mp.MAX_SCALED_K)
    sc = bool(scaled_limbs)
    n_refine = refinement_passes(K, Kf, sc)

    cfg = StepConfig(
        total_psd_rows=sdp.total_psd_rows, factor_limbs=Kf,
        n_refine=n_refine, gamma=0.7, feasible_beta_limbs=beta_f,
        infeasible_beta_limbs=beta_i, primal_error_threshold=1e-10,
        dual_error_threshold=1e-10, max_complementarity=1e30)

    def timed(fn, *args):
        return _time_fn(fn, args, reps, device)

    N = sdp.dual_dim
    phases = []       # (name, seconds, flops)

    # ---- phase: Cholesky of X and Y at factor precision
    def ph_chol(sdp_, state_):
        parts = []
        for bk, bs in zip(sdp_.buckets, state_.buckets):
            for M in (_psd_pair(bs, "X_even", "X_odd", bk.shape)
                      + _psd_pair(bs, "Y_even", "Y_odd", bk.shape)):
                s = linalg.PosdefSolver(M, Kf)
                parts.append((s.A, s.L))
        return parts

    t, xy_parts = timed(ph_chol, sdp, state)
    ops = 0.0
    for bk, bs in zip(sdp.buckets, state.buckets):
        for M in (_psd_pair(bs, "X_even", "X_odd", bk.shape)
                  + _psd_pair(bs, "Y_even", "Y_odd", bk.shape)):
            ops += cholesky_ops(M.shape[0], M.shape[-1])
    phases.append(("cholesky_XY", t, ops * (mul_flops(Kf, sc) + add_flops(Kf, sc))))

    def rebuild(parts, i):
        A, L = parts[i]
        return linalg.PosdefSolver.from_parts(A, L, Kf)

    # ---- phase: bilinear pairings
    def ph_pair(sdp_, state_, parts):
        i = 0
        TXs_all, TYs_all = [], []
        for bk, bs in zip(sdp_.buckets, state_.buckets):
            n_par = len(_psd_pair(bs, "X_even", "X_odd", bk.shape))
            xs = [rebuild(parts, i + j) for j in range(n_par)]
            i += 2 * n_par   # skip the Y solvers
            Ys = _psd_pair(bs, "Y_even", "Y_odd", bk.shape)
            TX, TY = _compute_pairings(bk, xs, Ys, n_refine)
            TXs_all.append(TX)
            TYs_all.append(TY)
        return TXs_all, TYs_all

    t, (TXs_all, TYs_all) = timed(ph_pair, sdp, state, xy_parts)
    ops = 0.0
    for bk in sdp.buckets:
        for emb in (bk.emb_even, bk.emb_odd):
            B_, R, C = emb.shape
            if R == 0 or C == 0:
                continue
            # solve (2 trsm) * (1+n_refine matmul-ish passes) + 3 gemms
            ops += (1 + n_refine) * 2 * trsm_ops(B_, R, C)
            ops += 3 * matmul_ops(B_, C, R, C)
    phases.append(("pairings", t, ops * (mul_flops(K, sc) + add_flops(K, sc))))

    # ---- phase: Schur complement S assembly
    def ph_schur(sdp_, TXs, TYs):
        return [_schur_complement(bk, tx, ty)
                for bk, tx, ty in zip(sdp_.buckets, TXs, TYs)]

    t, Ss = timed(ph_schur, sdp, TXs_all, TYs_all)
    ops = 0.0
    for bk in sdp.buckets:
        P = bk.shape.schur_size
        n_par = (1 if bk.shape.h_even > 0 else 0) + \
                (1 if bk.shape.h_odd > 0 else 0)
        ops += 8.0 * n_par * bk.batch * P * P   # 4 Hadamard muls + adds
    phases.append(("schur_S", t, ops * (mul_flops(K, sc) + add_flops(K, sc)) / 2))

    # ---- phase: S factorization
    def ph_sfac(Ss_):
        out = []
        for S in Ss_:
            s = linalg.PosdefSolver(S, Kf)
            out.append((s.A, s.L))
        return out

    t, s_parts = timed(ph_sfac, Ss)
    ops = sum(cholesky_ops(S.shape[0], S.shape[-1]) for S in Ss)
    phases.append(("S_cholesky", t, ops * (mul_flops(Kf, sc) + add_flops(Kf, sc))))

    # ---- phase: S^{-1}B solves + Q assembly
    def ph_q(sdp_, parts):
        Q = mp.zeros((sdp_.dual_dim, sdp_.dual_dim), K, device, scaled=sc)
        for i, bk in enumerate(sdp_.buckets):
            A, L = parts[i]
            ssol = linalg.PosdefSolver.from_parts(A, L, Kf)
            V = ssol.solve(bk.Bmat, n_refine)
            Q = mp.add(Q, mp.sum_(linalg.matmul(bk.Bmat.mT, V), axis=0))
        return linalg.symmetrize(Q)

    t, Q = timed(ph_q, sdp, s_parts)
    ops = 0.0
    for bk in sdp.buckets:
        B_, P, Nn = bk.Bmat.shape
        ops += (1 + n_refine) * 2 * trsm_ops(B_, P, Nn)
        ops += matmul_ops(B_, Nn, P, Nn)
    phases.append(("SinvB_Q", t, ops * (mul_flops(K, sc) + add_flops(K, sc))))

    # ---- phase: global Q Cholesky
    def ph_qchol(Q_):
        s = linalg.PosdefSolver(Q_, Kf)
        return s.A, s.L

    t, _ = timed(ph_qchol, Q)
    phases.append(("Q_cholesky", t,
                   cholesky_ops(1, N) * (mul_flops(Kf, sc) + add_flops(Kf, sc))))

    # ---- phase: step length (min-eigenvalue congruence), X side, using
    # X itself as the direction stand-in (same shapes/cost as dX)
    def ph_eig(sdp_, state_, parts):
        i = 0
        lam = None
        for bk, bs in zip(sdp_.buckets, state_.buckets):
            Xs = _psd_pair(bs, "X_even", "X_odd", bk.shape)
            xs = [rebuild(parts, i + j) for j in range(len(Xs))]
            i += 2 * len(Xs)
            lb = _step_length_lambda(xs, Xs, bk.mask)
            lam = lb if lam is None else torch.minimum(lam, lb)
        return lam

    t, _ = timed(ph_eig, sdp, state, xy_parts)
    ops = 0.0
    for bk, bs in zip(sdp.buckets, state.buckets):
        for M in _psd_pair(bs, "X_even", "X_odd", bk.shape):
            n = M.shape[-1]
            ops += 2 * trsm_ops(M.shape[0], n, n) + cholesky_ops(M.shape[0], n)
    phases.append(("step_length_eig(x1)", t,
                   ops * (mul_flops(Kf, sc) + add_flops(Kf, sc))))

    # ---- total iteration
    samples, _ = _time_samples(make_iteration(cfg), (sdp, state), reps, device)

    return phases, samples


def report(phases, t_total, peak_gflops, reps, peak_dtype):
    """The JAX tool's record, with the TPU's words taken out of its keys:
    `gflops` per phase and `peak_gflops_measured` (0.0 when no peak was
    measured, and then `pct_of_peak` is null), in `peak_dtype`."""
    rows = []
    # the search-direction scan runs the solve phases twice; the measured
    # breakdown here is per-call
    t_sum = sum(t for _, t, _ in phases)
    for name, t, flops in phases:
        g = flops / t / 1e9 if t > 0 else 0.0
        rows.append({
            "phase": name, "ms": round(t * 1e3, 2),
            "pct_of_iteration": round(100 * t / t_total, 1),
            "gflops": round(g, 1),
            "pct_of_peak": round(100 * g / peak_gflops, 1)
            if peak_gflops else None,
        })
    rows.append({"phase": "other (scan: 2x search-direction solves, "
                          "updates, residues)",
                 "ms": round((t_total - t_sum) * 1e3, 2),
                 "pct_of_iteration": round(100 * (t_total - t_sum)
                                           / t_total, 1)})
    return {"iteration_ms": round(t_total * 1e3, 2),
            "peak_gflops_measured": round(peak_gflops, 1),
            "peak_dtype": peak_dtype, "reps": reps, "phases": rows}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    from ..cli.sdpb import MAX_WIDE_LIMBS, resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fixture", required=True)
    p.add_argument("--scaledLimbs", type=int, default=5,
                   help="scaled float32 limbs: 0 = classic float64 limbs "
                        "(K=4), 2-9 one scaled word, 10-18 two words, 19-27 "
                        "three words (wide)")
    p.add_argument("--quant", type=int, default=32)
    p.add_argument("--omega", default="1e6")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--json", default=None, help="also write JSON here")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' only when asked "
                        "for by name, and then no peak is measured)")
    args = p.parse_args(argv)
    if args.scaledLimbs != 0 and not 2 <= args.scaledLimbs <= MAX_WIDE_LIMBS:
        p.error(f"--scaledLimbs takes 0 or 2-{MAX_WIDE_LIMBS}, got {args.scaledLimbs}")

    device = resolve_device(args.device)
    dtype = torch.float32 if args.scaledLimbs else torch.float64
    on_card = device.type == "cuda"
    peak = cuda_core_peak_gflops(dtype=dtype, device=device) if on_card else 0.0
    phases, samples = profile_fixture(
        args.fixture, args.scaledLimbs, args.quant, args.omega, args.reps, device)
    rec = report(phases, sum(samples) / len(samples), peak, args.reps,
                 str(dtype).replace("torch.", ""))
    # each call of the whole iteration, of which `iteration_ms` is the mean
    rec["iteration_samples_ms"] = [round(t * 1e3, 2) for t in samples]
    rec["platform"] = device.type
    if on_card:
        rec["card"] = card_line()
    print(json.dumps(rec, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
