#!/usr/bin/env python3
"""Smoke test of the PyTorch port (sdpb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each fatal on failure:
  1. device: nvidia-smi name and power limit, torch / CUDA / nvcc versions;
  2. build: the CUDA kernels, from sdpb_tpu_torch/csrc, all limb counts,
     classic and scaled;
  3. exactness: TwoSum and TwoProd exact on the card, in plain torch and
     inside the kernels (through 1 x 1 and 1 x 2 mp_matmuls), float64 and
     float32;
  4. classic kernels against their plain PyTorch versions at the solve's
     shapes (120 blocks of the ising ladder), bit-identical limbs, spot
     checks against mpmath, kernel and plain times, bounds;
  5. the dim-2 certificate SDP (fixtures/dim2_certificate/sdp.zip) solved
     to optimality through the CLI entry point at 150 bits, classic: y*
     must match the independently bisected optimum;
  6. the 120-block ladder fixture at 216 bits, classic, for a bounded
     number of iterations: finite statistics, positive steps, falling mu,
     seconds per iteration, peak memory, kernel launch counts;
  7. the scaled kernels against their plain versions at the scaled solve's
     shapes (limbs and exponents bit-identical), spot checks, times, bounds;
  8. the certificate again in the scaled representation, 150 bits (7
     float32 limbs): optimal, y* matches;
  9. the ladder in the scaled representation, 9 float32 limbs (216 bits of
     mantissa), same settings and iterations as phase 6: finite statistics,
     falling mu, s/iteration, peak memory, launches, and the digits its
     objectives share with phase 6's classic run.
The last line of stdout is {"ok": true, "device": {...}}; the line before
it is the kernels' JSON record, and the line before that the card's name
and power limit.  Without CUDA, or outside a checkout, the script exits
non-zero and prints no result.
"""
import json
import math
import subprocess
import sys
import tempfile
import time
from fractions import Fraction
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LADDER = ROOT / "fixtures" / "ising_ladder_120" / "sdp.zip"
CERTIFICATE = ROOT / "fixtures" / "dim2_certificate" / "sdp.zip"
LADDER_ITERATIONS = 10
Y_OPT = "-1.685650770619604657526474"   # bisected independently in mpmath
# (name, source, TPU kernel replaced): the classic build replaces the
# scaled=False branch of each Pallas kernel, the scaled build (the same
# source over csrc/mp_scaled.cuh) its scaled=True branch
KERNELS = {
    "mp_matmul": ("sdpb_tpu_torch/csrc/mp_matmul.cu",
                  "sdpb_tpu/ops/pallas_kernels.py:29"),
    "mp_cholesky": ("sdpb_tpu_torch/csrc/mp_cholesky.cu",
                    "sdpb_tpu/ops/pallas_kernels.py:539"),
    "mp_solve_triangular": ("sdpb_tpu_torch/csrc/mp_trsm.cu",
                            "sdpb_tpu/ops/pallas_kernels.py:576"),
}
# H100 SXM at 700 W (NVIDIA data sheet): non-fused add/mul per second on
# the CUDA cores (34 and 67 TFLOP/s count a fused multiply-add as two) and
# device memory bytes per second
OPS_PER_S = {False: 16.7e12, True: 33.5e12}
BYTES_PER_S = 3.35e12
SOLVE_FLAGS = ("--dualityGapThreshold", "1e-12", "--primalErrorThreshold", "1e-12",
               "--dualErrorThreshold", "1e-12", "--initialMatrixScalePrimal", "1e2",
               "--initialMatrixScaleDual", "1e2", "--maxIterations", "250",
               "--verbosity", "0")
LADDER_FLAGS = ("--dualityGapThreshold", "1e-20", "--primalErrorThreshold", "1e-20",
                "--dualErrorThreshold", "1e-20", "--initialMatrixScalePrimal", "1e4",
                "--initialMatrixScaleDual", "1e4",
                "--maxIterations", str(LADDER_ITERATIONS))


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def phase(name):
    print(f"\n=== {name} ===", flush=True)


def device_phase(torch):
    phase("1. device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    from sdpb_tpu_torch.ops.kernels import _nvcc
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    print(f"device 0: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")
    return smi


def build_phase(kernels):
    phase("2. build")
    t0 = time.time()
    built = kernels.build()
    for scaled in kernels.REPRESENTATIONS:
        for K in kernels.K_RANGE:
            kernels._library(K, scaled)
    print(f"build: {time.time() - t0:.1f} s for K={list(kernels.K_RANGE)}, classic "
          f"and scaled (compiled now: {len(built)} libraries)")
    return time.time() - t0


def exactness_phase(torch, mp, kernels, dev):
    phase("3. exactness")
    import numpy as np
    from sdpb_tpu_torch.ops import eft
    rng = np.random.default_rng(3)
    for dtype in (torch.float64, torch.float32):
        npdt = np.float64 if dtype == torch.float64 else np.float32
        a = (rng.standard_normal(256) * np.exp(rng.uniform(-30, 30, 256))).astype(npdt)
        b = (rng.standard_normal(256) * np.exp(rng.uniform(-30, 30, 256))).astype(npdt)
        ta, tb = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
        s, e = [x.cpu().numpy() for x in eft.two_sum(ta, tb)]
        p, pe = [x.cpu().numpy() for x in eft.two_prod(ta, tb)]
        for i in range(256):
            check(Fraction(float(s[i])) + Fraction(float(e[i])) ==
                  Fraction(float(a[i])) + Fraction(float(b[i])),
                  f"torch two_sum not exact on the card at {i} ({dtype})")
            check(Fraction(float(p[i])) + Fraction(float(pe[i])) ==
                  Fraction(float(a[i])) * Fraction(float(b[i])),
                  f"torch two_prod not exact on the card at {i} ({dtype})")

    def value(o: "mp.MP") -> Fraction:
        limbs = o.limbs.flatten().cpu().numpy()
        v = sum((Fraction(float(x)) for x in limbs), Fraction(0))
        return v if o.exp is None else v * Fraction(2) ** int(o.exp.flatten()[0])

    for scaled, K in ((False, 2), (True, 5)):
        def val(x, shape):
            t = torch.as_tensor(np.asarray(x, dtype=np.float64).reshape(shape), device=dev)
            return mp.from_double(t, K, scaled=True) if scaled else mp.from_double(t, K)
        for i in range(16):
            # product: a x b in the kernel's MP product (exact in K limbs)
            o = kernels.mp_matmul(val([a[i]], (1, 1, 1)), val([b[i]], (1, 1, 1)))
            check(value(o) == Fraction(float(a[i])) * Fraction(float(b[i])),
                  f"kernel TwoProd not exact at {i} (scaled={scaled})")
            # sum: [a_i, b_i] . [1, 1] through the kernel's MP adds
            o = kernels.mp_matmul(val([a[i], b[i]], (1, 1, 2)), val([1.0, 1.0], (1, 2, 1)))
            check(value(o) == Fraction(float(a[i])) + Fraction(float(b[i])),
                  f"kernel TwoSum not exact at {i} (scaled={scaled})")
    print("two_sum / two_prod exact in plain torch (256 pairs, float64 and float32) "
          "and in the classic and scaled kernels (16 pairs each)")


# ---------------------------------------------------------------------------
# Kernel phases: inputs, timing, bounds


def _limbs(rng, shape, K, spd=False, decades=0.0):
    """Random float64 limb stacks with fresh bits in every limb; spd makes
    symmetric positive definite blocks G G^T + n I, graded over
    2 * decades decades by a diagonal scaling."""
    import numpy as np
    top = rng.standard_normal(shape)
    if spd:
        top = top @ np.swapaxes(top, -1, -2) + shape[-1] * np.eye(shape[-1])
        d = 10.0 ** rng.uniform(-decades, decades, shape[:-1])
        top = top * d[..., :, None] * d[..., None, :]
        top = (top + np.swapaxes(top, -1, -2)) / 2
    elif decades:
        top = top * 10.0 ** rng.uniform(-decades, decades, shape)
    out = np.zeros((K,) + tuple(shape))
    out[0] = top
    for k in range(1, K):
        out[k] = (out[k - 1] * 2.0 ** -53 * rng.uniform(0.5, 1.0, shape)
                  * rng.choice([-1.0, 1.0], shape))
    if spd:
        out = (out + np.swapaxes(out, -1, -2)) / 2
    return out


def _time_ms(torch, fn, reps=5):
    """Median of `reps` CUDA-event timings after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return sorted(ts)[len(ts) // 2]


def _timed_once(torch, fn):
    """(result, ms) of one call timed with CUDA events."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def _mpf(limbs, exp=0):
    import mpmath
    return mpmath.fsum(mpmath.mpf(float(x)) for x in limbs) * mpmath.mpf(2) ** int(exp)


def _renorm_ops(K, M):
    """Float operations of renorm_terms<K, M> (mp.cuh): K TwoSum sweeps (6
    each), the residue chain, 2K-1 quick TwoSums (3 each)."""
    return 6 * sum(M - 1 - k for k in range(K)) + (M - 1 - K) + 3 * (2 * K - 1)


def mp_op_counts(K, scaled):
    """Float operations of one MP add, mul, rsqrt and reciprocal inside the
    kernels, counted from mp.cuh / mp_scaled.cuh (split 5, TwoSum 6; a
    scaled add aligns both operands and normalizes, 3 multiplies per limb
    each; a scaled product prescales 2K limbs and puts each of its K^2+1
    terms back with 2 multiplies; integer exponent work is not counted)."""
    from sdpb_tpu_torch.ops.mpfloat import newton_steps
    add = _renorm_ops(K, 2 * K)
    mul = (10 * K + K * (K + 1) // 2 + 8 * (K * (K - 1) // 2) + (2 * K - 3)
           + _renorm_ops(K, K * K + 1))
    seed = 3
    if scaled:
        add += 9 * K
        mul += 2 * K + 2 * (K * K + 1) + 3 * K
        seed += 2 + 3 * K
    steps = newton_steps(K)
    rsqrt = seed + steps * (4 * mul + add)
    recip = seed + steps * (2 * mul + 2 * add)
    return add, mul, rsqrt, recip


def kernel_bound(name, shape, K, scaled):
    """(bound_ms, bound_by): the larger of the float operations over the
    card's rate and the bytes (inputs read once, outputs written once) over
    its memory rate, for one call at `shape`."""
    add, mul, rsqrt, recip = mp_op_counts(K, scaled)
    per_elem = K * (4 if scaled else 8) + (4 if scaled else 0)
    if name == "mp_matmul":
        B, M, Kd, N = shape
        ops = B * M * N * 8 * math.ceil(Kd / 8) * (mul + add)
        elems = B * (M * Kd + Kd * N + M * N)
    elif name == "mp_cholesky":
        B, n = shape
        ops = B * sum(rsqrt + mul + (n - 1 - j) * mul
                      + (n - 1 - j) * (n - j) // 2 * (mul + add) for j in range(n))
        elems = 2 * B * n * n
    else:
        B, n, m = shape
        ops = B * (n * recip + n * m * mul + m * n * (n - 1) // 2 * (mul + add))
        elems = B * (n * n + 2 * n * m)
    t_ops = ops / OPS_PER_S[scaled]
    t_bytes = elems * per_elem / BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _err(k, p):
    """max |kernel - plain| over the limbs; inf where exponents differ."""
    if k.exp is not None and not bool((k.exp == p.exp).all()):
        return float("inf")
    return float((k.limbs.double() - p.limbs.double()).abs().max())


def kernel_phase(torch, mp, kernels, dev, scaled):
    """Each kernel of one representation against its plain version at the
    ladder solve's shapes: bit-identical limbs (and exponents), a spot
    check against mpmath, kernel and plain times, the bound."""
    import mpmath
    import numpy as np
    rng = np.random.default_rng(7 if scaled else 4)
    if scaled:
        # the scaled ladder: 9 limbs (216 bits); factor 8 limbs as
        # initial_factor_limbs gives at Omega=1e4, gap 1e-20, 24-bit limbs
        Kg, Kf, decades, mant = 9, 8, 3.0, 24
        phase("7. scaled kernels against plain versions (ladder shapes)")
    else:
        Kg, Kf, decades, mant = 5, 4, 0.0, 53
        phase("4. classic kernels against plain versions (ladder shapes)")

    def C(x, K):
        if scaled:
            return mp.from_parts(*mp.f64_limbs_to_scaled_parts(x, K), dev)
        return mp.MP(torch.as_tensor(x[:K], device=dev))

    def host(o):
        limbs = o.limbs.cpu().numpy()
        exp = o.exp.cpu().numpy() if scaled else np.zeros(limbs.shape[1:], np.int64)
        return lambda idx: _mpf(limbs[(slice(None),) + idx], exp[idx])

    K64 = -(-(24 * Kg) // 53) + 1 if scaled else Kg
    rows = []

    def compare(name, shape, out_k, out_p, spot, K, pms):
        err = _err(out_k, out_p)
        check(err == 0.0, f"{name} {shape}: kernel differs from plain (max {err})")
        with mpmath.workprec(mant * K + 80):
            worst = max(spot(i) for i in range(20))
        check(worst < mpmath.mpf(2) ** -(mant * K - 10),
              f"{name} {shape}: spot check vs mpmath {worst}")
        return err, float(worst)

    for (B, M, Kd, N) in ((120, 20, 20, 19), (120, 15, 57, 15)):
        a = _limbs(rng, (B, M, Kd), K64, decades=decades)
        b = _limbs(rng, (B, Kd, N), K64, decades=decades)
        A, Bm = C(a, Kg), C(b, Kg)
        ok = kernels.mp_matmul(A, Bm)
        op, pms = _timed_once(torch, lambda: kernels.mp_matmul_plain(A, Bm))
        ha, hb, ho = host(A), host(Bm), host(ok)

        def spot(i, B=B, M=M, N=N, Kd=Kd, ha=ha, hb=hb, ho=ho):
            r = np.random.default_rng(i)
            bi, mi, ni = r.integers(B), r.integers(M), r.integers(N)
            terms = [ha((bi, mi, t)) * hb((bi, t, ni)) for t in range(Kd)]
            return abs(ho((bi, mi, ni)) - mpmath.fsum(terms)) / \
                mpmath.fsum(abs(t) for t in terms)
        err, worst = compare("mp_matmul", (B, M, Kd, N), ok, op, spot, Kg, pms)
        ms = _time_ms(torch, lambda: kernels.mp_matmul(A, Bm))
        bound, by = kernel_bound("mp_matmul", (B, M, Kd, N), Kg, scaled)
        rows.append(("mp_matmul", f"[{B},{M},{Kd}]@[{B},{Kd},{N}] K={Kg}",
                     err, worst, ms, pms, bound, by))

    chol = {}
    for n in (57, 20):
        B = 120
        A = C(_limbs(rng, (B, n, n), -(-(24 * Kf) // 53) + 1 if scaled else Kf,
                     spd=True, decades=decades), Kf)
        ok = kernels.mp_cholesky(A)
        op, pms = _timed_once(torch, lambda: kernels.mp_cholesky_plain(A))
        chol[n] = ok
        ha, hL = host(A), host(ok)

        def spot(i, n=n, B=B, ha=ha, hL=hL):
            r = np.random.default_rng(100 + i)
            bi, ii = r.integers(B), r.integers(n)
            jj = r.integers(ii + 1)
            rec = mpmath.fsum(hL((bi, ii, t)) * hL((bi, jj, t)) for t in range(jj + 1))
            return abs(rec - ha((bi, ii, jj))) / \
                mpmath.sqrt(abs(ha((bi, ii, ii)) * ha((bi, jj, jj))))
        err, worst = compare("mp_cholesky", (B, n, n), ok, op, spot, Kf, pms)
        ms = _time_ms(torch, lambda: kernels.mp_cholesky(A))
        bound, by = kernel_bound("mp_cholesky", (B, n), Kf, scaled)
        rows.append(("mp_cholesky", f"[{B},{n},{n}] K={Kf}", err, worst, ms, pms,
                     bound, by))

    L = chol[57]
    B, n, m = 120, 57, 15
    Bm = C(_limbs(rng, (B, n, m), -(-(24 * Kf) // 53) + 1 if scaled else Kf,
                  decades=decades), Kf)
    hL, hb = host(L), host(Bm)
    for lower in (True, False):
        T = L if lower else mp.MP(L.limbs.mT.contiguous(),
                                  None if L.exp is None else L.exp.mT.contiguous())
        ok = kernels.mp_solve_triangular(T, Bm, lower)
        op, pms = _timed_once(torch, lambda: kernels.mp_solve_triangular_plain(T, Bm, lower))
        hX = host(ok)

        def spot(i, lower=lower, hX=hX):
            r = np.random.default_rng(200 + i)
            bi, ii, c = r.integers(B), r.integers(n), r.integers(m)
            ts = range(ii + 1) if lower else range(ii, n)
            terms = [(hL((bi, ii, t)) if lower else hL((bi, t, ii))) * hX((bi, t, c))
                     for t in ts]
            return abs(mpmath.fsum(terms) - hb((bi, ii, c))) / \
                (mpmath.fsum(abs(t) for t in terms) + abs(hb((bi, ii, c))))
        err, worst = compare("mp_solve_triangular", (B, n, m, lower), ok, op, spot,
                             Kf, pms)
        ms = _time_ms(torch, lambda: kernels.mp_solve_triangular(T, Bm, lower))
        bound, by = kernel_bound("mp_solve_triangular", (B, n, m), Kf, scaled)
        rows.append(("mp_solve_triangular",
                     f"[{B},{n},{n}]\\[{B},{n},{m}] {'lower' if lower else 'upper'} K={Kf}",
                     err, worst, ms, pms, bound, by))

    print(f"{'kernel':22s} {'shape':40s} {'max|k-p|':>9s} {'vs mpmath':>10s} "
          f"{'kernel ms':>10s} {'plain ms':>10s} {'bound ms':>10s} bound by")
    for name, shape, err, worst, ms, pms, bound, by in rows:
        print(f"{name:22s} {shape:40s} {err:9.1e} {worst:10.2e} {ms:10.3f} "
              f"{pms:10.1f} {bound:10.4f} {by}")
    return rows


def _y_value(res):
    """y* of the one-dimensional dual as an mpmath value."""
    import numpy as np
    from sdpb_tpu_torch.ops.mpfloat import host_f64_limbs
    return _mpf(np.asarray(host_f64_limbs(res.state.y))[:, 0])


def certificate_phase(torch, kernels, cli, dev, scaled):
    label = ("8. dim-2 certificate solve, scaled (150 bits, 7 float32 limbs)"
             if scaled else "5. dim-2 certificate solve (150 bits)")
    phase(label)
    import mpmath
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out"
        kernels.reset_launches()
        t0 = time.time()
        res = cli.run(["-s", str(CERTIFICATE), "-o", str(out), "--device", str(dev),
                       "--precision", "150", *SOLVE_FLAGS,
                       "--arithmetic", "scaled" if scaled else "classic"])
        dt = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        check((out / "out.txt").exists(), "out.txt not written")
        with mpmath.workprec(300):
            y = _y_value(res)
            dy = abs(y - mpmath.mpf(Y_OPT))
        print(f"{res.terminate_reason} after {res.iterations} iterations in "
              f"{dt:.1f} s; y* = {mpmath.nstr(y, 25)}, |y* - y_opt| = "
              f"{mpmath.nstr(dy, 3)}; launches {launches}")
        print((out / "out.txt").read_text().strip())
    check(str(res.terminate_reason) == "found primal-dual optimal solution",
          f"certificate solve ended with {res.terminate_reason}")
    check(dy < mpmath.mpf("1e-10"), f"y* off by {dy}")
    path = [kernels.counter(n, scaled) for n in kernels.KERNEL_NAMES]
    check(all(launches[n] > 0 for n in path), f"a kernel did not run: {launches}")
    return {"iterations": res.iterations, "seconds": dt, "dy": float(dy)}


def ladder_phase(torch, kernels, cli, dev, scaled, classic=None):
    from sdpb_tpu_torch.solver.solve import host_mpf
    import mpmath
    import numpy as np
    if scaled:
        # --precision 208 takes 9 float32 limbs (216 bits of mantissa, with
        # the 8 guard bits); 216 would need 10, the unported wide path
        phase(f"9. ising ladder, scaled, 9 float32 limbs (216 bits), "
              f"{LADDER_ITERATIONS} iterations")
        prec = ["--precision", "208", "--arithmetic", "scaled"]
    else:
        phase(f"6. ising ladder, 120 blocks, 216 bits, {LADDER_ITERATIONS} iterations")
        prec = ["--precision", "216"]
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        res = cli.run(["-s", str(LADDER), "-o", str(Path(tmp) / "out"),
                       "--device", str(dev), *prec, *LADDER_FLAGS])
        wall = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
    hist = res.history
    check(len(hist) >= LADDER_ITERATIONS, f"only {len(hist)} iterations ran")
    for i, st in enumerate(hist):
        for name in st._fields:
            v = getattr(st, name)
            v = v[0] if isinstance(v, tuple) else v
            check(np.all(np.isfinite(np.asarray(v, dtype=float))),
                  f"iteration {i + 1}: {name} not finite")
        check(st.primal_step > 0 and st.dual_step > 0, f"iteration {i + 1}: step <= 0")
    mus = [float(host_mpf(st.mu)) for st in hist]
    check(all(b < a for a, b in zip(mus, mus[1:])), f"mu does not fall: {mus}")
    its = res.iteration_seconds
    steady = sorted(its[1:])[len(its[1:]) // 2] if len(its) > 1 else its[0]
    print(f"{res.terminate_reason}; {len(hist)} iterations in {sum(its):.1f} s "
          f"(wall {wall:.1f} s incl. reading the zip); first {its[0]:.2f} s, "
          f"steady median {steady:.3f} s/iteration; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}")
    print(f"mu: {' '.join(f'{m:.3e}' for m in mus)}")
    path = [kernels.counter(n, scaled) for n in kernels.KERNEL_NAMES]
    check(all(launches[n] > 0 for n in path), f"a kernel did not run: {launches}")
    out = {"launches": launches, "s_per_it": steady, "peak_bytes": peak, "history": hist}
    if classic is not None:
        # significant digits the objectives share with the classic run,
        # the least over iterations and over the two objectives
        digits = math.inf
        same_steps = 0
        with mpmath.workprec(400):
            for mine, ref in zip(hist, classic["history"]):
                same_steps += (mine.primal_step, mine.dual_step) == \
                    (ref.primal_step, ref.dual_step)
                for f in ("primal_objective", "dual_objective"):
                    a, b = host_mpf(getattr(mine, f)), host_mpf(getattr(ref, f))
                    if a != b:
                        digits = min(digits, float(-mpmath.log10(abs(a - b) / abs(b))))
        print(f"objectives agree with the classic run to {digits:.1f} significant "
              f"digits over {len(hist)} iterations, step lengths identical in "
              f"{same_steps}; s/iteration scaled {steady:.3f} vs classic "
              f"{classic['s_per_it']:.3f}")
        check(digits >= 15, f"scaled objectives share only {digits:.1f} digits")
        out["digits"] = digits
    return out


def main():
    if not (ROOT / "sdpb_tpu_torch").is_dir() or not LADDER.exists() \
            or not CERTIFICATE.exists():
        print("chip_smoke.py must run from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs one CUDA card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    from sdpb_tpu_torch.cli import sdpb as cli
    from sdpb_tpu_torch.ops import kernels, mpfloat as mp

    t_start = time.time()
    smi = device_phase(torch)
    build_s = build_phase(kernels)
    exactness_phase(torch, mp, kernels, dev)
    rows = kernel_phase(torch, mp, kernels, dev, scaled=False)
    cert = certificate_phase(torch, kernels, cli, dev, scaled=False)
    ladder = ladder_phase(torch, kernels, cli, dev, scaled=False)
    srows = kernel_phase(torch, mp, kernels, dev, scaled=True)
    scert = certificate_phase(torch, kernels, cli, dev, scaled=True)
    sladder = ladder_phase(torch, kernels, cli, dev, scaled=True, classic=ladder)
    check("jax" not in sys.modules, "the port imported jax")
    check(not any(m == "sdpb_tpu" or m.startswith("sdpb_tpu.") for m in sys.modules),
          "the port imported the JAX package")

    record = []
    for scaled, krows, run in ((False, rows, ladder), (True, srows, sladder)):
        for name, (source, replaces) in KERNELS.items():
            mine = [r for r in krows if r[0] == name]
            first = mine[-1] if name == "mp_matmul" else mine[0]
            key = kernels.counter(name, scaled)
            record.append({"name": key, "route": "cuda", "source": source,
                           "replaces": replaces, "launches": run["launches"][key],
                           "max_abs_err": max(r[2] for r in mine),
                           "ms": first[4], "plain_ms": first[5],
                           "bound_ms": first[6], "bound_by": first[7],
                           "library_ms": None})
    print(f"\nsummary: build {build_s:.1f} s; certificate {cert['iterations']} "
          f"iterations classic, {scert['iterations']} scaled; ladder "
          f"{ladder['s_per_it']:.3f} s/iteration classic (K=5), "
          f"{sladder['s_per_it']:.3f} scaled (K=9); peak "
          f"{ladder['peak_bytes'] / 2**30:.2f} / {sladder['peak_bytes'] / 2**30:.2f} GiB; "
          f"objectives shared to {sladder['digits']:.1f} digits; "
          f"total {time.time() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
