"""Device time per ladder iteration of the GEMMs, the factor and the triangular solve of a checkout.

    python3 sdpb_tpu_torch/tools/kernel_times.py [--root DIR] [--labels LABEL ...]

Run it as a file (not with -m), on a CUDA card.  `--root` names the
checkout whose `sdpb_tpu_torch` is imported and timed (default: the one
holding this script); run it for two checkouts in turns (parent, change,
change, parent), each in its own process, to compare their kernels on one
card.  The shapes come from the solver: one CLI run of the 120-block ising
ladder per representation (classic 216 bits, scaled 208 bits, wide 400
bits, three words at 640 bits, classic13: classic at 640 bits, GEMMs at
K = 13, the factor and solves at Kf = 7; two iterations each) with the
wrapper calls tallied by shape, as in chip_smoke.py's phases 6, 9, 11 and
17 (at three words the GEMM, the elementwise sum and the product); each
tallied shape is then timed as
those phases do (chip_smoke.iteration_kernel_ms, from the chip_smoke.py
at the root of the checkout holding this script, for both checkouts) but
with chip_smoke._queued_ms: CUDA events around 10 calls queued behind a
spin, so that the kernels are timed and not their wrappers' host time.
Then the factor alone over the batch, B = 1 and 120 at n = 20 and 57
(classic Kf = 4, scaled Kf = 8 and 9), scaled Kf = 8 at n = 57 for B
from 1 to 120, and scaled Kf = 9 at [1,15,15] (the wide paths' Q): one
block a batch element, so a time that hardly moves with B is the pivot
chain's.  The last line is one JSON object: the card,
ms per iteration by launch counter for each representation, and the
factor's ms by batch; for wide3 and classic13 also the ladder in the
chunked loop (chunks of chip_smoke.WIDE3_CHUNK over the same iterations):
s/replay and a replay's device ms of graph A, the eigvalsh calls and
graph B.
`--labels` picks the representations (classic, scaled, wide, wide3,
classic13; default all; none with `--labels` alone); the factor sweep
runs with any of them.  With wide3, the three-word sum (wide3_sum): each
tallied sum shape timed through its wrapper as the solver calls it
(broadcast operands made full inside it) and on operands already full and
contiguous, and the sum at chip_smoke.WIDE3_EW_SHAPES, Kg = 9, 8 and 7,
beside its bound (chip_smoke.kernel_bound, less the word TwoSums the
plain version's tally leaves as they are).  `--ladder-sums` times the
sum instead on the operands the three-word ladder passes it: every sum
call of one host-loop iteration at --precision 640 recorded (copies on
the card), each timed queued on its own operands and summed, and, from
the plain version's word TwoSums on the first 4,096 elements of each
call, the share of elements that need each of them (words within 24 Kg
digits) and, per warp of 32 elements, the word TwoSums renormalize's
order runs (each one some element needs) against those of the busiest
element (what a per-element walk of the list runs).  `--classic-ks` and `--scaled-ks` time, for each
limb count named, the GEMM at chip_smoke.GEMM_SHAPES, the factor at n =
57 and 20 and the lower solve of [120,57,57] against [120,57,15] (phase
4's shapes, every kernel at that K) the same way.
"""
import argparse
import contextlib
import importlib.util
import io
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
LABELS = ("classic", "scaled", "wide", "wide3", "classic13")
# (scaled, Kf, n, batches) of the factor's batch sweep
FACTOR_SWEEP = ((False, 4, 20, (1, 120)), (False, 4, 57, (1, 120)),
                (True, 8, 20, (1, 120)), (True, 8, 57, (1, 16, 33, 66, 100, 120)),
                (True, 9, 15, (1,)), (True, 9, 20, (1, 120)), (True, 9, 57, (1, 120)))


def kernel_sweep(cs, torch, mp, kernels, dev, scaled, K):
    """{label: ms} of the GEMM, the factor and the lower solve at phase 4's
    shapes in one representation at K limbs (chip_smoke._queued_ms), each
    printed beside its bound (chip_smoke.kernel_bound) and share of it."""
    import numpy as np
    rng = np.random.default_rng(5 + K)
    K64 = -(-(24 * K) // 53) + 1 if scaled else K
    decades = 3.0 if scaled else 0.0
    tag = f"{'scaled' if scaled else 'classic'} K={K}"

    def operand(shape, spd=False):
        x = cs._limbs(rng, shape, K64, spd=spd, decades=decades)
        return (mp.from_parts(*mp.f64_limbs_to_scaled_parts(x, K), dev) if scaled
                else mp.MP(torch.as_tensor(x, device=dev)))

    out = {}

    def timed(label, fn, name, shape):
        out[label] = cs._queued_ms(torch, fn)
        bound, by = cs.kernel_bound(name, shape, K, scaled)
        print(f"{label}: {out[label]:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{bound / out[label]:.1%} of it", flush=True)

    for B, M, Kd, N in cs.GEMM_SHAPES:
        a, b = operand((B, M, Kd)), operand((B, Kd, N))
        timed(f"mp_matmul {tag} [{B},{M},{Kd}]@[{B},{Kd},{N}]", lambda: kernels.mp_matmul(a, b),
              "mp_matmul", (B, M, Kd, N))
    factors = {}
    for n in (57, 20):
        A = operand((120, n, n), spd=True)
        factors[n] = kernels.mp_cholesky(A)
        timed(f"mp_cholesky {tag} [120,{n},{n}]", lambda: kernels.mp_cholesky(A),
              "mp_cholesky", (120, n))
    rhs = operand((120, 57, 15))
    timed(f"mp_solve_triangular {tag} [120,57,57]\\[120,57,15] lower",
          lambda: kernels.mp_solve_triangular(factors[57], rhs, True),
          "mp_solve_triangular", (120, 57, 15))
    return out


def wide3_sum(cs, torch, mp, kernels, dev, tally, iterations):
    """The three-word sum's detail ({label: ms}, chip_smoke._queued_ms):
    each tallied shape through the wrapper on the tally's operands (a
    broadcast operand as the solver passes it) and on the same values
    broadcast, full and contiguous; then the sum at WIDE3_EW_SHAPES for
    Kg = 9, 8, 7 with its bound and share."""
    import numpy as np
    from sdpb_tpu_torch.ops import mpwide, mpwide_kernel as wk
    out = {}

    def on(x, shape=None):
        words = [mp.MP(w.limbs.to(dev), w.exp.to(dev)) for w in x.words]
        if shape is not None:
            fill = (1,) * (len(shape) - x.ndim)
            words = [mp.MP(torch.broadcast_to(w.limbs.reshape((w.K,) + fill + tuple(w.shape)),
                                              (w.K,) + tuple(shape)).contiguous(),
                           torch.broadcast_to(w.exp, tuple(shape)).contiguous())
                     for w in words]
        return mpwide.MPW(words)

    for key, count in sorted(tally.items(), key=lambda kv: cs._call_label(kv[0])):
        name, rep, K, ash, bsh, _ = key
        if name != "mp_wide3_add":
            continue
        rng = np.random.default_rng(sum(ash) + 7 * sum(bsh) + K)
        ha, hb = (cs._wide_operand(rng, sh, K, 2.0, G=3) for sh in (ash, bsh))
        shape = tuple(torch.broadcast_shapes(ash, bsh))
        a, b = on(ha), on(hb)
        full_a, full_b = on(ha, shape), on(hb, shape)
        call = cs._queued_ms(torch, lambda: kernels.mp_wide3_add(a, b))
        full = cs._queued_ms(torch, lambda: kernels.mp_wide3_add(full_a, full_b))
        bound, _ = cs.kernel_bound("mp_wide3_add", shape, K, True)
        label = cs._call_label(key)
        out[label] = {"per_iteration": count / iterations, "call_ms": call, "full_ms": full,
                      "bound_ms": bound}
        print(f"  {label}: {count / iterations:g} per iteration; {call:.4f} ms as called, "
              f"{full:.4f} ms on full operands, bound {bound:.4f} ms", flush=True)
    rng = np.random.default_rng(17)
    for Kg in (9, 8, 7):
        for shape in cs.WIDE3_EW_SHAPES:
            a, b = (on(cs._wide_operand(rng, shape, Kg, 2.0, G=3)) for _ in range(2))
            ms = cs._queued_ms(torch, lambda: kernels.mp_wide3_add(a, b))
            tally = wk.SkipTally()
            kernels.mp_wide3_add_plain(a, b, tally)
            bound, _ = cs.kernel_bound("mp_wide3_add", shape, Kg, True, tally.count)
            label = f"mp_wide3_add [{','.join(map(str, shape))}] Kg={Kg}"
            out[label] = {"ms": ms, "bound_ms": bound, "share": bound / ms}
            print(f"  {label}: {ms:.4f} ms, bound {bound:.4f} ms, {bound / ms:.1%} of it",
                  flush=True)
    return out


@contextlib.contextmanager
def _recorded_sums(torch, kernels):
    """Every kernels.mp_wide3_add call while the block runs, its operands
    copied (the solver may reuse their storage): a list of (a, b)."""
    from sdpb_tpu_torch.ops import mpfloat as mp, mpwide
    calls, add = [], kernels.mp_wide3_add

    def copy(x):
        return mpwide.MPW(mp.MP(w.limbs.clone(), w.exp.clone()) for w in x.words)

    def record(a, b):
        calls.append((copy(a), copy(b)))
        return add(a, b)

    kernels.mp_wide3_add = record
    try:
        yield calls
    finally:
        kernels.mp_wide3_add = add


def sum_need(torch, kernels, calls, elements=4096):
    """The word TwoSums of the three-word sums `calls` ([(a, b)]), from the
    plain version on the first `elements` elements of each call: the share
    of elements whose words lie within 24 Kg digits at each of
    renormalize<6>'s 20 word TwoSums, their mean per element, and per warp
    of 32 elements those that renormalize's order runs (each one some
    element of the warp needs) and those of its busiest element in each of
    the two lists (the sweeps' 12, the rounds' 8), which a per-element
    walk of the lists runs."""
    from sdpb_tpu_torch.ops import mpwide_kernel as wk
    need, lanes, union, busiest, warps = None, 0, 0, 0, 0
    for a, b in calls:
        shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
        n = min(elements, int(torch.Size(shape).numel()))
        words = [[(l.reshape(l.shape[0], -1)[:, :n], e.reshape(-1)[:n])
                  for l, e in kernels._wide3_words(x, shape)] for x in (a, b)]
        far = []
        wk.wadd_g_c(*words, a.Kg, far.append)
        sites = ~torch.stack(far)
        need = sites.sum(1) if need is None else need + sites.sum(1)
        lanes += n
        pad = torch.zeros(sites.shape[0], -n % 32, dtype=torch.bool, device=sites.device)
        by_warp = torch.cat([sites, pad], 1).reshape(sites.shape[0], -1, 32)
        warps += by_warp.shape[1]
        union += int(by_warp.any(2).sum())
        busiest += int(by_warp[:12].sum(0).max(1).values.sum()
                       + by_warp[12:].sum(0).max(1).values.sum())
    return {"elements_sampled": lanes,
            "need_by_site": [round(int(c) / lanes, 4) for c in need],
            "two_sums_per_element": int(need.sum()) / lanes,
            "two_sums_per_warp_renormalize": union / warps,
            "two_sums_per_warp_walk": busiest / warps}


def ladder_sums(cs, torch, kernels, cli, dev):
    """The three-word sum on the ladder's own operands (--ladder-sums):
    ms per iteration (each recorded call queued on its own operands,
    summed) and sum_need of the recorded calls."""
    with contextlib.redirect_stdout(io.StringIO()):
        with _recorded_sums(torch, kernels) as calls:
            run = cs._ladder_run(torch, kernels, cli, dev, list(cs.WIDE3_PREC), 1,
                                 cs.kernel_path(kernels, "wide3"))
    its = run["iterations"]
    ms = [cs._queued_ms(torch, lambda: kernels.mp_wide3_add(a, b), reps=3) for a, b in calls]
    out = {"iterations": its, "calls_per_iteration": len(calls) / its,
           "ms_per_iteration": sum(ms) / its, **sum_need(torch, kernels, calls)}
    print(f"the sum on the ladder's operands: {out}", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(HERE))
    p.add_argument("--labels", nargs="*", default=LABELS, choices=LABELS)
    p.add_argument("--classic-ks", type=int, nargs="+", default=[], metavar="K")
    p.add_argument("--scaled-ks", type=int, nargs="+", default=[], metavar="K")
    p.add_argument("--ladder-sums", action="store_true",
                   help="only the three-word sum on the ladder's own operands")
    args = p.parse_args(argv)
    if args.ladder_sums:
        args.labels = []
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_times.py needs a CUDA card", file=sys.stderr)
        return 2
    from sdpb_tpu_torch.cli import sdpb as cli
    from sdpb_tpu_torch.ops import kernels, mpfloat as mp
    from sdpb_tpu_torch.tools.profile_phases import card_line
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the context, before the first memory-stats call
    card = card_line()
    print(f"checkout {root}; card {card}", flush=True)
    t0 = time.time()
    # the ladder's limbs: classic K=5 (factor 4), scaled K32=9 (factor 8),
    # wide Kg=9 (factor 9 on word 0), three words Kg=9 (factor 9), classic
    # K=13 (factor 7)
    if args.labels:
        kernels.build([4, 5, 8, 9], [False, True], [9], probe=False,
                      wide3_Ks=[7, 8, 9] if "wide3" in args.labels else [9])
    classic_ks = set(args.classic_ks) | ({7, 13} if "classic13" in args.labels else set())
    kernels.build(sorted(classic_ks), [False], [], probe=False, wide3_Ks=[])
    kernels.build(args.scaled_ks, [True], [], probe=False, wide3_Ks=[])
    if args.ladder_sums:
        kernels.build([9], [True], [], probe=False, wide3_Ks=[9])
        print(f"build {time.time() - t0:.1f} s", flush=True)
        print(json.dumps({"root": str(root), "card": card,
                          "ladder_sums": ladder_sums(cs, torch, kernels, cli, dev)}))
        return 0
    print(f"build {time.time() - t0:.1f} s", flush=True)
    out = {}
    precs = dict(cs.LADDER_PREC, wide3=cs.WIDE3_PREC, classic13=cs.CLASSIC13_PREC)
    replay, sums = {}, {}
    for label in args.labels:
        path = cs.kernel_path(kernels, "classic" if label == "classic13" else label)
        with contextlib.redirect_stdout(io.StringIO()):
            run = cs._ladder_run(torch, kernels, cli, dev, list(precs[label]), 1, path)
        print(f"{label}:", flush=True)
        out[label] = cs.iteration_kernel_ms(torch, mp, kernels, dev, run["tally"],
                                            run["iterations"], cs._queued_ms)
        if label == "wide3":
            print("wide3_sum:", flush=True)
            sums = wide3_sum(cs, torch, mp, kernels, dev, run["tally"], run["iterations"])
        if label in ("wide3", "classic13"):
            with contextlib.redirect_stdout(io.StringIO()):
                chunked = cs._ladder_run(torch, kernels, cli, dev, list(precs[label]), 1, path,
                                         chunk_iterations=cs.WIDE3_CHUNK)
            parts = [statistics.median(p) for p in zip(*chunked["result"].replay_ms)]
            replay[label] = {"s_per_replay": chunked["s_per_it"], "graph_a_ms": parts[0],
                             "eigvalsh_ms": parts[1], "graph_b_ms": parts[2]}
            print(f"{label} chunked loop: {replay[label]}", flush=True)
    factor = {}
    rng = np.random.default_rng(11)
    sweep = FACTOR_SWEEP if args.labels else ()
    for scaled, K, n, batches in sweep:
        for B in batches:
            limbs = cs._limbs(rng, (B, n, n), -(-(24 * K) // 53) + 1 if scaled else K,
                              spd=True, decades=3.0 if scaled else 0.0)
            A = (mp.from_parts(*mp.f64_limbs_to_scaled_parts(limbs, K), dev) if scaled
                 else mp.MP(torch.as_tensor(limbs, device=dev)))
            label = f"mp_cholesky {'scaled' if scaled else 'classic'} K={K} [{B},{n},{n}]"
            factor[label] = cs._queued_ms(torch, lambda: kernels.mp_cholesky(A))
            print(f"{label}: {factor[label]:.4f} ms, {factor[label] / n:.4f} ms a pivot",
                  flush=True)
    limbs = {}
    for scaled, Ks in ((False, args.classic_ks), (True, args.scaled_ks)):
        for K in Ks:
            limbs.update(kernel_sweep(cs, torch, mp, kernels, dev, scaled, K))
    print(json.dumps({"root": str(root), "card": card, "ms_per_iteration": out,
                      "replay": replay, "wide3_sum": sums, "factor_ms": factor,
                      "kernel_ms": limbs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
