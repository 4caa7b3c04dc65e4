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
factor's ms by batch; for classic13 also the ladder in the chunked loop
(chunks of chip_smoke.WIDE3_CHUNK over the same iterations): s/replay
and a replay's device ms of graph A, the eigvalsh calls and graph B.
`--labels` picks the representations (classic, scaled, wide, wide3,
classic13; default all; none with `--labels` alone); the factor sweep
runs with any of them.  `--classic-ks` and `--scaled-ks` time, for each
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
    shapes in one representation at K limbs (chip_smoke._queued_ms)."""
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

    def timed(label, fn):
        out[label] = cs._queued_ms(torch, fn)
        print(f"{label}: {out[label]:.4f} ms", flush=True)

    for B, M, Kd, N in cs.GEMM_SHAPES:
        a, b = operand((B, M, Kd)), operand((B, Kd, N))
        timed(f"mp_matmul {tag} [{B},{M},{Kd}]@[{B},{Kd},{N}]", lambda: kernels.mp_matmul(a, b))
    factors = {}
    for n in (57, 20):
        A = operand((120, n, n), spd=True)
        factors[n] = kernels.mp_cholesky(A)
        timed(f"mp_cholesky {tag} [120,{n},{n}]", lambda: kernels.mp_cholesky(A))
    rhs = operand((120, 57, 15))
    timed(f"mp_solve_triangular {tag} [120,57,57]\\[120,57,15] lower",
          lambda: kernels.mp_solve_triangular(factors[57], rhs, True))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(HERE))
    p.add_argument("--labels", nargs="*", default=LABELS, choices=LABELS)
    p.add_argument("--classic-ks", type=int, nargs="+", default=[], metavar="K")
    p.add_argument("--scaled-ks", type=int, nargs="+", default=[], metavar="K")
    args = p.parse_args(argv)
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
        kernels.build([4, 5, 8, 9], [False, True], [9], probe=False, wide3_Ks=[9])
    classic_ks = set(args.classic_ks) | ({7, 13} if "classic13" in args.labels else set())
    kernels.build(sorted(classic_ks), [False], [], probe=False, wide3_Ks=[])
    kernels.build(args.scaled_ks, [True], [], probe=False, wide3_Ks=[])
    print(f"build {time.time() - t0:.1f} s", flush=True)
    out = {}
    precs = dict(cs.LADDER_PREC, wide3=cs.WIDE3_PREC, classic13=cs.CLASSIC13_PREC)
    replay = {}
    for label in args.labels:
        path = cs.kernel_path(kernels, "classic" if label == "classic13" else label)
        with contextlib.redirect_stdout(io.StringIO()):
            run = cs._ladder_run(torch, kernels, cli, dev, list(precs[label]), 1, path)
        print(f"{label}:", flush=True)
        out[label] = cs.iteration_kernel_ms(torch, mp, kernels, dev, run["tally"],
                                            run["iterations"], cs._queued_ms)
        if label == "classic13":
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
                      "replay": replay, "factor_ms": factor, "kernel_ms": limbs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
