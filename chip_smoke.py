#!/usr/bin/env python3
"""Smoke test of the PyTorch port (sdpb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each fatal on failure:
  1. device: nvidia-smi name and power limit, torch / CUDA / nvcc versions;
  2. build: the CUDA kernels the phases load, from sdpb_tpu_torch/csrc:
     classic K = 2-5 and scaled 5-9 before phase 3; classic K = 7, 8 and
     13, the two-word GEMM at Kg = 5 and 9, the three-word GEMM and
     elementwise kernels at Kg = 7, 8 and 9 and the peak probe in
     background processes beside phases 3-16 (FIRST_LIBS, LATER_LIBS;
     other limb counts build at first use, and `--classic-limbs` below
     builds classic K = 10-12);
  3. exactness: TwoSum and TwoProd exact on the card, in plain torch and
     inside the kernels (through 1 x 1 and 1 x 2 mp_matmuls), float64 and
     float32;
  4. classic kernels against their plain PyTorch versions at the solve's
     shapes (120 blocks of the ising ladder), bit-identical limbs, spot
     checks against mpmath, kernel and plain times, bounds, and each
     kernel's share of its bound (bound ms / kernel ms);
  5. the dim-2 certificate SDP (fixtures/dim2_certificate/sdp.zip) solved
     to optimality through the CLI entry point at 150 bits, classic, in the
     CLI's default run loop (the chunked loop: replays of the iteration's
     CUDA graphs, termination decided on the card): y* must match the
     independently bisected optimum;
  6. the 120-block ladder fixture at 216 bits, classic, for a bounded
     number of iterations in the host loop (as phases 9, 11 and 13's
     solves; a Python call of a kernel wrapper is a launch there): finite
     statistics, positive steps, falling mu,
     seconds per iteration, peak memory, kernel launch counts, the wrapper
     calls by shape and the device ms per iteration of the GEMM, the
     factor and the triangular solve over those shapes (each shape timed
     alone);
  7. the scaled kernels against their plain versions at the scaled solve's
     shapes (limbs and exponents bit-identical), spot checks, times, bounds,
     shares of the bound;
  8. the certificate again in the scaled representation, 150 bits (7
     float32 limbs): optimal, y* matches;
  9. the ladder in the scaled representation, 9 float32 limbs (216 bits of
     mantissa), same settings and iterations as phase 6: finite statistics,
     falling mu, s/iteration, peak memory, launches, calls by shape and
     device ms per iteration as in phase 6, and the digits its objectives
     share with phase 6's classic run;
 10. the wide (two-word) GEMM against its plain version at the ladder's
     shapes, Kg=9 (the 400-bit contract) and Kg=5 (216 bits): limbs and
     exponents bit-identical, spot checks against mpmath, times, bounds,
     shares of the bound; and the wide path's factor (the scaled build at
     Kf=9, on word 0) at the ladder's three factor shapes, the same way;
     the plain versions of every row but the one the kernels' record
     reports on PLAIN_BLOCKS blocks of the batch (plain_blocks: the first,
     the last and two between), on the CPU in background worker processes,
     which make the operands too;
 11. the ladder at --precision 400 in the wide representation (2 words x 9
     float32 limbs) and classic (K=8), WIDE_ITERATIONS + 1 iterations each:
     finite statistics, falling mu, out.txt, the wide GEMM and the scaled
     factor and solve launched, the wide run's calls by shape and device ms
     per iteration as in phase 6, identical step lengths, and the digits
     the objectives share (at least 70: one 216-bit word holds ~65);
 12. the peak probe against its plain version at the 512 x 512 tile,
     float32 and float64, bit for bit at 2048 steps, FMUL/FADD and
     DMUL/DADD in its SASS and no FFMA/DFMA; its time at 65536 steps, the
     measured CUDA-core rates beside the data sheet's;
 13. the per-phase profiler (sdpb_tpu_torch.tools.profile_phases) on the
     ladder, --quant 8, Omega 1e4: classic (K=4), scaled (K32=9) and wide
     (K32=17), each record on one line: every phase's time finite and
     positive, the probe and the representation's kernels launched, and
     the fastest profiled scaled and wide iteration within 25% of the
     fastest steady iteration of that representation's ladder solve, run
     right before and right after the profile (the wide one's solve before
     is phase 11's, with one steady iteration, and phase 11's classic run
     and phase 12 lie between it and the profile: a weaker gate);
 14. the chunked loop on the ladder, classic K=5 and scaled K32=9
     (LADDER_ITERATIONS, chunks of LADDER_CHUNK) and wide 2x9
     (WIDE_ITERATIONS, one chunk), against the host loop's runs of the same
     commands in phases 6, 9 and 11: every
     statistic of every iteration, the reason, the count and the final
     state identical; s/iteration both ways (the chunked one per replay,
     the capture not counted), the graphs' capture and instantiate
     seconds, node counts and memory, peak device memory, a replay's
     device ms of graph A, the eigvalsh calls and graph B; the launches of
     every kernel of the path counted in the replays (the capture's count
     per replay, plus the eager warm-up's).  These runs are the main path
     whose launches the kernels' record reports;
 15. checkpoints, resume and the timing run through the CLI on the ladder:
     classic K=5 and scaled K32=9 solved over two chunks of
     CHECKPOINT_CHUNK with a checkpoint
     at each chunk's start and the final one (two generations kept), the
     final state saved and loaded on the card bit for bit (an element whose
     tail the arithmetic left above half an ulp comes back re-distilled to
     the same value), then resumed from the file (-i) and from memory
     (run_solver(initial=...)): every statistic, the reason, the count and
     the final state identical (within a stated tolerance if an element
     was re-distilled), the path's kernels launched in the resumed run;
     phase 14's wide 2x9 state saved and loaded the same way; a classic
     call with --timingRun auto writes block_timings.json (both
     candidates), the same call again measures nothing.  Bytes, save and
     load seconds, ms/iteration of each candidate and the timing run's
     wall seconds are printed;
 16. the tools that drive the solver: the ladder solved to optimality
     (classic, 216 bits, gap 1e-20) with x, y, X and Y written, then
     approx_objective of the perturbed ladder (fixtures/ising_ladder_120/
     sdp_perturbed.zip: its PMP perturbed by 1e-8) from that solution in
     the scaled (208 bits), wide (400 bits) and classic (216 bits)
     representations, each launching its path's kernels, classic again from
     its solver_state.npz to the same JSON; the perturbed ladder re-solved
     and the quadratic approximation held to it, scaled and wide held to
     classic; outer_limits, its functions made by the port's sdp2functions,
     on the dim-2 certificate to the bisected optimum and on the first
     OUTER_BLOCKS ladder blocks (N = 15, degree 18) against the JAX
     package's committed out.json, with every solve's host, solve and
     capture seconds, run in a process of its own from phase 15 on (its
     mesh search on the host is the script's longest host-bound stretch);
 17. three words (--precision 640: 3 words x 9 float32 limbs) and classic
     K = 13: the three-word kernels (the GEMM at the ladder's two GEMM
     shapes and two edge shapes of its tiling, the elementwise sum and
     product at S's and the X blocks' shapes and a 35-element one, Kg = 9
     and 7; Kg = 8 at the smaller shapes and the edge ones) and the classic K = 13 GEMM, factor and solves
     (phase 4's shapes) against their plain versions, bit for bit, with
     mpmath spot checks, times and bounds (each K = 13 GEMM shape's share of
     its bound on a line of its own); the plain versions as in phase 10
     (the record's rows, Kg = 9, on the card over the whole batch); the certificate to optimality at
     640 bits in three words in the CLI's chunked loop (y* matches); the
     ladder at 640 bits in three words and classic K = 13, WIDE3_ITERATIONS
     + 1 iterations each in the host loop: identical steps, the digits the
     objectives share printed and held to WIDE3_DIGITS; the three-word
     ladder in the chunked loop in chunks of WIDE3_CHUNK against that host
     loop run, identical, with the graphs' sizes and a replay's device ms;
 18. a bootstrap study on the port alone, its host work (conversions,
     generated PMPs, plain versions) in the background pool from the
     start: (a) the port's sdp2input of fixtures/dim2_certificate/pmp.json
     at 400 bits (json) gives every entry of fixtures/dim2_certificate/
     sdp.zip, and the ladder's first two PMP blocks of fixtures/
     ising_ladder_120/pmp.json at 256 bits (bin) its objectives and first
     two blocks' files, byte for byte (control.json's command aside);
     (b) the toy PMP (TOY_PMP) through sdp2input at 512 bits, solved on the
     card through the CLI (classic, 96 bits, thresholds 1e-15), then the
     port's spectrum: one zero within 1e-5 of the independent x0;
     (c) two gen_pmp --solvable problems joined by an .nsv list (STUDY_GEN:
     S blocks of 150 and 57, 25 and 19 points) through sdp2input at 216
     bits, solved classic K = 5 in the chunked loop (16 iterations, two
     chunks of 8): finite statistics, positive steps, falling mu, the
     GEMM, factor and solve launched, s/replay, capture seconds, peak
     memory, the wrapper calls by shape; and the kernels as that run
     calls them at the S shape of 150, the classic GEMM
     [4,15,150]@[4,150,15] at K = 5, the factor [4,150,150] and the lower
     solve [4,150,150]\\[4,150,15] at its factor's Kf = 4 (STUDY_KF),
     held bit for bit to their plain versions (plain_blocks(4): every
     block, on the CPU in the background), with times, bounds and shares
     of the bound.  Each
     conversion's seconds are host seconds of the card's machine;
 19. runs of several processes and the reference's binary checkpoint:
     (a) phase 14's classic chunked ladder run again through the CLI at
     world size 1 with --coordinator (an NCCL group; its all-gathers
     captured in the graphs): every statistic and the final
     state bit for bit phase 14's, the graphs' node counts beside phase
     14's; (b) two ranks sharing the card (gloo) through the CLI's
     --coordinator/--numProcesses/--processId in two spawned processes:
     the CLI's default, the chunked loop, refuses on both; the host loop,
     LADDER_ITERATIONS, the same statistics on both ranks, the path's
     kernels launched on each, the objectives within MULTI_DIGITS of
     phase 6's one process, out.txt written once, and the world-2
     checkpoint resumed at world 1 for 1 iteration; (c) phase 15's
     classic state written as a reference binary checkpoint (row-major
     BigFloats of 216 bits, write_reference_checkpoint) and resumed
     through --initialCheckpointDir for 2 iterations, within
     REFERENCE_DIGITS of phase 15's resume from its npz checkpoint.
Every CLI call writes its checkpoints into a temporary directory (-c), and
the ladder phases but 15 pass --timingRun never.  Each SDP file is
parsed once per limb count, those the phases read ahead in worker
processes while the build runs (_SdpReads).
The last line of stdout is {"ok": true, "device": {...}}; the line before
it is the kernels' JSON record, and the line before that the card's name
and power limit.  Without CUDA, or outside a checkout, the script exits
non-zero and prints no result.

Two diagnostics run instead of the phases when asked for:

    python3 chip_smoke.py --classic-limbs 10 11 12
    python3 chip_smoke.py --digits [640] [400]

--classic-limbs K...: the classic kernels built at each K and held to their
plain versions at phase 4's shapes, as phase 17 holds K = 13 (times,
bounds).  --digits: the ladder at --precision 640 in three words with the
port's 4 refinement passes and the JAX package's rule's 3, and in classic
K = 13 with and without refinement (--factorLimbs 7, the default, and
13); at --precision 400 in two words with 3 and 2 passes, in classic K = 8
with and without refinement and in classic K = 13 at 640 bits; the digits
each run's objectives share with the classic runs, and the chunked loop's
s/replay in three words at 4 and 3 passes and in two words at 3 and 2
(both precisions, or those named).
"""
import argparse
import atexit
import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from fractions import Fraction
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LADDER = ROOT / "fixtures" / "ising_ladder_120" / "sdp.zip"
CERTIFICATE = ROOT / "fixtures" / "dim2_certificate" / "sdp.zip"
# the ladder's --maxIterations in phases 6, 9 and 14 (in phase 14 two
# chunks of LADDER_CHUNK, so that the state crosses a chunk's end) and,
# two words, in phases 11 and 14; phase 17's three words and classic K =
# 13 (two chunks of WIDE3_CHUNK)
LADDER_ITERATIONS, LADDER_CHUNK = 3, 2
WIDE_ITERATIONS = 1
WIDE3_ITERATIONS = 2
# phase 15: the checkpointed solve's --maxIterations (two chunks of
# CHECKPOINT_CHUNK: a save at each one's start) and the resumed solves'
CHECKPOINT_ITERATIONS, RESUME_ITERATIONS, CHECKPOINT_CHUNK = 2, 1, 2
# the blocks of a batch whose plain version a kernel is held to, where the
# plain version runs in a worker process on the CPU (plain_blocks): each
# kernel works block by block, and the plain versions, host-bound on the
# card, cost the script minutes at full batch
PLAIN_BLOCKS = 4
# worker processes for that CPU work (at the lowest priority: they take the
# cores the phases leave idle), started once the first libraries are built
BACKGROUND_WORKERS = 4
# --maxIterations of each ladder solve beside a profile (phase 13): 2 and 1
# steady iterations, before and after it
BRACKET_ITERATIONS = {"scaled": 2, "wide": 1}
# the ladder solve's GEMM shapes: the pairing products and the Q product
GEMM_SHAPES = ((120, 20, 20, 19), (120, 15, 57, 15))
Y_OPT = "-1.685650770619604657526474"   # bisected independently in mpmath
# phase 16: the perturbed ladder (sdp2input at 256 bits of the ladder's
# PMP with its objective and every polynomial coefficient times 1 + 1e-8 r,
# r standard normal, tests/torch_parity.py::perturbed_pmp with seed 9: b, c
# and B move along the polynomial structure; a random perturbation of c at
# the sample points leaves the ladder infeasible, one of B moves its optimum
# by 0.34, both at 1e-12), the PMPs the port's sdp2functions makes
# outer_limits' functions from, and the JAX package's outer_limits out.json
# for the first OUTER_BLOCKS ladder blocks
LADDER_PERTURBED = ROOT / "fixtures" / "ising_ladder_120" / "sdp_perturbed.zip"
LADDER_PMP = ROOT / "fixtures" / "ising_ladder_120" / "pmp.json"
CERTIFICATE_PMP = ROOT / "fixtures" / "dim2_certificate" / "pmp.json"
OUTER_BLOCKS = 16
LADDER_OUTER = ROOT / "fixtures" / "ising_ladder_120" / f"outer_limits_jax_{OUTER_BLOCKS}.json"
# the quadratic approximation against the re-solve: its error is the
# third-order term, ~1.8e3 times the perturbation cubed (1.78e-21 measured),
# plus the solves' distance from their optima (gap 1e-20); the linear error
# (1.06e-16 measured) must exceed the bound 100 times
QUAD_BOUND = 1e-19
# scaled (208 bits) and wide (400 bits) approx_objective against classic
# (216 bits), relative: the objective, its linear term and the objective
# without the quadratic term.  The frozen Schur solve at gap 1e-20 needs
# ~3 log10(1/gap) digits; the scaled product's ~188 bits fall short (its
# quadratic term came out -4.8e-4 for classic's -1.06e-16), the CLI warns
# so, and scaled is held on the parts that involve no solve
APPROX_REL = {"scaled": {"d_objective": 1e-30, "linear": 1e-30},
              "wide": {"objective": 1e-24, "d_objective": 1e-30, "linear": 1e-30}}
OUTER_FLAGS = ("--primalErrorThreshold", "1e-10", "--dualErrorThreshold", "1e-10",
               "--maxIterations", "500", "--verbosity", "0")
# the final gap threshold: the certificate's, and the ladder blocks' (the
# JAX run of LADDER_OUTER: each solve costs ~20 s of host mpmath)
OUTER_GAP = {"certificate": "1e-10", "ladder": "1e-6"}
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
WIDE_KERNEL = ("mp_matmul_wide", "sdpb_tpu_torch/csrc/mp_wide_matmul.cu",
               "sdpb_tpu/ops/pallas_kernels.py:161")
# the three-word kernels: none replaces a Pallas kernel; each stands for
# the JAX package's XLA composite of the same operation
WIDE3_KERNELS = {
    "mp_matmul_wide3": ("sdpb_tpu_torch/csrc/mp_wide3_matmul.cu", "sdpb_tpu/ops/linalg.py:32"),
    "mp_wide3_add": ("sdpb_tpu_torch/csrc/mp_wide3_ops.cu", "sdpb_tpu/ops/mpwide.py:262"),
    "mp_wide3_mul": ("sdpb_tpu_torch/csrc/mp_wide3_ops.cu", "sdpb_tpu/ops/mpwide.py:280"),
}
# the shapes the three-word path gives its elementwise kernels on the
# ladder: S and the X blocks; and an edge shape (35 elements: a ragged
# last block)
WIDE3_EW_SHAPES = ((120, 57, 57), (120, 20, 20), (1, 5, 7))
# the libraries the phases load: before phase 3 those of phases 3-9
# (classic K = 2 the exactness checks, 3 the certificate at 150 bits (Kf =
# 3), 4 and 5 the ladder (Kf = 4) and the profile (K = 4, Kf = 3); scaled 5
# the exactness checks and the profile's factor, 6 and 7 the certificate,
# 8 and 9 the ladder), then in background processes those of phases 10-16
# (classic K = 8, the two-word GEMM at Kg = 5 and 9, the probe) and of
# phase 17 (classic K = 7 and 13, the three-word kernels at Kg = 7, 8, 9).
# A library no list names (a factor healed above its start) builds at its
# first call.
FIRST_LIBS = {False: (2, 3, 4, 5), True: (5, 6, 7, 8, 9)}
LATER_LIBS = ({"classic": (8,), "wide": (5, 9), "probe": True},
              {"classic": (7, 13), "wide3": (7, 8, 9)})
PROBE_KERNEL = ("peak_probe", "sdpb_tpu_torch/csrc/peak_probe.cu",
                "sdpb_tpu/tools/profile_phases.py:97")
# phase 17: --precision 640, three words of 9 float32 limbs (27) against
# classic float64 K = 13; the word sizes of its GEMM checks; the chunk of
# its chunked run (two chunks over WIDE3_ITERATIONS + 1 iterations)
WIDE3_PREC = ("--precision", "640", "--arithmetic", "scaled")
CLASSIC13_PREC = ("--precision", "640")
WIDE3_CHECK_KG = (9, 8, 7)
# the word sizes whose checks run only the smaller of the ladder's GEMM and
# elementwise shapes, and the edge shapes (Kg = 8, --precision 505-576:
# the plain versions at the larger shapes take 10-20 s each)
WIDE3_SMALL_KG = (8,)
WIDE3_CHUNK = 2
# the digits phase 17's three-word and classic K = 13 ladder objectives
# must share (3 iterations): the port's 4 refinement passes of the
# ~188-bit scaled factor (solver/params.py::refinement_passes) gave 179.6,
# the JAX package's 3 gave 156.4; classic K = 13 agrees with itself to 192.8
WIDE3_DIGITS = 175
PROBE_TILE, PROBE_CHECK_STEPS, PROBE_STEPS = (512, 512), 2048, 65536
# phase 13's profiler runs: (label, --scaledLimbs, --reps); the gate reads
# each profile's fastest call, so a profile of one call meets a slow
# stretch of the shared host with nothing to spare it; 3 scaled calls
# (~8 s) once all fell in one such stretch (1.286x the solves)
PROFILES = (("wide", 17, 2), ("classic", 0, 2), ("scaled", 9, 6))
# H100 SXM at 700 W (NVIDIA data sheet): non-fused add/mul per second on
# the CUDA cores (34 and 67 TFLOP/s count a fused multiply-add as two) and
# device memory bytes per second
OPS_PER_S = {False: 16.7e12, True: 33.5e12}
BYTES_PER_S = 3.35e12
# the spin ahead of a batch of calls that _queued_ms times: at least the
# host time of the batch (the wrappers take well under 2 ms a call)
SPIN_S = 0.02
SOLVE_FLAGS = ("--dualityGapThreshold", "1e-12", "--primalErrorThreshold", "1e-12",
               "--dualErrorThreshold", "1e-12", "--initialMatrixScalePrimal", "1e2",
               "--initialMatrixScaleDual", "1e2", "--maxIterations", "250",
               "--verbosity", "0")
LADDER_FLAGS = ("--dualityGapThreshold", "1e-20", "--primalErrorThreshold", "1e-20",
                "--dualErrorThreshold", "1e-20", "--initialMatrixScalePrimal", "1e4",
                "--initialMatrixScaleDual", "1e4")
# the ladder's precision in each representation: 216 bits classic (K=5);
# --precision 208 scaled, 9 float32 limbs, one word (216 bits of mantissa
# with the 8 guard bits); the reference's default 400 bits, two words of 9
LADDER_PREC = {"classic": ("--precision", "216"),
               "scaled": ("--precision", "208", "--arithmetic", "scaled"),
               "wide": ("--precision", "400", "--arithmetic", "scaled")}


# The (file, float64 limbs) the phases read, in the order they first read
# them: the ladder at 216 bits classic (5), 208 scaled (6), 400 wide (9)
# and classic (8), the profile's classic K = 4, then the perturbed ladder
# scaled, wide and classic (phase 16), the ladder at 640 bits in three
# words (14) and classic (13); parsed ahead in worker processes (_SdpReads)
SDP_READS = ((LADDER, 5), (LADDER, 6), (LADDER, 9), (LADDER, 8), (LADDER, 4),
             (LADDER_PERTURBED, 6), (LADDER_PERTURBED, 9), (LADDER_PERTURBED, 5),
             (LADDER, 14), (LADDER, 13))


# phase 18, a bootstrap study on the port alone.  18b: the toy PMP of
# tests/test_spectrum.py (one 1x1 block, base 1/e; maximize -y subject to
# 1 + x^4 + y (x^2 + x^4 / 12) >= 0), whose optimal functional has a
# double root at STUDY_X0, computed independently in mpmath (the JAX
# package's test value; tolerance 1e-5 as there)
TOY_PMP = {
    "objective": ["0", "-1"],
    "normalization": ["1", "0"],
    "PositiveMatrixWithPrefactorArray": [
        {"DampedRational": {
            "constant": "1",
            "base": "0.36787944117144232159552377016146086744581113103177",
            "poles": []},
         "polynomials": [[[["1", "0", "0", "0", "1"],
                           ["0", "0", "1", "0",
                            "0.083333333333333333333333333333333333333333"]]]]}
    ],
}
STUDY_X0, STUDY_X0_TOL = "1.042496785718158120984007", "1e-5"
TOY_FLAGS = ("--precision", "96", "--dualityGapThreshold", "1e-15",
             "--primalErrorThreshold", "1e-15", "--dualErrorThreshold", "1e-15",
             "--initialMatrixScalePrimal", "1e2", "--initialMatrixScaleDual", "1e2",
             "--maxIterations", "250", "--verbosity", "0", "--writeSolution", "x,y")
# 18c: two problems of the port's gen_pmp --solvable joined by an .nsv list
# (file, seed, blocks, dim, dual, degree, poles): 4 blocks of 25 points and
# 3x3 matrices (S 150 x 150) and 4 of 19 points and 2x2 (S 57 x 57), N =
# 15; converted at STUDY_PREC bits and solved classic (K = 5) in the
# chunked loop, STUDY_ITERATIONS + 1 iterations in chunks of STUDY_CHUNK
STUDY_GEN = (("gen_1.json", 1, 4, 3, 15, 24, 8), ("gen_2.json", 2, 4, 2, 15, 18, 8))
STUDY_PREC, STUDY_ITERATIONS, STUDY_CHUNK = "216", 15, 8
# the kernels 18c launches at its largest shapes, held to their plain
# versions (on plain_blocks(STUDY_B), in a background worker): the GEMM
# [4,15,150] @ [4,150,15] at K = 5, the factor of [4,150,150] and the lower
# solve [4,150,150] \ [4,150,15] at the factor's STUDY_KF limbs (the
# solver's initial_factor_limbs at K = 5 under LADDER_FLAGS; the phase
# checks that its run factored at STUDY_KF)
STUDY_K, STUDY_KF, STUDY_B, STUDY_S, STUDY_N = 5, 4, 4, 150, 15
# the fixtures phase 18 reads: the certificate's PMP and zip, the ladder's
# PMP (its first two blocks) and zip
STUDY_FIXTURES = (CERTIFICATE_PMP, CERTIFICATE, LADDER_PMP, LADDER)


class PhaseError(RuntimeError):
    pass


def _read_sdp(path, K):
    """sdp_zip.read_sdp in a worker process of _SdpReads (a task names this
    function: the parent's sdp_zip.read_sdp is then the cache itself)."""
    import numpy as np
    from sdpb_tpu_torch.io import sdp_zip
    return sdp_zip.read_sdp(path, K, np.float64)


def _lowest_priority():
    """Initializer of a low-priority pool's workers: the lowest CPU priority
    (nvcc under it too: the phases' host-bound work keeps its cores), one
    torch thread."""
    import os
    import torch
    os.nice(19)
    torch.set_num_threads(1)


def _pool(workers, low=False):
    """The one way this script runs work beside the phases: a pool of
    `workers` spawned processes (the parent holds a CUDA context, which a
    fork would copy), at the lowest CPU priority with `low`.  A task is a
    function of this module (the workers import it), so a script
    that submits them keeps its work under `if __name__ == "__main__":`.
    shutdown(cancel_futures=True) drops what has not started and waits for
    what has."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_lowest_priority if low else None)


def _captured(fn, *args):
    """A pool task: fn(*args) with what it prints captured, so that the
    phase that waits for it prints it in its place: (text, result)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue(), out


class _SdpReads:
    """sdp_zip.read_sdp with each (file, limbs, dtype) parsed once: nothing
    here changes a problem once read, and parsing the ladder's decimal
    strings takes 8-25 s on one core (longer with more limbs), which every
    CLI call would spend again.  The reads in `ahead` run in a _pool of
    `workers` (none when `ahead` is empty) from the start, so that they
    overlap the build and the first phases; close() stops them."""

    def __init__(self, read, ahead, workers=3):
        import numpy as np
        self.read, self.done = read, {}
        self.pool = _pool(workers) if ahead else None
        self.ahead = {self._key(path, K, np.float64): self.pool.submit(_read_sdp, str(path), K)
                      for path, K in ahead}

    @staticmethod
    def _key(path, K, np_dtype):
        import numpy as np
        return str(Path(path).resolve()), int(K), np.dtype(np_dtype).str

    def __call__(self, path, K, np_dtype=None):
        import numpy as np
        np_dtype = np.float64 if np_dtype is None else np_dtype
        key = self._key(path, K, np_dtype)
        if key not in self.done:
            ahead = self.ahead.pop(key, None)
            self.done[key] = ahead.result() if ahead else self.read(path, K, np_dtype)
        return self.done[key]

    def close(self):
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)


def plain_blocks(B, n=PLAIN_BLOCKS):
    """The blocks of a batch of B that a plain version run in the
    background covers: the first, the last and n - 2 spread evenly
    between them; every block when B <= n."""
    if B <= n:
        return list(range(B))
    return sorted({round(i * (B - 1) / (n - 1)) for i in range(n)})


def _parts(x):
    """The (limbs, exp) pairs of an MP or MPW, for a pipe between processes."""
    return [(w.limbs, w.exp) for w in getattr(x, "words", [x])]


def _value(parts, dev=None):
    """An MP (one pair) or MPW from _parts, on `dev` (default: where it is)."""
    from sdpb_tpu_torch.ops import mpfloat as mp, mpwide
    ws = [mp.MP(l if dev is None else l.to(dev), None if e is None else
                (e if dev is None else e.to(dev))) for l, e in parts]
    return ws[0] if len(ws) == 1 else mpwide.MPW(ws)


def _blocks_of(x, blocks):
    """The blocks `blocks` (the first axis of the value) of an MP or MPW."""
    import torch
    idx = torch.as_tensor(blocks, device=x.device)
    return _value([(l.index_select(1, idx), None if e is None else e.index_select(0, idx))
                   for l, e in _parts(x)])


def _wide_task(op, G, Kg, shape_a, shape_b, seed, blocks):
    """Background task of phases 10 and 17: the operands of one kernel row
    (G words of Kg limbs, made from `seed`) and, unless `blocks` is None,
    the plain version of `op` ("gemm", "add" or "mul") over those blocks of
    the batch with its tally of the word TwoSums left as they were (three
    words).  (a's parts, b's parts, the plain result's parts or None, the
    tally, CPU seconds of the plain version)."""
    import numpy as np
    from sdpb_tpu_torch.ops import kernels, mpwide_kernel as wk
    rng = np.random.default_rng(seed)
    a = _wide_operand(rng, shape_a, Kg, 2.0, G)
    b = _wide_operand(rng, shape_b, Kg, 2.0, G)
    if blocks is None:
        return _parts(a), _parts(b), None, 0, 0.0
    sa, sb = _blocks_of(a, blocks), _blocks_of(b, blocks)
    tally = wk.SkipTally()
    t0 = time.time()
    if op == "gemm" and G == 2:
        out = kernels.mp_matmul_wide_plain(*kernels._canon_wide_pair(sa, sb)[:2])
    elif op == "gemm":
        out = kernels.mp_matmul_wide3_plain(*kernels._canon_wide_pair(sa, sb)[:2], tally)
    else:
        out = getattr(kernels, f"mp_wide3_{op}_plain")(sa, sb, tally)
    return _parts(a), _parts(b), _parts(out), tally.count, time.time() - t0


def _factor_task(Kf, B, n, seed, blocks):
    """Background task of phase 10: a scaled SPD operand [B, n, n] at Kf
    limbs graded over 6 decades (from `seed`) and the plain factor of its
    `blocks`.  (its parts, the factor's parts, CPU seconds)."""
    import numpy as np
    from sdpb_tpu_torch.ops import kernels, mpfloat as mp
    rng = np.random.default_rng(seed)
    A = mp.from_parts(*mp.f64_limbs_to_scaled_parts(
        _limbs(rng, (B, n, n), -(-(24 * Kf) // 53) + 1, spd=True, decades=3.0), Kf), "cpu")
    t0 = time.time()
    L = kernels.mp_cholesky_plain(_blocks_of(A, blocks))
    return _parts(A), _parts(L), time.time() - t0


def _kernel_task(K, blocks):
    """Background task of phase 17: kernel_phase's rows at classic K (its
    operands, from its seed in its order) in plain versions over `blocks`:
    [(parts, CPU seconds)] in the order of its rows (the GEMM shapes, the
    factor at n = 57 and 20, the solve lower and upper with the plain
    factor of n = 57, which the kernel's factor matches bit for bit)."""
    import torch
    from sdpb_tpu_torch.ops import kernels, mpfloat as mp
    gemms, spd, rhs = _kernel_inputs(False, K)[4:]
    sub = lambda x: _blocks_of(mp.MP(torch.as_tensor(x)), blocks)
    out = []

    def timed(fn, *args):
        t0 = time.time()
        r = fn(*args)
        out.append((_parts(r), time.time() - t0))
        return r

    for _, a, b in gemms:
        timed(kernels.mp_matmul_plain, sub(a), sub(b))
    L = timed(kernels.mp_cholesky_plain, sub(spd[57]))
    timed(kernels.mp_cholesky_plain, sub(spd[20]))
    for lower in (True, False):
        T = L if lower else mp.MP(L.limbs.mT.contiguous())
        timed(kernels.mp_solve_triangular_plain, T, sub(rhs), lower)
    return out


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


T_START = time.time()


def phase(name):
    print(f"\n=== {name} === ({time.time() - T_START:.1f} s into the script)", flush=True)


def device_phase(torch):
    phase("1. device")
    from sdpb_tpu_torch.ops.kernels import _nvcc
    from sdpb_tpu_torch.tools.profile_phases import card_line
    smi = card_line()
    print(f"card: {smi}")
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    print(f"device 0: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")
    return smi


def _build_task(libs):
    """A background task: kernels.build of `libs` ({"classic": Ks, "wide":
    Kgs, "wide3": Kgs, "probe": bool}); the names of what it compiled."""
    from sdpb_tpu_torch.ops import kernels
    return kernels.build(list(libs.get("classic", ())), (False,), list(libs.get("wide", ())),
                         probe=bool(libs.get("probe")), wide3_Ks=list(libs.get("wide3", ())))


def build_phase(kernels, background):
    """Phase 2: the libraries phases 3-9 load (FIRST_LIBS), as many objects
    at a time as there are cores; LATER_LIBS as tasks of the `background`
    pool beside the phases.  Returns the seconds and, for each of
    LATER_LIBS, a callable that waits for its build, loads its libraries
    and returns the seconds it waited (a PhaseError if the build failed)."""
    phase("2. build")
    t0 = time.time()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        built = sum(pool.map(lambda rep: kernels.build(FIRST_LIBS[rep], (rep,), (), probe=False,
                                                       wide3_Ks=()), FIRST_LIBS), [])
    for rep, Ks in FIRST_LIBS.items():
        for K in Ks:
            kernels._library(K, rep)
    later = [(libs, background.submit(_captured, _build_task, libs)) for libs in LATER_LIBS]
    print(f"build: {time.time() - t0:.1f} s for classic K={list(FIRST_LIBS[False])} and scaled "
          f"K={list(FIRST_LIBS[True])} (compiled now: {len(built)} libraries); building beside "
          f"the phases: " + "; ".join(", ".join(f"{k} {v}" for k, v in libs.items())
                                       for libs in LATER_LIBS))

    def waiter(libs, build):
        def wait():
            t = time.time()
            try:
                out, _ = build.result()
            except Exception as e:
                raise PhaseError(f"the build of {libs} failed: {e}") from e
            print(out.strip())
            for K in libs.get("classic", ()):
                kernels._library(K, False)
            for rep in (kernels.WIDE, kernels.WIDE3):
                for K in libs.get(rep, ()):
                    kernels._library(K, rep)
            if libs.get("probe"):
                kernels._probe_library()
            return time.time() - t
        return wait

    return time.time() - t0, [waiter(libs, build) for libs, build in later]


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


def _queued_ms(torch, fn, reps=5, calls=10):
    """ms a call on the card: the median over `reps` samples after one
    warm-up, each CUDA events around `calls` calls back to back, queued
    while the card spins for SPIN_S (torch.cuda._sleep).  So the events
    time the kernels, not their wrappers' host time, which `_time_ms`
    also reads (0.1-0.2 ms a call at the ladder's GEMM shapes).  For
    comparing two checkouts' kernels (tools/kernel_times.py); the phases
    here keep `_time_ms`."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(SPIN_S * 2e9))
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1) / calls)
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
    kernels, counted from mp.cuh / mp_scaled.cuh (TwoSum 6; an exact
    product and its error 2, a product and a fused multiply-add: the least
    work, where the kernels run Dekker's split and 9-operation error; a
    scaled add aligns both operands and normalizes, 3 multiplies per limb
    each; a scaled product prescales 2K limbs and puts each of its K^2+1
    terms back with 2 multiplies; integer exponent work is not counted)."""
    from sdpb_tpu_torch.ops.mpfloat import newton_steps
    add = _renorm_ops(K, 2 * K)
    mul = (K * (K + 1) // 2 + K * (K - 1) // 2 + (2 * K - 3)
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


def _sweep_ops(m, K, chain):
    """Float operations of mpw::sweeps (mp_wide.cuh) over m rows."""
    return 6 * sum(m - 1 - k for k in range(min(K, m - 1))) + \
        ((m - 1 - K) if chain and m - 1 > K else 0)


def word_op_counts(K):
    """Float operations of the word ops of mp_wide.cuh at Kg = K: (add_st,
    mul_st, add_full, mul_full), and of mp_wide3.cuh's mul_full3, counted
    from the source: TwoSum 6, quick TwoSum 3, an exact product and its
    error 2 (a product and a fused multiply-add, the least work; the kernel
    runs Dekker's split and 9-operation error), a staged power-of-two
    scaling 3 multiplies (2 for the limb lifts); the integer exponent work
    and the exponent-field lifts are not counted."""
    finish = lambda m: _sweep_ops(m, K, True) + 3 * (2 * K - 1) + 3 * K
    extract = 12 * (K - 1) + 3 * K
    products = 2 * K * K
    nf, nm = 2 * K * K, K * K + K - 1
    add_st = 6 * K + finish(2 * K + 2)
    mul_st = 2 * K + products + 2 * nm + finish(nm + 2)
    add_full = 12 * K + _sweep_ops(2 * K, K, False) + extract + finish(4 * K + 2)
    mul_full = 4 * K + products + 6 * nf + _sweep_ops(nf, K, False) + extract + \
        finish(2 * nf + 2)
    mul_full3 = 4 * K + products + 9 * nf + _sweep_ops(nf, K, False) + extract + \
        _sweep_ops(2 * nf + 2, K, False) + extract + finish(3 * nf + 4)
    return add_st, mul_st, add_full, mul_full, mul_full3


def wide_op_counts(K):
    """Float operations of one wide fused multiply-add (mpw::fma_acc) and of
    one word TwoSum (mpw::add_full) at Kg = K (word_op_counts)."""
    add_st, mul_st, add_full, mul_full, _ = word_op_counts(K)
    return mul_full + 2 * mul_st + 4 * add_st + add_full, add_full


def wide3_op_counts(K):
    """Float operations of a three-word product and sum at Kg = K
    (mp_wide3.cuh: the top word product exact in three words, 2 exact in
    two and 3 truncated word products, 32 word TwoSums, 7 word adds; 20 word
    TwoSums, 3 word adds), and of one word TwoSum, which the kernels skip
    for words more than 24 K digits apart."""
    add_st, mul_st, add_full, mul_full, mul_full3 = word_op_counts(K)
    return (mul_full3 + 2 * mul_full + 3 * mul_st + 32 * add_full + 7 * add_st,
            20 * add_full + 3 * add_st, add_full)


def kernel_bound(name, shape, K, scaled, skipped=0):
    """(bound_ms, bound_by): the larger of the float operations over the
    card's rate and the bytes (inputs read once, outputs written once) over
    its memory rate, for one call at `shape` (the wide GEMMs: K = Kg, two
    or three float32 words per element; the three-word kernels' word
    TwoSums less `skipped`, those of the work the result needs that this
    run's data left as they were, kernels.mp_*wide3*_plain's tally)."""
    if name in ("mp_wide3_add", "mp_wide3_mul"):
        wmul, wadd, add_full = wide3_op_counts(K)
        n = math.prod(shape)
        ops = n * (wadd if name == "mp_wide3_add" else wmul) - skipped * add_full
        t_ops = ops / OPS_PER_S[True]
        t_bytes = 3 * n * 3 * (4 * K + 4) / BYTES_PER_S
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    if name == "mp_matmul_wide3":
        # the Kd products and Kd - 1 sums the product needs: the kernel's
        # products and sums of the zero padding, and its first add into
        # the zero accumulator, are not counted
        wmul, wadd, add_full = wide3_op_counts(K)
        B, M, Kd, N = shape
        ops = B * M * N * (Kd * wmul + (Kd - 1) * wadd) - skipped * add_full
        t_ops = ops / OPS_PER_S[True]
        t_bytes = B * (M * Kd + Kd * N + M * N) * 3 * (4 * K + 4) / BYTES_PER_S
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    if name == "mp_matmul_wide":
        fma, add_full = wide_op_counts(K)
        B, M, Kd, N = shape
        t_ops = B * M * N * (Kd * fma + add_full) / OPS_PER_S[True]
        t_bytes = B * (M * Kd + Kd * N + M * N) * 2 * (4 * K + 4) / BYTES_PER_S
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    add, mul, rsqrt, recip = mp_op_counts(K, scaled)
    per_elem = K * (4 if scaled else 8) + (4 if scaled else 0)
    if name == "mp_matmul":
        # the Kd products and Kd - 1 sums the product needs, as for the
        # wide GEMMs: the kernel's work on the zero padding is not counted
        B, M, Kd, N = shape
        ops = B * M * N * (Kd * mul + (Kd - 1) * add)
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


def _kernel_inputs(scaled, K=None):
    """kernel_phase's operands as float64 limb stacks, from its seed in its
    order: (Kg, Kf, decades, mantissa bits, [(GEMM shape, a, b)], the SPD
    blocks {57: A, 20: A} of the factor, the right-hand side of the solve
    [120, 57, 15])."""
    import numpy as np
    rng = np.random.default_rng(7 if scaled else 4)
    if scaled:
        # the scaled ladder: 9 limbs (216 bits); factor 8 limbs as
        # initial_factor_limbs gives at Omega=1e4, gap 1e-20, 24-bit limbs
        Kg, Kf, decades, mant = 9, 8, 3.0, 24
    elif K:
        Kg, Kf, decades, mant = K, K, 0.0, 53
    else:
        Kg, Kf, decades, mant = 5, 4, 0.0, 53
    K64 = -(-(24 * Kg) // 53) + 1 if scaled else Kg
    KF64 = -(-(24 * Kf) // 53) + 1 if scaled else Kf
    gemms = [((B, M, Kd, N), _limbs(rng, (B, M, Kd), K64, decades=decades),
              _limbs(rng, (B, Kd, N), K64, decades=decades)) for B, M, Kd, N in GEMM_SHAPES]
    spd = {n: _limbs(rng, (120, n, n), KF64, spd=True, decades=decades) for n in (57, 20)}
    return Kg, Kf, decades, mant, gemms, spd, _limbs(rng, (120, 57, 15), KF64, decades=decades)


def kernel_phase(torch, mp, kernels, dev, scaled, K=None, background=None):
    """Each kernel of one representation against its plain version at the
    ladder solve's shapes: bit-identical limbs (and exponents), a spot
    check against mpmath, kernel and plain times, the bound.  K: classic
    limbs of every kernel, the factor's too (phase 17: K = 13), in place
    of phase 4's K = 5 and Kf = 4.  `background`: a future of _kernel_task
    (K alone), whose plain versions over plain_blocks(120) the kernels'
    same blocks are held to, in place of the plain versions on the card."""
    import mpmath
    import numpy as np
    if scaled:
        phase("7. scaled kernels against plain versions (ladder shapes)")
    elif K:
        print(f"classic kernels at K={K} against plain versions (phase 4's shapes"
              + (f"; the plain versions on the CPU over blocks {plain_blocks(120)})"
                 if background else ")"))
    else:
        phase("4. classic kernels against plain versions (ladder shapes)")
    Kg, Kf, decades, mant, gemms, spd, rhs = _kernel_inputs(scaled, K)
    plains = iter(background.result()) if background else None

    def C(x, K):
        if scaled:
            return mp.from_parts(*mp.f64_limbs_to_scaled_parts(x, K), dev)
        return mp.MP(torch.as_tensor(x[:K], device=dev))

    def host(o):
        limbs = o.limbs.cpu().numpy()
        exp = o.exp.cpu().numpy() if scaled else np.zeros(limbs.shape[1:], np.int64)
        return lambda idx: _mpf(limbs[(slice(None),) + idx], exp[idx])

    def plain(fn, out_k):
        """(the kernel's output, the plain result, ms, label suffix): the
        plain version on the card, or the blocks the background task ran
        (the kernel's output cut to them)."""
        if plains is None:
            op, pms = _timed_once(torch, fn)
            return out_k, op, pms, ""
        parts, sec = next(plains)
        blocks = plain_blocks(out_k.shape[0])
        return (_blocks_of(out_k, blocks), _value(parts, dev), 1e3 * sec,
                f" (plain: CPU, {len(blocks)} of {out_k.shape[0]} blocks)")

    rows = []

    def compare(name, shape, out_k, out_p, spot, K):
        err = _err(out_k, out_p)
        check(err == 0.0, f"{name} {shape}: kernel differs from plain (max {err})")
        with mpmath.workprec(mant * K + 80):
            worst = max(spot(i) for i in range(20))
        check(worst < mpmath.mpf(2) ** -(mant * K - 10),
              f"{name} {shape}: spot check vs mpmath {worst}")
        return err, float(worst)

    for (B, M, Kd, N), a, b in gemms:
        A, Bm = C(a, Kg), C(b, Kg)
        ok = kernels.mp_matmul(A, Bm)
        kk, op, pms, note = plain(lambda: kernels.mp_matmul_plain(A, Bm), ok)
        ha, hb, ho = host(A), host(Bm), host(ok)

        def spot(i, B=B, M=M, N=N, Kd=Kd, ha=ha, hb=hb, ho=ho):
            r = np.random.default_rng(i)
            bi, mi, ni = r.integers(B), r.integers(M), r.integers(N)
            terms = [ha((bi, mi, t)) * hb((bi, t, ni)) for t in range(Kd)]
            return abs(ho((bi, mi, ni)) - mpmath.fsum(terms)) / \
                mpmath.fsum(abs(t) for t in terms)
        err, worst = compare("mp_matmul", (B, M, Kd, N), kk, op, spot, Kg)
        ms = _time_ms(torch, lambda: kernels.mp_matmul(A, Bm))
        bound, by = kernel_bound("mp_matmul", (B, M, Kd, N), Kg, scaled)
        rows.append(("mp_matmul", f"[{B},{M},{Kd}]@[{B},{Kd},{N}] K={Kg}{note}",
                     err, worst, ms, pms, bound, by))

    chol = {}
    for n in (57, 20):
        B = 120
        A = C(spd[n], Kf)
        ok = kernels.mp_cholesky(A)
        kk, op, pms, note = plain(lambda: kernels.mp_cholesky_plain(A), ok)
        chol[n] = ok
        ha, hL = host(A), host(ok)

        def spot(i, n=n, B=B, ha=ha, hL=hL):
            r = np.random.default_rng(100 + i)
            bi, ii = r.integers(B), r.integers(n)
            jj = r.integers(ii + 1)
            rec = mpmath.fsum(hL((bi, ii, t)) * hL((bi, jj, t)) for t in range(jj + 1))
            return abs(rec - ha((bi, ii, jj))) / \
                mpmath.sqrt(abs(ha((bi, ii, ii)) * ha((bi, jj, jj))))
        err, worst = compare("mp_cholesky", (B, n, n), kk, op, spot, Kf)
        ms = _time_ms(torch, lambda: kernels.mp_cholesky(A))
        bound, by = kernel_bound("mp_cholesky", (B, n), Kf, scaled)
        rows.append(("mp_cholesky", f"[{B},{n},{n}] K={Kf}{note}", err, worst, ms, pms,
                     bound, by))

    L = chol[57]
    B, n, m = 120, 57, 15
    Bm = C(rhs, Kf)
    hL, hb = host(L), host(Bm)
    for lower in (True, False):
        T = L if lower else mp.MP(L.limbs.mT.contiguous(),
                                  None if L.exp is None else L.exp.mT.contiguous())
        ok = kernels.mp_solve_triangular(T, Bm, lower)
        kk, op, pms, note = plain(lambda: kernels.mp_solve_triangular_plain(T, Bm, lower), ok)
        hX = host(ok)

        def spot(i, lower=lower, hX=hX):
            r = np.random.default_rng(200 + i)
            bi, ii, c = r.integers(B), r.integers(n), r.integers(m)
            ts = range(ii + 1) if lower else range(ii, n)
            terms = [(hL((bi, ii, t)) if lower else hL((bi, t, ii))) * hX((bi, t, c))
                     for t in ts]
            return abs(mpmath.fsum(terms) - hb((bi, ii, c))) / \
                (mpmath.fsum(abs(t) for t in terms) + abs(hb((bi, ii, c))))
        err, worst = compare("mp_solve_triangular", (B, n, m, lower), kk, op, spot, Kf)
        ms = _time_ms(torch, lambda: kernels.mp_solve_triangular(T, Bm, lower))
        bound, by = kernel_bound("mp_solve_triangular", (B, n, m), Kf, scaled)
        rows.append(("mp_solve_triangular",
                     f"[{B},{n},{n}]\\[{B},{n},{m}] {'lower' if lower else 'upper'} K={Kf}{note}",
                     err, worst, ms, pms, bound, by))

    _print_rows(rows)
    return rows


def _print_rows(rows):
    """The kernel rows of phases 4, 7 and 10, each with its share of its
    bound (bound ms / kernel ms)."""
    print(f"{'kernel':22s} {'shape':40s} {'max|k-p|':>9s} {'vs mpmath':>10s} "
          f"{'kernel ms':>10s} {'plain ms':>10s} {'bound ms':>10s} {'of bound':>8s} "
          f"bound by")
    for name, shape, err, worst, ms, pms, bound, by in rows:
        print(f"{name:22s} {shape:40s} {err:9.1e} {worst:10.2e} {ms:10.3f} "
              f"{pms:10.1f} {bound:10.4f} {bound / ms:8.1%} {by}")


def _wide_operand(rng, shape, Kg, decades, G=2):
    """A random MPW of G words on the CPU: float64 limb stacks with fresh
    bits in every limb (past the 24 G Kg bits the words hold), staged
    exactly."""
    from sdpb_tpu_torch.ops import mpwide
    K64 = -(-(24 * G * Kg) // 53) + 2
    return mpwide.wide_parts_to_mp(
        mpwide.f64_limbs_to_wide_parts(_limbs(rng, shape, K64, decades=decades), G * Kg),
        "cpu")


# phase 10's rows: the two-word GEMM at the ladder's GEMM shapes, Kg = 9 and
# 5 (WIDE_RECORD_ROW, Kg = 9 [120,15,57]@[120,57,15], the one the kernels'
# record reports, held to its plain version on the card over the whole batch),
# then the wide path's factor at Kf = 9 (the scaled build on word 0) at S's,
# the X blocks' and Q's shapes; each row's operands made from its own seed
WIDE_GEMM_ROWS = tuple((Kg, shape) for Kg in (9, 5) for shape in GEMM_SHAPES)
WIDE_RECORD_ROW = (9, GEMM_SHAPES[-1])
WIDE_FACTOR_ROWS = ((120, 57), (120, 20), (1, 15))


def wide_tasks(background):
    """Phase 10's background tasks, in the order of its rows."""
    gemms = [background.submit(_wide_task, "gemm", 2, Kg, (B, M, Kd), (B, Kd, N),
                               10_000 + 100 * Kg + i,
                               None if (Kg, shape) == WIDE_RECORD_ROW else plain_blocks(B))
             for i, (Kg, shape) in enumerate(WIDE_GEMM_ROWS) for B, M, Kd, N in (shape,)]
    factors = [background.submit(_factor_task, 9, B, n, 10_500 + n, plain_blocks(B))
               for B, n in WIDE_FACTOR_ROWS]
    return gemms, factors


def wide_kernel_phase(torch, kernels, dev, tasks):
    """Phase 10: the wide GEMM against its plain version at the ladder's
    shapes, Kg = 9 and 5: bit-identical words, mpmath spot checks within
    2^-(48 Kg - 26), kernel ms (median of 5), plain ms (once), bound; then
    the scaled factor at Kf = 9, as the wide path calls it, the same way
    (L L^T against A within phase 7's Kf = 8 bound, 2^-182).  `tasks`:
    wide_tasks'; the plain versions of all rows but the record's ran there
    on plain_blocks of the batch."""
    phase("10. wide GEMM and the wide path's factor against their plain versions "
          "(ladder shapes)")
    import mpmath
    import numpy as np
    gemms, factors = tasks
    rows = []
    for (Kg, (B, M, Kd, N)), task in zip(WIDE_GEMM_ROWS, gemms):
        pa, pb, pp, _, sec = task.result()
        A, Bm = _value(pa, dev), _value(pb, dev)
        ok = kernels.mp_matmul_wide(A, Bm)
        if pp is None:
            op, pms = _timed_once(torch, lambda: kernels.mp_matmul_wide_plain(A, Bm))
            kk, note = ok, ""
        else:
            blocks = plain_blocks(B)
            kk, op, pms = _blocks_of(ok, blocks), _value(pp, dev), 1e3 * sec
            note = f" (plain: CPU, {len(blocks)} of {B} blocks)"
        err = max(_err(k, p) for k, p in zip(kk.words, op.words))
        check(err == 0.0, f"mp_matmul_wide {(B, M, Kd, N)} Kg={Kg}: kernel differs "
                          f"from plain (max {err})")
        parts = [[(l.numpy(), e.numpy()) for l, e in pa], [(l.numpy(), e.numpy()) for l, e in pb],
                 [(w.limbs.cpu().numpy(), w.exp.cpu().numpy()) for w in ok.words]]

        def val(p, idx):
            return mpmath.fsum(_mpf(l[(slice(None),) + idx], e[idx]) for l, e in p)

        with mpmath.workprec(48 * Kg + 120):
            worst = mpmath.mpf(0)
            for i in range(20):
                r = np.random.default_rng(300 + i)
                bi, mi, ni = r.integers(B), r.integers(M), r.integers(N)
                terms = [val(parts[0], (bi, mi, t)) * val(parts[1], (bi, t, ni))
                         for t in range(Kd)]
                worst = max(worst, abs(val(parts[2], (bi, mi, ni)) - mpmath.fsum(terms))
                            / mpmath.fsum(abs(t) for t in terms))
            check(worst < mpmath.mpf(2) ** -(48 * Kg - 26),
                  f"mp_matmul_wide Kg={Kg}: spot check vs mpmath {worst}")
        ms = _time_ms(torch, lambda: kernels.mp_matmul_wide(A, Bm))
        bound, by = kernel_bound("mp_matmul_wide", (B, M, Kd, N), Kg, True)
        rows.append(("mp_matmul_wide", f"[{B},{M},{Kd}]@[{B},{Kd},{N}] Kg={Kg}{note}",
                     err, float(worst), ms, pms, bound, by))
    # the wide path factors word 0 with the scaled build at Kf = 9: S and
    # the X/Y blocks over 120 blocks, Q alone
    Kf = 9
    for (B, n), task in zip(WIDE_FACTOR_ROWS, factors):
        pa, pl, sec = task.result()
        A = _value(pa, dev)
        ok = kernels.mp_cholesky(A)
        blocks = plain_blocks(B)
        err = _err(_blocks_of(ok, blocks), _value(pl, dev))
        check(err == 0.0, f"mp_cholesky [{B},{n},{n}] Kf={Kf}: kernel differs from plain "
                          f"(max {err})")
        limbs, exp = ok.limbs.cpu().numpy(), ok.exp.cpu().numpy()
        alimbs, aexp = pa[0][0].numpy(), pa[0][1].numpy()
        with mpmath.workprec(24 * Kf + 80):
            worst = mpmath.mpf(0)
            for i in range(20):
                r = np.random.default_rng(400 + i)
                bi, ii = r.integers(B), r.integers(n)
                jj = r.integers(ii + 1)
                at = lambda x, e, idx: _mpf(x[(slice(None),) + idx], e[idx])
                rec = mpmath.fsum(at(limbs, exp, (bi, ii, t)) * at(limbs, exp, (bi, jj, t))
                                  for t in range(jj + 1))
                worst = max(worst, abs(rec - at(alimbs, aexp, (bi, ii, jj))) / mpmath.sqrt(
                    abs(at(alimbs, aexp, (bi, ii, ii)) * at(alimbs, aexp, (bi, jj, jj)))))
            # held to the Kf = 8 bound of phase 7: rsqrt's Newton chain
            # stalls near 2^-188 for Kf >= 8 in the JAX package's
            # arithmetic and in the port's, since the scaled product drops
            # a limb that lies ~190 bits below the first
            # (tests/test_torch_kernels.py::test_scaled_rsqrt_and_factor_
            # stall_near_2_pow_minus_188)
            check(worst < mpmath.mpf(2) ** -(24 * 8 - 10),
                  f"mp_cholesky Kf={Kf}: spot check vs mpmath {worst}")
        ms = _time_ms(torch, lambda: kernels.mp_cholesky(A))
        bound, by = kernel_bound("mp_cholesky", (B, n), Kf, True)
        rows.append(("mp_cholesky", f"[{B},{n},{n}] K={Kf} (wide path; plain: CPU, "
                     f"{len(blocks)} of {B} blocks)", err, float(worst), ms, 1e3 * sec,
                     bound, by))
    _print_rows(rows)
    return rows


def _y_value(res):
    """y* of the one-dimensional dual as an mpmath value."""
    import numpy as np
    from sdpb_tpu_torch.ops.mpfloat import host_f64_limbs
    return _mpf(np.asarray(host_f64_limbs(res.state.y))[:, 0])


def certificate_phase(torch, kernels, cli, dev, scaled, prec="150", path=None):
    """The certificate to optimality through the CLI (its default, chunked
    loop) at `prec` bits, classic or scaled: optimal, y* within 1e-10 of
    the bisected optimum, the kernels of `path` (default: the
    representation's three) launched."""
    if prec == "150":
        phase("8. dim-2 certificate solve, scaled (150 bits, 7 float32 limbs)"
              if scaled else "5. dim-2 certificate solve (150 bits)")
    import mpmath
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out"
        kernels.reset_launches()
        t0 = time.time()
        res = cli.run(["-s", str(CERTIFICATE), "-o", str(out), "-c", str(Path(tmp) / "ck"),
                       "--device", str(dev), "--precision", prec, *SOLVE_FLAGS,
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
    path = path or [kernels.counter(n, scaled) for n in kernels.KERNEL_NAMES]
    check(all(launches[n] > 0 for n in path), f"a kernel did not run: {launches}")
    return {"iterations": res.iterations, "seconds": dt, "dy": float(dy),
            "graphs": res.graphs}


@contextlib.contextmanager
def _shape_tally(kernels):
    """Count the calls of the GEMM, factor and triangular-solve wrappers and
    of the three-word sum and product by (wrapper, representation, limbs,
    shape of a, shape of b, lower) while the block runs (the solver reaches
    them as attributes of the kernels module; the factor has no b: its
    shape of b is (); the representation of a wide operand is "wide" for
    two words, "wide3" for three, its limbs the word's); the wrappers' own
    launch counters are untouched."""
    tally = {}
    saved = {n: getattr(kernels, n) for n in ("mp_matmul", "mp_matmul_wide", "mp_cholesky",
                                              "mp_solve_triangular", "mp_wide3_add",
                                              "mp_wide3_mul")}

    def shim(name, fn):
        def call(a, *rest, **kw):
            wide = hasattr(a, "Kg")
            lower, bsh = None, ()
            if name != "mp_cholesky":
                bsh = tuple(rest[0].shape)
            if name == "mp_solve_triangular":
                lower = bool(kw.get("lower", rest[1] if len(rest) > 1 else True))
            rep = ("wide3" if a.G == 3 else "wide") if wide else \
                ("scaled" if a.scaled else "classic")
            key = (name, rep, a.Kg if wide else a.K, tuple(a.shape), bsh, lower)
            tally[key] = tally.get(key, 0) + 1
            return fn(a, *rest, **kw)
        return call

    for n, fn in saved.items():
        setattr(kernels, n, shim(n, fn))
    try:
        yield tally
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)


def _call_label(key):
    name, rep, K, ash, bsh, lower = key
    if name == "mp_cholesky":
        return f"{name} {rep} K={K} {list(ash)}"
    side = "" if lower is None else (" lower" if lower else " upper")
    op = {"mp_wide3_add": "+", "mp_wide3_mul": "*"}.get(name, "@" if lower is None else "\\")
    return f"{name} {rep} K={K} {list(ash)}{op}{list(bsh)}{side}"


def iteration_kernel_ms(torch, mp, kernels, dev, tally, iterations, time_ms=_time_ms):
    """Device ms per iteration of each kernel the tally counted: every
    tallied shape timed on operands from fixed seeds by `time_ms`, times
    its calls per iteration, summed per launch counter.  Prints one line
    per shape."""
    import numpy as np
    from sdpb_tpu_torch.ops import mpwide
    totals = {}
    for key, count in sorted(tally.items(), key=lambda kv: _call_label(kv[0])):
        name, rep, K, ash, bsh, lower = key
        rng = np.random.default_rng(sum(ash) + 7 * sum(bsh) + K)
        if rep in ("wide", "wide3"):
            a, b = (mpwide.MPW(mp.MP(w.limbs.to(dev), w.exp.to(dev))
                               for w in _wide_operand(rng, sh, K, 2.0, G=2 + (rep == "wide3"))
                               .words)
                    for sh in (ash, bsh))
            counter = name + "3" if name == "mp_matmul_wide" and rep == "wide3" else name
        else:
            K64 = -(-(24 * K) // 53) + 1 if rep == "scaled" else K
            # the factor's operand symmetric positive definite (G G^T + n I)
            ha = _limbs(rng, ash, K64, spd=name == "mp_cholesky")
            hb = _limbs(rng, bsh, K64) if bsh else None
            if lower is not None:   # a diagonal above its rows' entries
                idx = np.arange(ash[-1])
                ha[0][..., idx, idx] += 2 * ash[-1]
            if rep == "scaled":
                a, b = (None if x is None else
                        mp.from_parts(*mp.f64_limbs_to_scaled_parts(x, K), dev) for x in (ha, hb))
            else:
                a, b = (None if x is None else mp.MP(torch.as_tensor(x, device=dev))
                        for x in (ha, hb))
            counter = kernels.counter(name, rep == "scaled")
        fn = getattr(kernels, name)
        args = (a,) if b is None else (a, b) if lower is None else (a, b, lower)
        ms = time_ms(torch, lambda: fn(*args))
        per_it = count / iterations
        totals[counter] = totals.get(counter, 0.0) + per_it * ms
        print(f"  {_call_label(key)}: {per_it:g} per iteration x {ms:.4f} ms")
    print("device ms per iteration: " + ", ".join(f"{k} {v:.2f}" for k, v in totals.items()))
    return totals


def _ladder_run(torch, kernels, cli, dev, prec, iterations, check_path, chunk_iterations=1,
                sdp=LADDER):
    """One CLI run of the ladder (or of `sdp`) for iterations
    + 1 iterations, in the host loop (chunk_iterations=1) or the chunked
    loop (0: chunks of 8; n: chunks of n): finite statistics, positive
    steps, falling mu, out.txt written, and every kernel of `check_path`
    launched in this run (counts set to 0 just before it, read just
    after).  The wrapper calls by shape mean launches in the host loop
    only (a capture calls each wrapper once)."""
    from sdpb_tpu_torch.solver.solve import host_mpf
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        with _shape_tally(kernels) as tally:
            res = cli.run(["-s", str(sdp), "-o", str(Path(tmp) / "out"),
                           "-c", str(Path(tmp) / "ck"), "--timingRun", "never",
                           "--device", str(dev), *prec, *LADDER_FLAGS,
                           "--maxIterations", str(iterations)],
                          chunk_iterations=chunk_iterations)
        wall = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        check((Path(tmp) / "out" / "out.txt").exists(), "out.txt not written")
    hist = res.history
    check(len(hist) >= iterations, f"only {len(hist)} iterations ran")
    for i, st in enumerate(hist):
        for name in st._fields:
            v = getattr(st, name)
            for w in (v if isinstance(v, list) else [v]):
                w = w[0] if isinstance(w, tuple) else w
                check(np.all(np.isfinite(np.asarray(w, dtype=float))),
                      f"iteration {i + 1}: {name} not finite")
        check(st.primal_step > 0 and st.dual_step > 0, f"iteration {i + 1}: step <= 0")
    mus = [float(host_mpf(st.mu)) for st in hist]
    check(all(b < a for a, b in zip(mus, mus[1:])), f"mu does not fall: {mus}")
    its = res.iteration_seconds
    loop = "host loop"
    if chunk_iterations == 1:
        steady = statistics.median(its[1:]) if len(its) > 1 else its[0]
        each = its
    else:
        # a replay runs a whole iteration, executed or not
        each = [dt / n for _, n, dt in res.chunks]
        steady = statistics.median(each)
        loop = f"chunked loop, chunks {res.chunks}, s/replay"
    print(f"{' '.join(prec)} ({loop}): {res.terminate_reason}; {len(hist)} iterations "
          f"in {sum(its):.1f} s (wall {wall:.1f} s incl. reading the zip if not read "
          f"before); first {its[0]:.2f} s, steady median {steady:.3f} s/iteration (each: "
          f"{' '.join(f'{t:.3f}' for t in each)}); peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}")
    print(f"mu: {' '.join(f'{m:.3e}' for m in mus)}")
    if chunk_iterations == 1:
        print(f"wrapper calls by shape over the {len(hist)} iterations: "
              + "; ".join(f"{_call_label(k)}: {v}" for k, v in
                          sorted(tally.items(), key=lambda kv: _call_label(kv[0]))))
    check(all(launches[n] > 0 for n in check_path), f"a kernel did not run: {launches}")
    return {"launches": launches, "s_per_it": steady, "steady_its": list(its[1:]),
            "peak_bytes": peak, "history": hist, "iterations": len(hist), "tally": tally,
            "result": res, "wall": wall}


def _shared_digits(mine, ref):
    """(least significant digits the objectives share over the iterations,
    iterations with identical step lengths)."""
    from sdpb_tpu_torch.solver.solve import host_mpf
    import mpmath
    digits, same_steps = math.inf, 0
    with mpmath.workprec(600):
        for a_st, b_st in zip(mine["history"], ref["history"]):
            same_steps += (a_st.primal_step, a_st.dual_step) == \
                (b_st.primal_step, b_st.dual_step)
            for f in ("primal_objective", "dual_objective"):
                a, b = host_mpf(getattr(a_st, f)), host_mpf(getattr(b_st, f))
                if a != b:
                    digits = min(digits, float(-mpmath.log10(abs(a - b) / abs(b))))
    return digits, same_steps


def kernel_path(kernels, label):
    """The launch counters of the kernels a ladder run in representation
    `label` must launch (the wide path factors and solves word 0 with the
    scaled kernels)."""
    if label == "wide":
        return ["mp_matmul_wide", "mp_cholesky_scaled", "mp_solve_triangular_scaled"]
    if label == "wide3":
        return ["mp_matmul_wide3", "mp_wide3_add", "mp_wide3_mul", "mp_cholesky_scaled",
                "mp_solve_triangular_scaled"]
    return [kernels.counter(n, label == "scaled") for n in kernels.KERNEL_NAMES]


def ladder_phase(torch, kernels, cli, dev, scaled, classic=None):
    from sdpb_tpu_torch.ops import mpfloat as mp
    label = "scaled" if scaled else "classic"
    if scaled:
        phase(f"9. ising ladder, scaled, 9 float32 limbs (216 bits), "
              f"{LADDER_ITERATIONS} iterations")
    else:
        phase(f"6. ising ladder, 120 blocks, 216 bits, {LADDER_ITERATIONS} iterations")
    out = _ladder_run(torch, kernels, cli, dev, list(LADDER_PREC[label]), LADDER_ITERATIONS,
                      kernel_path(kernels, label))
    out["kernel_ms"] = iteration_kernel_ms(torch, mp, kernels, dev, out["tally"],
                                           out["iterations"])
    if classic is not None:
        digits, same_steps = _shared_digits(out, classic)
        print(f"objectives agree with the classic run to {digits:.1f} significant "
              f"digits over {out['iterations']} iterations, step lengths identical in "
              f"{same_steps}; s/iteration scaled {out['s_per_it']:.3f} vs classic "
              f"{classic['s_per_it']:.3f}")
        check(digits >= 15, f"scaled objectives share only {digits:.1f} digits")
        out["digits"] = digits
    return out


def wide_ladder_phase(torch, kernels, cli, dev):
    """Phase 11: the ladder at the reference's default --precision 400 in
    the wide representation (17 float32 limbs -> 2 words x 9) and classic
    (K=8): identical steps, at least 70 shared digits."""
    phase(f"11. ising ladder at --precision 400: wide (2 words x 9 float32 limbs) "
          f"and classic (K=8), {WIDE_ITERATIONS + 1} iterations each")
    from sdpb_tpu_torch.ops import mpfloat as mp
    wide = _ladder_run(torch, kernels, cli, dev, list(LADDER_PREC["wide"]), WIDE_ITERATIONS,
                       kernel_path(kernels, "wide"))
    wide["kernel_ms"] = iteration_kernel_ms(torch, mp, kernels, dev, wide["tally"],
                                            wide["iterations"])
    classic = _ladder_run(torch, kernels, cli, dev, ["--precision", "400"], WIDE_ITERATIONS,
                          kernel_path(kernels, "classic"))
    digits, same_steps = _shared_digits(wide, classic)
    print(f"wide objectives agree with classic K=8 to {digits:.1f} significant digits "
          f"over {wide['iterations']} iterations, step lengths identical in {same_steps}; "
          f"s/iteration wide {wide['s_per_it']:.3f} vs classic {classic['s_per_it']:.3f}; "
          f"peak {wide['peak_bytes'] / 2**30:.2f} vs {classic['peak_bytes'] / 2**30:.2f} GiB")
    check(same_steps == wide["iterations"] == classic["iterations"],
          f"step lengths differ from the classic run's ({same_steps} of "
          f"{wide['iterations']} identical)")
    check(digits >= 70, f"wide objectives share only {digits:.1f} digits with classic")
    wide["digits"], wide["classic"] = digits, classic
    return wide


def probe_phase(torch, kernels, dev, smi):
    """Phase 12: the probe's SASS (unfused adds and multiplies only); the
    peak probe against its plain version at the full tile, float32 and
    float64, bit for bit at PROBE_CHECK_STEPS; kernel ms at
    PROBE_STEPS (median of 5), plain ms (once), the bound (operations over
    the data-sheet rate), the measured rate beside the data sheet's, and
    the rate at PROBE_CHECK_STEPS (the JAX tool's steps) beside it."""
    phase("12. peak probe against its plain version; CUDA-core rates")
    from sdpb_tpu_torch.tools.profile_phases import PROBE_A, PROBE_B
    # a fused chain would read ~2x the rate of the unfused adds and
    # multiplies that the MP kernels issue
    sass = subprocess.run([str(Path(kernels._nvcc()).with_name("cuobjdump")), "-sass",
                           str(kernels.library_path(0, kernels.PROBE))],
                          capture_output=True, text=True, check=True).stdout
    ops = {op: len(re.findall(rf"\b{op}\b", sass))
           for op in ("FMUL", "FADD", "FFMA", "DMUL", "DADD", "DFMA")}
    print(f"peak_probe SASS instructions: {ops}")
    check(ops["FFMA"] == ops["DFMA"] == 0 and
          min(ops[op] for op in ("FMUL", "FADD", "DMUL", "DADD")) > 0,
          f"peak_probe SASS is not an unfused chain: {ops}")
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = []
    for dtype in (torch.float32, torch.float64):
        f32 = dtype == torch.float32
        x = torch.rand(PROBE_TILE, generator=gen, dtype=dtype, device=dev) + 0.5
        ok = kernels.peak_probe(x, PROBE_CHECK_STEPS, PROBE_A, PROBE_B)
        op = kernels.peak_probe_plain(x, PROBE_CHECK_STEPS, PROBE_A, PROBE_B)
        err = float((ok - op).abs().max())
        check(torch.equal(ok, op), f"peak_probe {dtype}: kernel differs from plain "
                                   f"(max {err})")
        ms = _time_ms(torch, lambda: kernels.peak_probe(x, PROBE_STEPS, PROBE_A, PROBE_B))
        short_ms = _time_ms(torch, lambda: kernels.peak_probe(
            x, PROBE_CHECK_STEPS, PROBE_A, PROBE_B))
        _, pms = _timed_once(torch, lambda: kernels.peak_probe_plain(
            x, PROBE_STEPS, PROBE_A, PROBE_B))
        ops = 2.0 * PROBE_STEPS * x.numel()
        t_ops = ops / OPS_PER_S[f32]
        t_bytes = 2 * x.numel() * x.element_size() / BYTES_PER_S
        bound, by = 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        rate = ops / (ms / 1e3)
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.strip()
        print(f"peak_probe {str(dtype)[6:]}: {rate:.4e} unfused add/mul per s = "
              f"{100 * rate / OPS_PER_S[f32]:.1f}% of the data sheet's "
              f"{OPS_PER_S[f32]:.3g} (700 W); at the JAX tool's {PROBE_CHECK_STEPS} steps "
              f"{2.0 * PROBE_CHECK_STEPS * x.numel() / (short_ms / 1e3):.4e} "
              f"({short_ms:.4f} ms); SM clock now, max: {clock}")
        # above the sheet the build fused the chain; far below it the probe
        # does not measure the cores
        check(rate <= 1.05 * OPS_PER_S[f32], f"peak_probe {dtype}: {rate:.3e} per s is "
                                             f"above the data sheet (fused?)")
        check(rate >= 0.5 * OPS_PER_S[f32], f"peak_probe {dtype}: {rate:.3e} per s")
        rows.append((f"peak_probe {str(dtype)[6:]}", f"[512,512] x {PROBE_STEPS} steps",
                     err, rate, ms, pms, bound, by))
    print(f"{'kernel':22s} {'shape':40s} {'max|k-p|':>9s} {'ops/s':>10s} "
          f"{'kernel ms':>10s} {'plain ms':>10s} {'bound ms':>10s} bound by")
    for name, shape, err, rate, ms, pms, bound, by in rows:
        print(f"{name:22s} {shape:40s} {err:9.1e} {rate:10.3e} {ms:10.3f} "
              f"{pms:10.1f} {bound:10.4f} {by}")
    print(f"{smi}; launches {kernels.LAUNCHES['peak_probe']}")
    return rows


def profile_phase(torch, kernels, cli, dev, before):
    """Phase 13: the per-phase profiler on the ladder in the three
    representations; each record printed on one line.  The fastest of the
    scaled and of the wide profiled iteration's calls is held to the
    fastest steady iteration (all but the first) of that representation's
    ladder solve, run right before and right after the profile
    (BRACKET_ITERATIONS each).  The iteration is host-bound, and the host
    is shared: a slow stretch of seconds to minutes moves an iteration by
    up to 1.5x, so solves timed minutes earlier (phase 9's) are no
    yardstick, and since a load only ever adds time, each side's fastest
    iteration is its least disturbed reading.  The wide gate is weaker:
    the wide profile runs first, and its solve before is phase 11's,
    `before["wide"]` (the same command, WIDE_ITERATIONS + 1 iterations, so
    one steady one), with phase 11's classic run and phase 12 (~70 s)
    between it and the profile; a second wide solve there would cost the
    script's time limit ~30 s."""
    phase("13. per-phase profiler on the ladder: classic K=4, scaled K32=9, "
          "wide K32=17 (--quant 8, Omega 1e4)")
    from sdpb_tpu_torch.tools import profile_phases
    records, solves, probe_launches = {}, {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        def bracket(label):
            if label in before and label not in solves:
                solves[label] = [before[label]]
            elif label != "classic":
                solves.setdefault(label, []).append(_ladder_run(
                    torch, kernels, cli, dev, list(LADDER_PREC[label]),
                    BRACKET_ITERATIONS[label], kernel_path(kernels, label)))

        for label, limbs, reps in PROFILES:
            bracket(label)
            out = Path(tmp) / f"{label}.json"
            kernels.reset_launches()
            t0 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = profile_phases.main([
                    "--fixture", str(LADDER), "--scaledLimbs", str(limbs), "--quant", "8",
                    "--omega", "1e4", "--reps", str(reps), "--json", str(out),
                    "--device", str(dev)])
            launches = dict(kernels.LAUNCHES)
            rec = json.loads(out.read_text())
            check(rc == 0, f"profile_phases {label} returned {rc}")
            print(f"{label}: {time.time() - t0:.1f} s; launches "
                  f"{ {k: v for k, v in launches.items() if v} }")
            print(json.dumps(rec))
            ms = [r["ms"] for r in rec["phases"][:-1]] + [rec["iteration_ms"]]
            check(all(math.isfinite(m) and m > 0 for m in ms),
                  f"profile_phases {label}: a phase time is not finite and positive: {ms}")
            check(launches["peak_probe"] == 6, f"{label}: the probe ran "
                                               f"{launches['peak_probe']} times, not 6")
            check(all(launches[n] > 0 for n in kernel_path(kernels, label)),
                  f"profile_phases {label}: a kernel did not run: {launches}")
            probe_launches += launches["peak_probe"]
            records[label] = rec
            bracket(label)
    print(f"{'phase':22s} " + " ".join(f"{lb + ' ms':>12s} {'%':>5s} {'%peak':>6s}"
                                       for lb, _, _ in PROFILES))
    for i, r in enumerate(records["classic"]["phases"]):
        cells = []
        for lb, _, _ in PROFILES:
            q = records[lb]["phases"][i]
            pk = q.get("pct_of_peak")
            cells.append(f"{q['ms']:12.2f} {q['pct_of_iteration']:5.1f} "
                         f"{'' if pk is None else pk:>6}")
        print(f"{r['phase'][:22]:22s} " + " ".join(cells))
    print("iteration ms: " + ", ".join(f"{lb} {records[lb]['iteration_ms']:.2f}"
                                       for lb, _, _ in PROFILES)
          + f"; peak GFLOP/s {records['classic']['peak_gflops_measured']} float64, "
          f"{records['scaled']['peak_gflops_measured']} float32; "
          f"card {records['scaled']['card']}")
    for lb in ("scaled", "wide"):
        its = [t for run in solves[lb] for t in run["steady_its"]]
        prof = [t / 1e3 for t in records[lb]["iteration_samples_ms"]]
        ratio = min(prof) / min(its)
        print(f"{lb} iteration: fastest call {min(prof):.3f} s ("
              f"{' '.join(f'{t:.2f}' for t in prof)}) against the fastest {min(its):.3f} "
              f"s of the steady iterations of the solves before and after it "
              f"({' '.join(f'{t:.2f}' for t in its)}): ratio {ratio:.3f}")
        # the profiler times the solver's own iteration, at the factor limbs
        # its Omega gives; more than 25% away, it timed something else
        check(0.75 <= ratio <= 1.25, f"profile_phases {lb}: iteration {ratio:.3f}x the "
                                     f"solve's s/iteration")
    return records, probe_launches


def _stat_bits(v):
    """A HostStats field as exactly comparable Python values."""
    import numpy as np
    if isinstance(v, list):
        return tuple(_stat_bits(w) for w in v)
    if isinstance(v, tuple):
        return (np.asarray(v[0]).tobytes(), v[1])
    return v.tobytes() if isinstance(v, np.ndarray) else v


def chunked_phase(torch, kernels, cli, dev, hosts):
    """Phase 14: the ladder in the chunked loop (the CLI's default) in the
    three representations, each against the host-loop run of the same
    command in phases 6, 9 and 11 (`hosts`: label -> its _ladder_run)."""
    phase(f"14. the chunked loop (CUDA-graph replays) against the host loop on the "
          f"ladder: classic K=5 and scaled K32=9 ({LADDER_ITERATIONS} iterations, chunks of "
          f"{LADDER_CHUNK}), wide "
          f"2x9 ({WIDE_ITERATIONS})")
    out = {}
    for label, its in (("classic", LADDER_ITERATIONS), ("scaled", LADDER_ITERATIONS),
                       ("wide", WIDE_ITERATIONS)):
        path = kernel_path(kernels, label)
        # two words in one chunk of their iterations (a longer chunk would
        # replay more after the stop, ~3 s each)
        chunked = _ladder_run(torch, kernels, cli, dev, list(LADDER_PREC[label]), its, path,
                              chunk_iterations=its + 1 if label == "wide" else LADDER_CHUNK)
        out[label] = _loops_agree(torch, label, hosts[label], chunked, path)
    return out


def _loops_agree(torch, label, host, chunked, path):
    """The ladder run of the chunked loop against that of the host loop:
    every statistic, the reason, the count and the final state identical;
    the path's launches those of the eager warm-up and the replays, each
    replay what the capture recorded.  Prints s/iteration both ways, the
    graphs' sizes and seconds, and a replay's device ms."""
    from sdpb_tpu_torch.solver.step import state_tensors
    a, b = host["result"], chunked["result"]
    check(str(a.terminate_reason) == str(b.terminate_reason) and
          a.iterations == b.iterations and len(a.history) == len(b.history),
          f"{label}: the chunked loop ended otherwise: {b.terminate_reason} after "
          f"{b.iterations} against {a.terminate_reason} after {a.iterations}")
    diffs = [(i + 1, f) for i, (x, y) in enumerate(zip(a.history, b.history))
             for f in x._fields if _stat_bits(getattr(x, f)) != _stat_bits(getattr(y, f))]
    check(not diffs, f"{label}: statistics differ from the host loop's: {diffs[:8]}")
    check(all(torch.equal(p, q) for p, q in zip(state_tensors(a.state),
                                                state_tensors(b.state))),
          f"{label}: the final state differs from the host loop's")
    (kf, info), = b.graphs.items()
    replays = sum(n for _, n, _ in b.chunks)
    per = info["launches_per_replay"]
    # the eager warm-up ahead of the capture, then every replay
    check(all(chunked["launches"][k] == (replays + 1) * per.get(k, 0)
              for k in chunked["launches"]) and all(per.get(k, 0) > 0 for k in path),
          f"{label}: launches {chunked['launches']} are not {replays} + 1 times the "
          f"capture's {per}")
    ratio = host["s_per_it"] / chunked["s_per_it"]
    parts = [statistics.median(p) for p in zip(*b.replay_ms)]
    print(f"{label}: {len(b.history)} iterations identical, {b.terminate_reason}; "
          f"s/iteration host loop {host['s_per_it']:.4f}, chunked {chunked['s_per_it']:.4f} "
          f"({ratio:.2f}x); graphs (factor {kf} limbs) A+B nodes {info['nodes']} "
          f"(kernels {info['kernel_nodes']}), warm-up {info['warmup_s']:.2f} s, capture "
          f"{info['capture_s']:.2f} s, instantiate {info['instantiate_s']:.2f} s, pool "
          f"{info['pool_bytes'] / 2**30:.2f} GiB; peak device memory host loop "
          f"{host['peak_bytes'] / 2**30:.2f} GiB, chunked {chunked['peak_bytes'] / 2**30:.2f} "
          f"GiB; wall host loop {host['wall']:.1f} s, chunked {chunked['wall']:.1f} s; "
          f"{replays} replays, launches per replay {per}")
    print(f"{label}: a replay's device ms (median of {len(b.replay_ms)}): graph A "
          f"{parts[0]:.2f} ({1e3 * parts[0] / info['nodes'][0]:.2f} us a node), the "
          f"eigvalsh calls and the host's sync {parts[1]:.2f}, graph B {parts[2]:.2f} "
          f"({1e3 * parts[2] / info['nodes'][1]:.2f} us a node)")
    return {"host": host, "chunked": chunked, "graphs": info, "ratio": ratio,
            "replay_ms": parts}


def _state_values(state):
    """y and every bucket's x, X and Y of a state (MP or wide values)."""
    return [state.y] + [getattr(b, f) for b in state.buckets
                        for f in ("x", "X_even", "X_odd", "Y_even", "Y_odd")]


def _redistilled(a, b) -> int:
    """Elements of two MP (or wide) values whose limbs or exponents
    differ; each must hold the same value exactly.  Their count."""
    import numpy as np
    words = list(zip(getattr(a, "words", [a]), getattr(b, "words", [b])))

    def parts(w):
        limbs = w.limbs.reshape(w.K, -1).cpu().numpy()
        exp = (np.zeros(limbs.shape[1], np.int64) if w.exp is None
               else w.exp.reshape(-1).cpu().numpy())
        return limbs, exp

    pa, pb = [parts(w) for w, _ in words], [parts(v) for _, v in words]
    differ = np.zeros(pa[0][0].shape[1], bool)
    for (la, ea), (lb, eb) in zip(pa, pb):
        differ |= ~(np.all(la == lb, axis=0) & (ea == eb))
    idx = np.nonzero(differ)[0]

    def value(ps, i):
        return sum((sum((Fraction(float(x)) for x in limbs[:, i]), Fraction(0))
                    * Fraction(2) ** int(exp[i]) for limbs, exp in ps), Fraction(0))

    if idx.size:
        # a - b exactly, as float64 rows (every limb times 2^exp; b's
        # negated) distilled until no two overlap: all zero just where the
        # values are equal (a wide state re-distils ~10^5 elements); an
        # element left nonzero (or past float64's range) is held to the
        # exact sum of its limbs
        from sdpb_tpu_torch.ops.mpwide import _full_distill
        rows, exact = [], np.ones(idx.size, bool)
        with np.errstate(over="ignore", under="ignore"):
            for ps, sign in ((pa, 1.0), (pb, -1.0)):
                for limbs, exp in ps:
                    e = np.maximum(exp[idx], -1500).astype(np.int64)
                    for k in range(limbs.shape[0]):
                        x = limbs[k, idx].astype(np.float64)
                        r = np.ldexp(x, e)
                        exact &= np.isfinite(r) & (np.ldexp(r, -e) == x)
                        rows.append(sign * r)
        zero = exact & np.all(np.stack(_full_distill(rows)) == 0, axis=0)
        for i in idx[~zero]:
            check(value(pa, i) == value(pb, i), f"element {i}: the checkpoint changed its value")
    return int(differ.sum())


def _rel_diff(mp, a, b) -> float:
    """max |a - b| / max |b| of two MP (or wide) values, the difference
    taken exactly in float64 limbs on the host."""
    import torch
    x, y = (mp.MP(torch.as_tensor(mp.host_f64_limbs(v))) for v in (a, b))
    scale = float(mp.to_double(y).abs().max()) if y.limbs.numel() else 0.0
    d = float(mp.to_double(mp.sub(x, y)).abs().max()) if y.limbs.numel() else 0.0
    return d / scale if scale else d


def _round_trip(torch, dev, tmp, label, K32, K, state):
    """Save `state` of the ladder in `label`'s representation and load it
    into a fresh DeviceSDP on the card.  Every element must come back bit
    for bit, or, where the arithmetic left a tail above half an ulp,
    re-distilled to the same value.  (the DeviceSDP, bytes, save s, load
    s, elements re-distilled)."""
    import numpy as np
    from sdpb_tpu_torch.io.sdp_zip import read_sdp
    from sdpb_tpu_torch.models.sdp import build_device_sdp
    from sdpb_tpu_torch.solver.checkpoint import load_checkpoint, save_checkpoint
    sdp = build_device_sdp(read_sdp(str(LADDER), K, np.float64), dev, scaled_limbs=K32)
    ck = tmp / f"{label}.saved"
    t0 = time.time()
    gen = save_checkpoint(ck, sdp, state, verbosity=0)
    save_s = time.time() - t0
    t0 = time.time()
    loaded = load_checkpoint(ck, sdp, verbosity=0)
    torch.cuda.synchronize(dev)
    load_s = time.time() - t0
    redistilled = sum(_redistilled(a, b) for a, b in zip(_state_values(loaded),
                                                         _state_values(state)))
    return sdp, (ck / f"checkpoint_{gen}.npz").stat().st_size, save_s, load_s, redistilled


def _resumes_agree(torch, mp, label, bits, from_file, from_memory, exact):
    """The two resumed runs: identical statistics, reason, count and final
    state when the loaded state was bit for bit the saved one; else (a
    state re-distilled in a few elements) within the tolerance of
    tests/test_torch_checkpoint.py, for `bits` bits of mantissa (24 K32
    scaled, 53 K classic): MP statistics and each state array within
    2^-(bits - 24) relative, float64 statistics within 1e-12 relative or
    2^-(bits - 24) absolute.  Returns the largest relative difference of
    an MP statistic or a state array (0 when identical)."""
    import mpmath
    from sdpb_tpu_torch.solver.solve import host_mpf
    from sdpb_tpu_torch.solver.step import state_tensors
    a, b = from_file, from_memory
    check(str(a.terminate_reason) == str(b.terminate_reason) and
          a.iterations == b.iterations and len(a.history) == len(b.history),
          f"{label}: the resume from the file ended otherwise ({a.terminate_reason} after "
          f"{a.iterations}) than the one from memory ({b.terminate_reason} after "
          f"{b.iterations})")
    diffs = [(i + 1, f) for i, (x, y) in enumerate(zip(a.history, b.history))
             for f in x._fields if _stat_bits(getattr(x, f)) != _stat_bits(getattr(y, f))]
    same_state = all(torch.equal(p, q) for p, q in zip(state_tensors(a.state),
                                                       state_tensors(b.state)))
    if exact or (not diffs and same_state):
        check(not diffs, f"{label}: resumed statistics differ: {diffs[:8]}")
        check(same_state, f"{label}: the final states of the two resumes differ")
        return 0.0
    tol = 2.0 ** -(bits - 24)
    worst = 0.0
    with mpmath.workprec(bits + 64):
        for i, f in diffs:
            x, y = getattr(a.history[i - 1], f), getattr(b.history[i - 1], f)
            if isinstance(x, bool):
                check(x == y, f"{label}: iteration {i} {f} differs between the resumes")
                continue
            if isinstance(x, float):
                check(abs(x - y) <= max(1e-12 * abs(y), tol),
                      f"{label}: iteration {i} {f} is {x!r} and {y!r} in the resumes")
                continue
            u, v = host_mpf(x), host_mpf(y)
            err = float(abs(u - v) / abs(v)) if v else float(abs(u))
            check(err <= tol, f"{label}: iteration {i} {f} differs by {err:.3e} between "
                              f"the resumes")
            worst = max(worst, err)
    for x, y in zip(_state_values(a.state), _state_values(b.state)):
        err = _rel_diff(mp, x, y)
        check(err <= tol, f"{label}: the resumed states differ by {err:.3e}")
        worst = max(worst, err)
    return worst


def checkpoint_phase(torch, mp, kernels, cli, dev, wide_state, smi):
    """Phase 15: checkpoints, resume and the timing run through the CLI on
    the ladder.  (a) classic K=5 and scaled K32=9: a solve of
    CHECKPOINT_ITERATIONS + 1 iterations (two chunks of CHECKPOINT_CHUNK)
    with a checkpoint at every chunk's start and the final one; its final state saved and
    loaded on the card bit for bit, but for elements whose tail the
    arithmetic left above half an ulp, which come back re-distilled to the
    same value (checked exactly); then RESUME_ITERATIONS + 1 iterations
    (chunks of CHECKPOINT_CHUNK) resumed from the file by the CLI (-i) and
    from the state in memory by run_solver: every statistic, the reason, the count and the final state
    identical when no element was re-distilled, else within
    _resumes_agree's tolerance; the path's kernels launched in the resumed
    CLI run.  (b) phase 14's final wide 2x9 state saved and loaded the same
    way.  (c) the
    timing run: a classic CLI call with --timingRun auto writes
    block_timings.json with both candidates; the same call again measures
    nothing and resumes.  Prints the checkpoints' bytes, save and load
    seconds, each candidate's ms/iteration and the timing run's wall
    seconds beside the card's name and power limit."""
    phase("15. checkpoint, resume and timing run on the ladder: classic K=5 and scaled "
          "K32=9 resumed from the file and from memory, the wide 2x9 state round trip, "
          "block_timings.json written and reused")
    from sdpb_tpu_torch.parallel.timing import CANDIDATES, TIMINGS_FILE
    from sdpb_tpu_torch.solver.checkpoint import METADATA
    from sdpb_tpu_torch.solver.solve import run_solver
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for label in ("classic", "scaled"):
            ck = tmp / label
            base = ["-s", str(LADDER), "--device", str(dev), *LADDER_PREC[label],
                    *LADDER_FLAGS, "--timingRun", "never", "--verbosity", "0"]
            first = cli.run(base + ["-o", str(tmp / f"{label}.out"), "-c", str(ck),
                                    "--maxIterations", str(CHECKPOINT_ITERATIONS),
                                    "--checkpointInterval", "0"],
                            chunk_iterations=CHECKPOINT_CHUNK)
            meta = json.loads((ck / METADATA).read_text())
            last = len(first.chunks)        # a save at each chunk's start, then the final
            kept = sorted(p.name for p in ck.glob("checkpoint_*.npz"))
            check((meta["current"], meta.get("backup")) == (last, last - 1) and
                  kept == [f"checkpoint_{last - 1}.npz", f"checkpoint_{last}.npz"],
                  f"{label}: chunks {first.chunks}, checkpoint.json {meta}, files {kept}")
            params = cli.solver_params_from_args(cli.parse_with_param_file(
                cli.build_parser(), base))
            K32 = cli.limbs_for_precision(params.precision, 24) if label == "scaled" else 0
            K = -(-(24 * K32) // 53) + 1 if K32 else cli.limbs_for_precision(params.precision)
            sdp, nbytes, save_s, load_s, redistilled = _round_trip(
                torch, dev, tmp, label, K32, K, first.state)
            check((ck / kept[-1]).stat().st_size == nbytes,
                  f"{label}: the CLI's final checkpoint and a save of its state differ in size")
            kernels.reset_launches()
            from_file = cli.run(base + ["-o", str(tmp / f"{label}.resumed"),
                                        "-c", str(tmp / f"{label}.ck2"), "-i", str(ck),
                                        "--maxIterations", str(RESUME_ITERATIONS)],
                                chunk_iterations=CHECKPOINT_CHUNK)
            launches = dict(kernels.LAUNCHES)
            params.max_iterations = RESUME_ITERATIONS
            from_memory = run_solver(sdp, params, verbosity=0, initial=first.state,
                                     chunk_iterations=CHECKPOINT_CHUNK)
            bits = 24 * K32 if K32 else 53 * K
            worst = _resumes_agree(torch, mp, label, bits, from_file, from_memory,
                                   exact=redistilled == 0)
            path = kernel_path(kernels, label)
            check(all(launches[n] > 0 for n in path),
                  f"{label}: a kernel of the path did not run in the resumed run: {launches}")
            agree = ("identical" if worst == 0.0 else
                     f"within {worst:.3e} relative (the tolerance 2^-{bits - 24})")
            print(f"{label}: {len(first.history)} iterations in {len(first.chunks)} chunks, "
                  f"checkpoints kept {kept} (current {meta['current']}, backup "
                  f"{meta['backup']}); checkpoint {nbytes} bytes, save {save_s:.3f} s, load "
                  f"{load_s:.3f} s; loaded state bit for bit but {redistilled} elements "
                  f"re-distilled to the same value; {len(from_file.history)} iterations "
                  f"resumed from the file and from memory {agree}, "
                  f"{from_file.terminate_reason}; launches in the resumed CLI run "
                  f"{ {n: launches[n] for n in path} }; card {smi}")
            out[label] = {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
                          "launches": launches, "redistilled": redistilled, "worst": worst,
                          "state": first.state, "resumed": from_file}

        _, nbytes, save_s, load_s, redistilled = _round_trip(torch, dev, tmp, "wide", 17, 9,
                                                             wide_state)
        print(f"wide 2x9: checkpoint {nbytes} bytes, save {save_s:.3f} s, load {load_s:.3f} s; "
              f"loaded state bit for bit but {redistilled} elements re-distilled to the same "
              f"value; card {smi}")
        out["wide"] = {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
                       "redistilled": redistilled}

        ck = tmp / "timing"
        argv = ["-s", str(LADDER), "-o", str(tmp / "timing.out"), "-c", str(ck),
                "--device", str(dev), *LADDER_PREC["classic"], *LADDER_FLAGS,
                "--maxIterations", "1", "--timingRun", "auto"]
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            cli.run(argv)
        wall = re.search(r"timing run      : ([0-9.]+) s, chose (\w+) quant=(\d+)",
                         text.getvalue())
        check(wall is not None, "the CLI ran no timing run on the ladder")
        record = json.loads((ck / TIMINGS_FILE).read_text())
        measured = record["measured"]
        check([(m["policy"], m["quant"]) for m in measured] == [tuple(c) for c in CANDIDATES]
              and all(m["num_buckets"] >= 1 and m["s_per_iteration"] > 0 for m in measured),
              f"block_timings.json: {measured}")
        again = io.StringIO()
        with contextlib.redirect_stdout(again):
            cli.run(argv)
        check("timing run" not in again.getvalue() and
              "Loading binary checkpoint" in again.getvalue() and
              json.loads((ck / TIMINGS_FILE).read_text()) == record,
              "the second call with the same checkpoint directory ran the timing run again "
              "or did not resume")
        print(f"timing run: {float(wall.group(1)):.2f} s wall, chose {wall.group(2)} "
              f"quant={wall.group(3)}; " + ", ".join(
                  f"{m['policy']} quant={m['quant']} {1e3 * m['s_per_iteration']:.2f} "
                  f"ms/iteration ({m['num_buckets']} buckets)" for m in measured)
              + f"; the second call measured nothing and resumed; card {smi}")
        out["timing"] = {"wall_s": float(wall.group(1)), "measured": measured}
    return out


# ---------------------------------------------------------------------------
# Phase 16: the tools that drive the solver


def _approx_run(kernels, acli, label, argv):
    """One approx_objective CLI call: (results, timings, launches), the
    counts set to 0 just before it and read just after."""
    timings = {}
    kernels.reset_launches()
    res = acli.run(argv, timings=timings)
    return res, timings, dict(kernels.LAUNCHES)


def _outer_run(torch, kernels, ocli, label, argv):
    rounds = []
    kernels.reset_launches()
    t0 = time.time()
    out = ocli.run(argv, rounds=rounds)
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    check(all(launches[n] > 0 for n in kernel_path(kernels, "classic")),
          f"outer_limits {label}: a kernel did not run: {launches}")
    for i, r in enumerate(rounds):
        print(f"outer_limits {label} solve {i + 1}: {r['constraints']} constraints, threshold "
              f"{r['threshold']}, {r['iterations']} iterations, {r['reason']}; host "
              f"{r['host_s']:.2f} s, solve {r['solve_s']:.2f} s of which capture "
              f"{r['capture_s']:.2f} s")
    host = sum(r["host_s"] for r in rounds)
    solve = sum(r["solve_s"] for r in rounds)
    capture = sum(r["capture_s"] for r in rounds)
    print(f"outer_limits {label}: optimal {out['optimal'][:40]}; {len(rounds)} solves in "
          f"{wall:.1f} s (host {host:.1f} s, solves {solve:.1f} s of which capture "
          f"{capture:.1f} s); launches {launches}")
    return {"out": out, "rounds": rounds, "seconds": wall, "host_s": host, "solve_s": solve,
            "capture_s": capture, "launches": launches}


def outer_limits_runs(dev):
    """outer_limits of phase 16 (the certificate, the first OUTER_BLOCKS
    ladder blocks) on the card `dev`, each CLI call's results, rounds and
    launches; a task of a pool of its own (outer_limits_start)."""
    import torch
    from sdpb_tpu_torch.cli import outer_limits as ocli, sdp2functions
    from sdpb_tpu_torch.ops import kernels
    dev = torch.device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        return _outer_limits_in(torch, kernels, ocli, sdp2functions, dev, Path(tmp))


def _outer_limits_in(torch, kernels, ocli, sdp2functions, dev, tmp):
    outer = {}
    points = tmp / "points1.json"
    points.write_text('{"points": [["0.5", "1", "2"]]}')
    t0 = time.time()
    sdp2functions.main(["-i", str(CERTIFICATE_PMP), "-o", str(tmp / "cert_fn.json"),
                        "--precision", "150"])
    print(f"sdp2functions certificate: {time.time() - t0:.2f} s")
    outer["certificate"] = _outer_run(torch, kernels, ocli, "certificate", [
        "--functions", str(tmp / "cert_fn.json"), "--points", str(points),
        "--out", str(tmp / "cert_out.json"), "--precision", "150",
        "--dualityGapThreshold", OUTER_GAP["certificate"],
        "--initialMatrixScalePrimal", "1e2", "--initialMatrixScaleDual", "1e2",
        "--device", str(dev), *OUTER_FLAGS])

    doc = json.loads(LADDER_PMP.read_text())
    doc["PositiveMatrixWithPrefactorArray"] = \
        doc["PositiveMatrixWithPrefactorArray"][:OUTER_BLOCKS]
    (tmp / "ladder_pmp.json").write_text(json.dumps(doc))
    t0 = time.time()
    sdp2functions.main(["-i", str(tmp / "ladder_pmp.json"), "-o",
                        str(tmp / "ladder_fn.json"), "--precision", "216"])
    print(f"sdp2functions {OUTER_BLOCKS} ladder blocks at 216 bits: "
          f"{time.time() - t0:.2f} s")
    (tmp / "points.json").write_text(json.dumps({"points": [["0.5", "1", "2"]]
                                                 * OUTER_BLOCKS}))
    outer["ladder"] = _outer_run(torch, kernels, ocli, "ladder", [
        "--functions", str(tmp / "ladder_fn.json"), "--points", str(tmp / "points.json"),
        "--out", str(tmp / "ladder_out.json"), "--precision", "150",
        "--dualityGapThreshold", OUTER_GAP["ladder"],
        "--initialMatrixScalePrimal", "1e4", "--initialMatrixScaleDual", "1e4",
        "--device", str(dev), *OUTER_FLAGS])
    return outer


def outer_limits_start(dev):
    """outer_limits_runs in a pool of one process at normal priority (the
    card's second context; its solves are small and its mesh search
    host-bound), started with the phases it runs beside: (pool, future)."""
    pool = _pool(1)
    atexit.register(pool.shutdown, cancel_futures=True)
    return pool, pool.submit(_captured, outer_limits_runs, str(dev))


def outer_limits_result(outer_limits, smi):
    """Wait for outer_limits_start's run, print what it printed and check
    what it found against the references."""
    import mpmath
    pool, future = outer_limits
    t0 = time.time()
    try:
        text, outer = future.result()
    except Exception as e:
        raise PhaseError(f"outer_limits failed: {e!r}") from e
    finally:
        pool.shutdown()
    print(text.strip())
    print(f"outer_limits (beside the phases since phase 15): waited {time.time() - t0:.1f} s")
    with mpmath.workprec(300):
        dy = abs(mpmath.mpf(outer["certificate"]["out"]["optimal"]) + mpmath.mpf(Y_OPT))
    print(f"outer_limits certificate: |optimal + y_opt| = {mpmath.nstr(dy, 3)}")
    check(dy < mpmath.mpf("1e-9"), f"outer_limits certificate optimum off by {dy}")
    ref = json.loads(LADDER_OUTER.read_text())
    got = outer["ladder"]["out"]
    with mpmath.workprec(300):
        d_opt = abs(mpmath.mpf(got["optimal"]) - mpmath.mpf(ref["optimal"]))
        d_w = max(abs(mpmath.mpf(a) - mpmath.mpf(b)) for a, b in zip(got["y"], ref["y"]))
    print(f"outer_limits ladder ({OUTER_BLOCKS} blocks) against the JAX package's "
          f"out.json: optimal differs by {mpmath.nstr(d_opt, 3)}, weights by at most "
          f"{mpmath.nstr(d_w, 3)}; card {smi}")
    check(len(got["y"]) == len(ref["y"]) == OUTER_BLOCKS and d_opt < mpmath.mpf("1e-9")
          and d_w < mpmath.mpf("1e-6"),
          f"outer_limits ladder: optimal off by {d_opt}, weights by {d_w}")
    return outer


def tools_phase(torch, mp, kernels, cli, dev, smi, outer_limits):
    """Phase 16: approx_objective and outer_limits (with sdp2functions as
    its front end).  (a) The ladder solved to optimality (216 bits classic,
    Omega 1e4, gap 1e-20) with x, y, X and Y written; approx_objective of
    the perturbed ladder from that solution in the scaled (208 bits), wide
    (400 bits) and classic (216 bits) representations, each launching its
    path's kernels, the CLI's precision warning given for scaled (whose
    ~188 bits fall short of the quadratic term's ~3 log2(1/gap)) and for
    no other, classic with --writeSolverState, then classic again
    loading solver_state.npz to the same JSON; the perturbed ladder
    re-solved classic, and classic approx_objective held to it within
    QUAD_BOUND, its linear part off by more than 100 QUAD_BOUND; scaled and
    wide held to classic within APPROX_REL; the setup's S and Q factor times
    at Kf = K.  (b) outer_limits on the certificate's functions (the port's
    sdp2functions at 150 bits from its PMP) to the bisected optimum within
    1e-9, and on the first OUTER_BLOCKS ladder blocks (sdp2functions at 216
    bits, full N = 15 and degree 18; outer_limits at 150 bits) against the
    JAX package's out.json, each solve's host, solve and capture seconds
    printed: `outer_limits` (outer_limits_start's), run in a process of its
    own beside phases 15 and 16 (its mesh search is the longest host-bound
    stretch of the script)."""
    phase(f"16. approx_objective on the ladder (classic, scaled, wide) and outer_limits on "
          f"the certificate and {OUTER_BLOCKS} ladder blocks")
    import mpmath
    from sdpb_tpu_torch.cli import approx_objective as acli
    from sdpb_tpu_torch.solver.solve import host_mpf
    from sdpb_tpu_torch.tools import approx_objective as tao
    out = {"approx": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        sol = tmp / "ladder_out"
        t0 = time.time()
        res = cli.run(["-s", str(LADDER), "-o", str(sol), "-c", str(tmp / "ck"),
                       "--timingRun", "never", "--device", str(dev), *LADDER_PREC["classic"],
                       *LADDER_FLAGS, "--writeSolution", "x,y,X,Y", "--verbosity", "0"])
        solve_s = time.time() - t0
        check(str(res.terminate_reason) == "found primal-dual optimal solution",
              f"the ladder solve ended with {res.terminate_reason}")
        print(f"ladder solved classic 216 bits: {res.iterations} iterations in {solve_s:.1f} s, "
              f"dual objective {mpmath.nstr(res.dual_objective, 30)}")
        base = ["--sdp", str(LADDER), "--newSdp", str(LADDER_PERTURBED), "--solutionDir",
                str(sol), "--device", str(dev)]
        for label in ("scaled", "wide", "classic"):
            extra = ["--writeSolverState"] if label == "classic" else []
            t0 = time.time()
            r, timings, launches = _approx_run(kernels, acli, label,
                                               base + list(LADDER_PREC[label]) + extra)
            wall = time.time() - t0
            path = kernel_path(kernels, label)
            check(timings["frozen"] == "setup" and all(launches[n] > 0 for n in path),
                  f"approx_objective {label}: frozen solver {timings['frozen']}, a kernel "
                  f"did not run: {launches}")
            check(bool(timings["warning"]) == (label == "scaled"),
                  f"approx_objective {label}: precision warning {timings['warning']!r}")
            print(f"approx_objective {label}: setup {timings['frozen_s']:.3f} s, new SDP "
                  f"{timings['new_sdp_s'][0]:.3f} s (reading it included), wall {wall:.1f} s; "
                  f"objective {r[0]['objective']}, d_objective {r[0]['d_objective']}, "
                  f"dd_objective {r[0]['dd_objective']}; "
                  f"launches {launches}; precision warning {timings['warning']!r}; "
                  f"card {smi}")
            out["approx"][label] = {"result": r[0], "timings": timings, "launches": launches}
        r2, timings, launches = _approx_run(kernels, acli, "classic",
                                            base + list(LADDER_PREC["classic"]))
        first = out["approx"]["classic"]
        check(timings["frozen"] == "npz" and r2 == [first["result"]],
              f"approx_objective from solver_state.npz: {timings['frozen']}, {r2} against "
              f"{first['result']}")
        setup_launches = {k: v - launches[k] for k, v in first["launches"].items()}
        print(f"approx_objective classic from solver_state.npz: identical JSON; load "
              f"{timings['frozen_s']:.3f} s, new SDP {timings['new_sdp_s'][0]:.3f} s; launches "
              f"per new SDP {launches}, in the setup {setup_launches}")
        out["load"] = {"timings": timings, "launches": launches,
                       "setup_launches": setup_launches}

        frozen, kf = tao.load_solver_state(sol / "solver_state.npz", dev)
        for name, A in [(f"S bucket {i}", S) for i, S in enumerate(frozen.Ss)] + \
                [("Q", frozen.Q)]:
            Af = mp.round_to(A, kf)
            ms = _time_ms(torch, lambda: kernels.mp_cholesky(Af))
            print(f"factor of {name} {tuple(A.shape)} at Kf = {kf}: {ms:.3f} ms")

        t0 = time.time()
        res2 = cli.run(["-s", str(LADDER_PERTURBED), "-o", str(tmp / "perturbed_out"),
                        "-c", str(tmp / "ck2"), "--timingRun", "never", "--device", str(dev),
                        *LADDER_PREC["classic"], *LADDER_FLAGS, "--verbosity", "0"])
        resolve_s = time.time() - t0
        tail = [(f"{float(host_mpf(h.duality_gap)):.2e}", h.primal_step, h.dual_step)
                for h in res2.history[-3:]]
        check(str(res2.terminate_reason) == "found primal-dual optimal solution",
              f"the perturbed ladder's solve ended with {res2.terminate_reason} after "
              f"{res2.iterations} iterations; the last (gap, steps) {tail}")
        with mpmath.workprec(800):
            c = first["result"]

            def linear(r):
                return mpmath.mpf(r["objective"]) - mpmath.mpf(r["dd_objective"])

            quad = abs(mpmath.mpf(c["objective"]) - res2.dual_objective)
            lin = abs(linear(c) - res2.dual_objective)
            rel = {}
            for lb, tol in APPROX_REL.items():
                r = out["approx"][lb]["result"]
                got = {"objective": mpmath.mpf(r["objective"]),
                       "d_objective": mpmath.mpf(r["d_objective"]), "linear": linear(r)}
                want = {"objective": mpmath.mpf(c["objective"]),
                        "d_objective": mpmath.mpf(c["d_objective"]), "linear": linear(c)}
                rel[lb] = {k: float(abs(got[k] - want[k]) / abs(want[k])) for k in got}
        print(f"perturbed ladder re-solved classic: {res2.iterations} iterations in {resolve_s:.1f} s, dual objective "
              f"{mpmath.nstr(res2.dual_objective, 40)}; classic approx_objective off by "
              f"{mpmath.nstr(quad, 4)} (bound {QUAD_BOUND:g}), its linear part by "
              f"{mpmath.nstr(lin, 4)}; scaled and wide against classic (relative): {rel}")
        check(quad < QUAD_BOUND, f"the quadratic approximation is off by {quad}")
        check(lin > 100 * QUAD_BOUND, f"the linear error {lin} is not well above the bound")
        for lb, errs in rel.items():
            check(all(errs[k] <= APPROX_REL[lb][k] for k in APPROX_REL[lb]),
                  f"approx_objective {lb} against classic: {errs}")
        out.update(quad_err=float(quad), lin_err=float(lin), rel=rel, solve_s=solve_s,
                   resolve_s=resolve_s)
    out["outer"] = outer_limits_result(outer_limits, smi)
    return out


def wide3_rows(kernels):
    """Phase 17's three-word kernel rows, in order: (name, op, Kg, shape a,
    shape b, record).  At each Kg of WIDE3_CHECK_KG the GEMM at the
    ladder's two GEMM shapes (the smaller one at WIDE3_SMALL_KG) and two
    edge shapes of its tiling (one unpadded chunk of Kd < c terms and Kd =
    c + 1: two chunks, the second padded; B = 1, 35 outputs: a ragged last
    block of 32), then the sum and product at WIDE3_EW_SHAPES (the X
    blocks' and the edge one at WIDE3_SMALL_KG).  `record`: the row the
    kernels' record reports (Kg = 9: the GEMM's first shape, the sum's and
    product's first), held to its plain version on the card over the whole
    batch."""
    rows = []
    for Kg in WIDE3_CHECK_KG:
        c = kernels.wide3_chunk(3 * Kg)
        small = Kg in WIDE3_SMALL_KG
        for i, (B, M, Kd, N) in enumerate(GEMM_SHAPES[:1 if small else None]
                                          + ((1, 5, c - 1, 7), (1, 5, c + 1, 7))):
            rows.append(("mp_matmul_wide3", "gemm", Kg, (B, M, Kd), (B, Kd, N),
                         Kg == 9 and i == 0))
        for i, shape in enumerate(WIDE3_EW_SHAPES[1 if small else 0:]):
            for name, op in (("mp_wide3_add", "add"), ("mp_wide3_mul", "mul")):
                rows.append((name, op, Kg, shape, shape, Kg == 9 and i == 0))
    return rows


def wide3_tasks(background, kernels):
    """Phase 17's background tasks: each three-word row's operands (from its
    own seed) and, but for the record rows, its plain version over
    plain_blocks of its batch; then the classic K = 13 rows' plain
    versions (_kernel_task)."""
    rows = [background.submit(_wide_task, op, 3, Kg, ash, bsh, 17_000 + i,
                              None if record else plain_blocks(ash[0]))
            for i, (_, op, Kg, ash, bsh, record) in enumerate(wide3_rows(kernels))]
    return rows, background.submit(_kernel_task, 13, plain_blocks(120))


def wide3_kernel_rows(torch, kernels, dev, tasks):
    """The three-word kernels against their plain versions (wide3_rows):
    bit-identical words, mpmath spot checks (the GEMM within 2^-(72 Kg -
    26) of the sum of the terms' magnitudes, sum and product within
    2^-(72 Kg - 22) of the operands' magnitudes and of the product), kernel
    ms (median of 5), plain ms (once: on the card over the whole batch for
    the record rows, else on the CPU over plain_blocks), the bound (word
    TwoSums less those of the needed work that the plain run's tally found
    more than 24 Kg digits apart, which the kernels skip alike; counted on
    the blocks the plain version ran, in proportion to the batch)."""
    import mpmath
    import numpy as np
    from sdpb_tpu_torch.ops import mpwide_kernel as wk
    rows = []
    for (name, op, Kg, ash, bsh, record), task in zip(wide3_rows(kernels), tasks):
        pa, pb, pp, skipped, sec = task.result()
        A, Bm = _value(pa, dev), _value(pb, dev)
        kern = kernels.mp_matmul_wide if op == "gemm" else getattr(kernels, name)
        ok = kern(A, Bm)
        B = ash[0]
        if record:
            tally = wk.SkipTally()
            plain = (lambda: kernels.mp_matmul_wide3_plain(
                *kernels._canon_wide_pair(A, Bm)[:2], tally)) if op == "gemm" else \
                (lambda: getattr(kernels, name + "_plain")(A, Bm, tally))
            op_out, pms = _timed_once(torch, plain)
            kk, skipped, note = ok, tally.count, " (plain: the card, every block)"
        else:
            blocks = plain_blocks(B)
            kk, op_out, pms = _blocks_of(ok, blocks), _value(pp, dev), 1e3 * sec
            skipped = round(skipped * B / len(blocks))
            note = f" (plain: CPU, {len(blocks)} of {B} blocks)"
        label = (f"[{B},{ash[1]},{ash[2]}]@[{B},{bsh[1]},{bsh[2]}] Kg={Kg}" if op == "gemm"
                 else f"[{','.join(map(str, ash))}] Kg={Kg}")
        err = max(_err(k, p) for k, p in zip(kk.words, op_out.words))
        check(err == 0.0, f"{name} {label}: kernel differs from plain (max {err})")
        parts = [[(l.numpy(), e.numpy()) for l, e in pa], [(l.numpy(), e.numpy()) for l, e in pb],
                 [(w.limbs.cpu().numpy(), w.exp.cpu().numpy()) for w in ok.words]]

        def val(i, idx):
            return mpmath.fsum(_mpf(l[(slice(None),) + idx], e[idx]) for l, e in parts[i])

        if op == "gemm":
            M, Kd, N = ash[1], ash[2], bsh[2]

            def spot(i):
                r = np.random.default_rng(500 + i)
                bi, mi, ni = r.integers(B), r.integers(M), r.integers(N)
                terms = [val(0, (bi, mi, t)) * val(1, (bi, t, ni)) for t in range(Kd)]
                return abs(val(2, (bi, mi, ni)) - mpmath.fsum(terms)) / \
                    mpmath.fsum(abs(t) for t in terms)
            slack, shape = 26, (B, M, Kd, N)
        else:
            def spot(i):
                r = np.random.default_rng(600 + i)
                idx = tuple(int(r.integers(d)) for d in ash)
                x, y = val(0, idx), val(1, idx)
                return abs(val(2, idx) - (x + y if op == "add" else x * y)) / \
                    (abs(x) + abs(y) if op == "add" else abs(x * y))
            slack, shape = 22, ash

        with mpmath.workprec(72 * Kg + 120):
            worst = max(spot(i) for i in range(20))
            check(worst < mpmath.mpf(2) ** -(72 * Kg - slack),
                  f"{name} {label}: spot check vs mpmath {worst}")
        ms = _time_ms(torch, lambda: kern(A, Bm))
        bound, by = kernel_bound(name, shape, Kg, True, skipped)
        rows.append((name, label + note, err, float(worst), ms, pms, bound, by, record))
        print(f"{name} {label}: {skipped} word TwoSums of the needed work left as they "
              f"were (words more than {24 * Kg} digits apart)")
    return rows


def wide3_phase(torch, mp, kernels, cli, dev, tasks):
    """Phase 17: three words (--precision 640, 3 x 9 float32 limbs) and
    classic K = 13.  (a) the three-word GEMM and (b) the classic K = 13
    GEMM, factor and solves against their plain versions; (c) the
    certificate to optimality at 640 bits in three words in the CLI's
    chunked loop; (d) the ladder at 640 bits, three words and classic
    K = 13, WIDE3_ITERATIONS + 1 iterations each in the host loop:
    identical steps, at least WIDE3_DIGITS shared digits; (e) the
    three-word ladder in the chunked loop in chunks of
    WIDE3_CHUNK against (d)'s host loop run, identical.  `tasks`:
    wide3_tasks'."""
    phase(f"17. three words (--precision 640, 3 x 9 float32 limbs) and classic K=13: "
          f"kernels, the certificate, the ladder ({WIDE3_ITERATIONS + 1} iterations), the "
          f"chunked loop in chunks of {WIDE3_CHUNK}")
    t0 = time.time()
    rows = wide3_kernel_rows(torch, kernels, dev, tasks[0])
    _print_rows([r[:8] for r in rows])
    crows = kernel_phase(torch, mp, kernels, dev, scaled=False, K=13, background=tasks[1])
    for name, shape, _, _, ms, _, bound, _ in crows:
        if name == "mp_matmul":
            shape = shape.split(" (")[0]
            print(f"classic K=13 GEMM {shape}: {ms:.3f} ms, {bound / ms:.1%} of its bound "
                  f"({bound:.4f} ms)")
    print(f"17a-b kernels: {time.time() - t0:.1f} s")
    t0 = time.time()
    cert = certificate_phase(torch, kernels, cli, dev, scaled=True, prec="640",
                             path=kernel_path(kernels, "wide3"))
    print(f"17c certificate: {time.time() - t0:.1f} s, graphs {cert['graphs']}")
    t0 = time.time()
    wide3 = _ladder_run(torch, kernels, cli, dev, list(WIDE3_PREC), WIDE3_ITERATIONS,
                        kernel_path(kernels, "wide3"))
    classic = _ladder_run(torch, kernels, cli, dev, list(CLASSIC13_PREC), WIDE3_ITERATIONS,
                          kernel_path(kernels, "classic"))
    digits, same_steps = _shared_digits(wide3, classic)
    print(f"three-word objectives agree with classic K=13 to {digits:.1f} significant "
          f"digits over {wide3['iterations']} iterations, step lengths identical in "
          f"{same_steps}; s/iteration three words {wide3['s_per_it']:.3f} vs classic "
          f"{classic['s_per_it']:.3f}; peak {wide3['peak_bytes'] / 2**30:.2f} vs "
          f"{classic['peak_bytes'] / 2**30:.2f} GiB; three-word GEMM launches "
          f"{wide3['launches']['mp_matmul_wide3']} in {wide3['iterations']} iterations")
    check(same_steps == wide3["iterations"] == classic["iterations"],
          f"step lengths differ from the classic run's ({same_steps} of "
          f"{wide3['iterations']} identical)")
    check(digits >= WIDE3_DIGITS,
          f"three-word objectives share only {digits:.1f} digits with classic")
    print(f"17d ladder: {time.time() - t0:.1f} s")
    t0 = time.time()
    chunked = _ladder_run(torch, kernels, cli, dev, list(WIDE3_PREC), WIDE3_ITERATIONS,
                          kernel_path(kernels, "wide3"), chunk_iterations=WIDE3_CHUNK)
    loops = _loops_agree(torch, "wide3", wide3, chunked, kernel_path(kernels, "wide3"))
    print(f"17e chunked loop: {time.time() - t0:.1f} s")
    return {"rows": rows, "classic_rows": crows, "certificate": cert, "ladder": wide3,
            "classic": classic, "digits": digits, "loops": loops}


def _sdp2input_task(files, source, precision, fmt, gens=()):
    """Background task of phase 18: in a temporary directory, the port's
    gen_pmp for each of `gens` ((file, seed, blocks, dim, dual, degree,
    poles), --solvable), `files` (name -> text) written, then the port's
    sdp2input of `source`.  (the zip's bytes, host seconds of gen_pmp, host
    seconds of sdp2input)."""
    from sdpb_tpu_torch.cli import sdp2input
    from sdpb_tpu_torch.tools import gen_pmp
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        tmp = Path(tmp)
        t0 = time.time()
        for name, seed, blocks, dim, dual, degree, poles in gens:
            gen_pmp.main(["--blocks", str(blocks), "--dim", str(dim), "--dual", str(dual),
                          "--degree", str(degree), "--poles", str(poles), "--seed", str(seed),
                          "--solvable", "-o", str(tmp / name)])
        t1 = time.time()
        for name, text in files.items():
            (tmp / name).write_text(text)
        sdp2input.main(["-i", str(tmp / source), "-o", str(tmp / "sdp.zip"), "--precision",
                        str(precision), "--outputFormat", fmt])
        return (tmp / "sdp.zip").read_bytes(), t1 - t0, time.time() - t1


def _study_kernel_task(K, Kf, B, S, N, blocks):
    """Background task of phase 18: the operands of 18c's kernel checks
    (from a fixed seed; the GEMM's at K limbs, the factor's, symmetric
    positive definite, and the solve's right-hand side at Kf) as float64
    limb stacks and, over `blocks`, the plain GEMM, factor and lower solve
    (with the plain factor, which the kernel's matches bit for bit):
    ((a, b, spd, rhs), [(parts, CPU seconds)] in that order)."""
    import numpy as np
    import torch
    from sdpb_tpu_torch.ops import kernels, mpfloat as mp
    rng = np.random.default_rng(18)
    ops = (_limbs(rng, (B, N, S), K), _limbs(rng, (B, S, N), K),
           _limbs(rng, (B, S, S), Kf, spd=True), _limbs(rng, (B, S, N), Kf))
    a, b, spd, rhs = (_blocks_of(mp.MP(torch.as_tensor(x)), blocks) for x in ops)
    out = []
    for fn, args in ((kernels.mp_matmul_plain, (a, b)), (kernels.mp_cholesky_plain, (spd,))):
        t0 = time.time()
        r = fn(*args)
        out.append((_parts(r), time.time() - t0))
    t0 = time.time()
    x = kernels.mp_solve_triangular_plain(r, rhs, True)
    out.append((_parts(x), time.time() - t0))
    return ops, out


def study_tasks(background):
    """Phase 18's host work, submitted to the background pool at the start:
    the conversions (18a's two, 18b's toy, 18c's generated problem) and
    18c's plain kernel versions."""
    ladder = json.loads(LADDER_PMP.read_text())
    ladder["PositiveMatrixWithPrefactorArray"] = ladder["PositiveMatrixWithPrefactorArray"][:2]
    nsv = "".join(g[0] + "\0" for g in STUDY_GEN)
    return {
        "certificate": background.submit(_sdp2input_task, {"pmp.json": CERTIFICATE_PMP.read_text()},
                                         "pmp.json", 400, "json"),
        "ladder": background.submit(_sdp2input_task, {"two.json": json.dumps(ladder)},
                                    "two.json", 256, "bin"),
        "toy": background.submit(_sdp2input_task, {"toy.json": json.dumps(TOY_PMP)},
                                 "toy.json", 512, "json"),
        "generated": background.submit(_sdp2input_task, {"study.nsv": nsv}, "study.nsv",
                                       int(STUDY_PREC), "bin", STUDY_GEN),
        "kernels": background.submit(_study_kernel_task, STUDY_K, STUDY_KF, STUDY_B, STUDY_S,
                                     STUDY_N, plain_blocks(STUDY_B)),
    }


def study_phase(torch, mp, kernels, cli, dev, tasks):
    """Phase 18: a bootstrap study on the port alone (see the docstring)."""
    phase("18. a bootstrap study on the port alone: sdp2input against the committed "
          "fixtures, PMP -> card -> spectrum, a generated problem with 150 x 150 S blocks")
    import mpmath
    from sdpb_tpu_torch.cli import spectrum
    from sdpb_tpu_torch.io.sdp_zip import entries
    t_phase = time.time()
    host_s = {}
    # 18a: the converter against the committed fixtures, byte for byte
    for label, fixture, names in (("certificate", CERTIFICATE, None),
                                  ("ladder", LADDER, ["objectives.json"] + [
                                      f"block_{kind}_{j}.{ext}" for j in (0, 1)
                                      for kind, ext in (("info", "json"), ("data", "bin"))])):
        data, _, host_s[label] = tasks[label].result()
        mine, ref = entries(data), entries(fixture)
        names = names or list(ref)
        check(list(mine) == names if label == "certificate" else set(names) <= set(mine),
              f"18a {label}: entries {list(mine)} against {list(ref)}")
        bad = [n for n in names if mine.get(n) != ref[n]]
        check(not bad, f"18a {label}: {bad} differ from {fixture.relative_to(ROOT)}")
        print(f"18a {label}: {len(names)} entries byte for byte with "
              f"{fixture.relative_to(ROOT)} (host seconds of sdp2input: {host_s[label]:.1f})")
    # 18b: the toy PMP -> the card -> spectrum
    data, _, host_s["toy"] = tasks["toy"].result()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "toy.json").write_text(json.dumps(TOY_PMP))
        (tmp / "sdp.zip").write_bytes(data)
        kernels.reset_launches()
        t0 = time.time()
        toy = cli.run(["-s", str(tmp / "sdp.zip"), "-o", str(tmp / "out"), "-c",
                       str(tmp / "ck"), "--device", str(dev), *TOY_FLAGS])
        solve_s = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        check(str(toy.terminate_reason) == "found primal-dual optimal solution",
              f"18b: the toy's solve ended with {toy.terminate_reason}")
        check(all(launches[kernels.counter(n, False)] > 0 for n in kernels.KERNEL_NAMES),
              f"18b: a kernel did not run: {launches}")
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            spectrum.main(["--input", str(tmp / "toy.json"), "--solution", str(tmp / "out"),
                           "--precision", "96", "--threshold", "1e-8", "--format", "PMP",
                           "--output", str(tmp / "spectrum.json")])
        host_s["spectrum"] = time.time() - t0
        doc = json.loads((tmp / "spectrum.json").read_text())
    check(len(doc) == 1 and len(doc[0]["zeros"]) == 1, f"18b: spectrum {doc}")
    with mpmath.workprec(200):
        zero = mpmath.mpf(doc[0]["zeros"][0]["zero"])
        dz = abs(zero - mpmath.mpf(STUDY_X0))
    check(dz < mpmath.mpf(STUDY_X0_TOL), f"18b: the zero {zero} is {dz} from x0")
    print(f"18b toy: sdp2input 512 bits (host seconds {host_s['toy']:.1f}); solve on the card "
          f"(classic, 96 bits, chunked loop): {toy.terminate_reason} after {toy.iterations} "
          f"iterations in {solve_s:.1f} s, launches {launches}; spectrum (host seconds "
          f"{host_s['spectrum']:.2f}): zero {mpmath.nstr(zero, 20)}, |zero - x0| = "
          f"{mpmath.nstr(dz, 3)}, lambda {doc[0]['zeros'][0].get('lambda')}")
    # 18c: the generated problem, its shapes, its chunked solve on the card
    data, gen_s, host_s["generated"] = tasks["generated"].result()
    with tempfile.TemporaryDirectory() as tmp:
        sdp = Path(tmp) / "study.zip"
        sdp.write_bytes(data)
        infos = [json.loads(v) for n, v in sorted(entries(data).items())
                 if n.startswith("block_info_")]
        points = sorted({i["num_points"] for i in infos})
        sizes = sorted({i["num_points"] * i["dim"] * (i["dim"] + 1) // 2 for i in infos})
        check(points == [19, 25] and sizes == [57, 150] and len(infos) == 8,
              f"18c: blocks {infos}")
        print(f"18c generated: gen_pmp (host seconds {gen_s:.2f}) + sdp2input {STUDY_PREC} bits "
              f"(host seconds {host_s['generated']:.1f}): {len(infos)} blocks, points {points}, "
              f"S sizes {sizes}")
        run = _ladder_run(torch, kernels, cli, dev, ["--precision", STUDY_PREC],
                          STUDY_ITERATIONS, kernel_path(kernels, "classic"),
                          chunk_iterations=STUDY_CHUNK, sdp=sdp)
    res = run["result"]
    (kf, info), = res.graphs.items()
    replays = sum(n for _, n, _ in res.chunks)
    per = info["launches_per_replay"]
    print(f"18c solve: {run['iterations']} iterations, {run['s_per_it']:.4f} s/replay "
          f"(each {' '.join(f'{dt / n:.4f}' for _, n, dt in res.chunks)}); graphs (factor "
          f"{kf} limbs) warm-up {info['warmup_s']:.2f} s, capture {info['capture_s']:.2f} s, "
          f"instantiate {info['instantiate_s']:.2f} s; peak device memory "
          f"{run['peak_bytes'] / 2**30:.2f} GiB; launches per replay {per} ({replays} replays "
          f"+ the warm-up: {run['launches']})")
    print("18c wrapper calls by shape (the eager warm-up and the capture): " + "; ".join(
        f"{_call_label(k)}: {v}" for k, v in sorted(run["tally"].items(),
                                                     key=lambda kv: _call_label(kv[0]))))
    # the kernels at the S shape of 150, as 18c launched them, held to their
    # plain versions
    check(kf == STUDY_KF, f"18c factored at {kf} limbs, its kernel checks at {STUDY_KF}")
    (a, b, spd, rhs), plains = tasks["kernels"].result()
    A, Bm, P, R = (mp.MP(torch.as_tensor(x, device=dev)) for x in (a, b, spd, rhs))
    B, S, N, K, Kf = STUDY_B, STUDY_S, STUDY_N, STUDY_K, STUDY_KF
    blocks = plain_blocks(B)
    L = kernels.mp_cholesky(P)
    rows, queued = [], []
    for (name, shape, k, key, label, fn), (parts, sec) in zip((
            ("mp_matmul", (B, N, S, N), K, ((B, N, S), (B, S, N), None),
             f"[{B},{N},{S}]@[{B},{S},{N}] K={K}", lambda: kernels.mp_matmul(A, Bm)),
            ("mp_cholesky", (B, S), Kf, ((B, S, S), (), None), f"[{B},{S},{S}] K={Kf}",
             lambda: kernels.mp_cholesky(P)),
            ("mp_solve_triangular", (B, S, N), Kf, ((B, S, S), (B, S, N), True),
             f"[{B},{S},{S}]\\[{B},{S},{N}] lower K={Kf}",
             lambda: kernels.mp_solve_triangular(L, R, True))), plains):
        calls = run["tally"].get((name, "classic", k) + key, 0)
        check(calls > 0, f"18c did not call {name} {label}")
        out = fn()
        err = _err(_blocks_of(out, blocks), _value(parts, dev))
        check(err == 0.0, f"18c {name} {label}: kernel differs from plain (max {err})")
        ms = _time_ms(torch, fn)
        bound, by = kernel_bound(name, shape, k, False)
        rows.append((name, f"{label} (plain: CPU, blocks {blocks}; 18c's warm-up and capture "
                           f"called it {calls} times)", err, 0.0, ms, 1e3 * sec, bound, by))
        queued.append(_queued_ms(torch, fn))
    _print_rows(rows)
    print("queued (the wrappers' host time hidden behind a spin): " + ", ".join(
        f"{r[0]} {q:.4f} ms, {r[6] / q:.1%} of its bound" for r, q in zip(rows, queued)))
    seconds = time.time() - t_phase
    print(f"phase 18: {seconds:.1f} s (host seconds of the conversions, in the background "
          f"pool: " + ", ".join(f"{k} {v:.1f}" for k, v in host_s.items()) + ")")
    return {"seconds": seconds, "host_s": host_s, "zero": float(zero),
            "toy_iterations": toy.iterations, "run": run, "rows": rows, "queued": queued}


# ---------------------------------------------------------------------------
# Phase 19: runs of several processes and the reference's binary checkpoint

# the digits the objectives must share: 19b's two ranks with phase 6's one
# process (the gathered sums add the blocks in another order, K = 5 carries
# ~80 digits), and 19c's resume from BigFloats of 216 bits (~65 digits)
# with phase 15's resume from the npz file
MULTI_DIGITS, REFERENCE_DIGITS = 50, 50


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _bigfloat(limbs, precision: int, record) -> bytes:
    """One El::BigFloat image of the exact sum of float64 limbs, rounded
    to `precision` bits (ties to even), as MPFR holds it: the significand
    left-aligned in ceil(precision / 64) words, least significant first."""
    parts = [math.frexp(f) for f in limbs if f != 0.0]
    if not parts:
        return record.pack(precision, 1, -(1 << 63) + 2, bytes(record.size - 20))
    emin = min(e for _, e in parts) - 53
    M = sum(int(m * 2.0 ** 53) << (e - 53 - emin) for m, e in parts)
    sign, M = (-1 if M < 0 else 1), abs(M)
    drop = M.bit_length() - precision
    if drop > 0:
        low, M, emin = M & ((1 << drop) - 1), M >> drop, emin + drop
        if low > 1 << (drop - 1) or (low == 1 << (drop - 1) and M & 1):
            M += 1
    nbits = 8 * (record.size - 20)
    return record.pack(precision, sign, M.bit_length() + emin,
                       (M << (nbits - M.bit_length())).to_bytes(nbits // 8, "little"))


def write_reference_checkpoint(directory, blocks: dict, y, precision: int, ranks=(0,),
                               record_precision: bool = True) -> int:
    """A reference binary checkpoint (save_checkpoint.cxx:11-35) of
    per-block float64 limb stacks {block index: {"x": [K, P], "X_even":
    [K, n, n], ...}} (io/solution.py::host_blocks) and y [K, N]: x, X (even,
    odd), y, Y in block-index order, each block [int64 rows, int64 cols]
    and its elements ROW-MAJOR (the row outer), each a BigFloat of
    `precision` bits; the same bytes as checkpoint_0_<rank> for each of
    `ranks`, and a checkpoint.json naming generation 0 and, with
    record_precision, the precision.  Returns a file's bytes."""
    import struct
    record = struct.Struct(f"<qiq{8 * -(-precision // 64)}s")
    out = bytearray()

    def block(limbs):                        # [K, rows, cols]
        out.extend(struct.pack("<qq", *limbs.shape[1:]))
        for value in limbs.reshape(limbs.shape[0], -1).T.tolist():   # row-major
            out.extend(_bigfloat(value, precision, record))

    order = sorted(blocks)
    for i in order:
        block(blocks[i]["x"][:, :, None])
    for mat in ("X", "Y"):
        if mat == "Y":
            block(y[:, :, None])
        for i in order:
            for parity in ("even", "odd"):
                block(blocks[i][f"{mat}_{parity}"])
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for rank in ranks:
        (directory / f"checkpoint_0_{rank}").write_bytes(bytes(out))
    options = {"precision": precision} if record_precision else {}
    (directory / "checkpoint.json").write_text(json.dumps({"current": 0, "options": options}))
    return len(out)


def _rank_task(rank, world, ports, host, argv):
    """Phase 19b: one rank of a CLI run of `world` processes on the card,
    its SDP the parent's parse: first the CLI's default, the chunked loop,
    which must refuse (ranks that share a card reduce over gloo, whose
    collectives a CUDA graph cannot capture), then the host loop.  Returns
    the refusal, the run's history, seconds, the launches of its kernels
    (counted from 0) and how often it wrote the solution."""
    from sdpb_tpu_torch.cli import sdpb as cli
    from sdpb_tpu_torch.io import sdp_zip, solution
    from sdpb_tpu_torch.ops import kernels
    sdp_zip.read_sdp = lambda path, K, np_dtype=None: host
    writes, save = [], solution.save_solution
    solution.save_solution = lambda *a, **k: (writes.append(1), save(*a, **k))[1]
    flags = [["--coordinator", f"127.0.0.1:{p}", "--numProcesses", str(world),
              "--processId", str(rank)] for p in ports]
    try:
        cli.run(argv + flags[0])
        refusal = None
    except RuntimeError as e:
        refusal = str(e)
    kernels.reset_launches()
    t0 = time.time()
    res = cli.run(argv + flags[1], chunk_iterations=1)
    return {"refusal": refusal, "history": res.history, "reason": str(res.terminate_reason),
            "seconds": res.iteration_seconds, "wall": time.time() - t0,
            "launches": dict(kernels.LAUNCHES), "writes": len(writes)}


def multiprocess_phase(torch, kernels, cli, dev, smi, chunked, host, checkpoints):
    """Phase 19: (a) phase 14's classic chunked ladder run again at world
    size 1 through an NCCL group (its all-gathers captured in the graphs),
    held to phase 14 bit for bit; (b) two ranks on the card through the
    CLI's --coordinator/--numProcesses/--processId in two processes (gloo,
    the host loop), LADDER_ITERATIONS, objectives within MULTI_DIGITS of
    phase 6's one-process run, out.txt written once, and the world-2
    checkpoint resumed at world 1 for 1 iteration; (c) phase 15's classic
    state as a reference binary checkpoint (row-major BigFloats of 216
    bits) resumed through --initialCheckpointDir, held to phase 15's resume
    from the npz file within REFERENCE_DIGITS."""
    phase("19. runs of several processes and the reference's binary checkpoint: "
          "(a) world 1 over NCCL, (b) two ranks on the card over gloo, (c) a reference "
          "checkpoint resumed")
    from sdpb_tpu_torch.io import sdp_zip
    from sdpb_tpu_torch.solver.step import state_tensors
    t_phase = time.time()
    prec = list(LADDER_PREC["classic"])
    path = kernel_path(kernels, "classic")
    # (a) the chunked ladder through a group of one rank: NCCL in graphs
    flags = ["--coordinator", f"127.0.0.1:{_free_port()}", "--numProcesses", "1",
             "--processId", "0"]
    a = _ladder_run(torch, kernels, cli, dev, prec + flags, LADDER_ITERATIONS, path,
                    chunk_iterations=LADDER_ITERATIONS + 1)
    mine, ref = a["result"], chunked["result"]
    diffs = [(i + 1, f) for i, (x, y) in enumerate(zip(ref.history, mine.history))
             for f in x._fields if _stat_bits(getattr(x, f)) != _stat_bits(getattr(y, f))]
    check(len(mine.history) == len(ref.history) and not diffs and
          str(mine.terminate_reason) == str(ref.terminate_reason),
          f"19a: world 1 over NCCL differs from phase 14: {diffs[:8]}")
    # a run with a group returns the state gathered on the host
    check(all(torch.equal(p, q.cpu()) for p, q in zip(state_tensors(mine.state),
                                                      state_tensors(ref.state))),
          "19a: the final state differs from phase 14's")
    (_, info), = mine.graphs.items()
    (_, info14), = ref.graphs.items()
    print(f"(a) world 1 over NCCL: {len(mine.history)} iterations and the final state bit "
          f"for bit phase 14's; graphs A+B nodes {info['nodes']} (kernels "
          f"{info['kernel_nodes']}) against phase 14's {info14['nodes']} "
          f"({info14['kernel_nodes']}); capture {info['capture_s']:.2f} s, instantiate "
          f"{info['instantiate_s']:.2f} s; s/replay {a['s_per_it']:.4f} against "
          f"{chunked['s_per_it']:.4f}; card {smi}")

    # (b) two ranks that share the card: gloo, the host loop
    K = cli.limbs_for_precision(int(prec[1]))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        argv = ["-s", str(LADDER), "-o", str(tmp / "out"), "-c", str(tmp / "w2"),
                "--device", "cuda", *prec, *LADDER_FLAGS, "--timingRun", "never",
                "--maxIterations", str(LADDER_ITERATIONS), "--verbosity", "0"]
        t0 = time.time()
        ports, parsed = (_free_port(), _free_port()), sdp_zip.read_sdp(LADDER, K)
        with _pool(2) as ranks:
            futures = [ranks.submit(_rank_task, r, 2, ports, parsed, argv) for r in (0, 1)]
            outs = [f.result() for f in futures]
        wall = time.time() - t0
        check(all(o["refusal"] and "cannot be captured" in o["refusal"] for o in outs),
              f"19b: the chunked loop over gloo on the card did not refuse: "
              f"{[o['refusal'] for o in outs]}")
        check([o["writes"] for o in outs] == [1, 0] and (tmp / "out" / "out.txt").exists(),
              f"19b: the solution was written {[o['writes'] for o in outs]} times")
        check(all(_stat_bits(x) == _stat_bits(y) for p, q in zip(outs[0]["history"],
                                                                  outs[1]["history"])
                  for x, y in zip(p, q)) and len(outs[0]["history"]) == len(host["history"]),
              "19b: the ranks' statistics differ, or their count from phase 6's")
        check(all(o["launches"][n] > 0 for o in outs for n in path),
              f"19b: a kernel of the path did not run on a rank: {[o['launches'] for o in outs]}")
        digits, same_steps = _shared_digits({"history": outs[0]["history"]}, host)
        check(digits >= MULTI_DIGITS, f"19b: objectives share only {digits:.1f} digits with "
                                      f"phase 6's one process")
        resumed = cli.run(["-s", str(LADDER), "-o", str(tmp / "out1"), "-c", str(tmp / "w1"),
                           "-i", str(tmp / "w2"), "--device", str(dev), *prec, *LADDER_FLAGS,
                           "--timingRun", "never", "--maxIterations", "1", "--verbosity", "0"],
                          chunk_iterations=1)
        back, _ = _shared_digits({"history": resumed.history[:1]},
                                 {"history": outs[0]["history"][-1:]})
        check(back >= MULTI_DIGITS, f"19b: the world-1 resume of the world-2 checkpoint "
                                    f"shares only {back:.1f} digits with its last iteration")
    steady = statistics.median(outs[0]["seconds"][1:])
    print(f"(b) two ranks on one card over gloo: the chunked loop refused ("
          f"{outs[0]['refusal'][:90]}...); the host loop: {outs[0]['reason']} after "
          f"{len(outs[0]['history'])} iterations, statistics identical on both ranks, "
          f"objectives within {digits:.1f} digits of phase 6's one process (steps identical in "
          f"{same_steps}); out.txt written once; steady {steady:.3f} s/iteration against "
          f"phase 6's {host['s_per_it']:.3f}, wall {wall:.1f} s for the two processes (rank 0's "
          f"run {outs[0]['wall']:.1f} s); launches rank 0 "
          f"{ {n: outs[0]['launches'][n] for n in path} }, rank 1 "
          f"{ {n: outs[1]['launches'][n] for n in path} }; the world-2 checkpoint resumed at "
          f"world 1 ({resumed.terminate_reason}), its first iteration within {back:.1f} digits "
          f"of the world-2 run's last; card {smi}")

    # (c) phase 15's classic state as a reference binary checkpoint
    from sdpb_tpu_torch.io.solution import host_blocks
    from sdpb_tpu_torch.models.sdp import build_device_sdp
    from sdpb_tpu_torch.ops import mpfloat as mp
    c15 = checkpoints["classic"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        sdp = build_device_sdp(sdp_zip.read_sdp(LADDER, K), dev)
        t0 = time.time()
        nbytes = write_reference_checkpoint(tmp / "ref", host_blocks(sdp, c15["state"]),
                                            mp.host_f64_limbs(c15["state"].y), int(prec[1]))
        write_s = time.time() - t0
        text = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(text):
            res = cli.run(["-s", str(LADDER), "-o", str(tmp / "out"), "-c", str(tmp / "ck"),
                           "-i", str(tmp / "ref"), "--device", str(dev), *prec, *LADDER_FLAGS,
                           "--timingRun", "never", "--maxIterations", str(RESUME_ITERATIONS)],
                          chunk_iterations=CHECKPOINT_CHUNK)
        run_s = time.time() - t0
    check("Loading reference binary checkpoint from" in text.getvalue(),
          "19c: the CLI did not load the reference checkpoint")
    npz = c15["resumed"]
    check(len(res.history) == len(npz.history) and
          str(res.terminate_reason) == str(npz.terminate_reason),
          f"19c: {len(res.history)} iterations, {res.terminate_reason}, against the npz "
          f"resume's {len(npz.history)}, {npz.terminate_reason}")
    ref_digits, _ = _shared_digits({"history": res.history}, {"history": npz.history})
    check(ref_digits >= REFERENCE_DIGITS, f"19c: the reference-checkpoint resume shares only "
                                          f"{ref_digits:.1f} digits with the npz resume")
    seconds = time.time() - t_phase
    print(f"(c) phase 15's classic state as a reference binary checkpoint ({nbytes} bytes, "
          f"written in {write_s:.2f} s): resumed for {len(res.history)} iterations "
          f"({run_s:.1f} s with the load), objectives within {ref_digits:.1f} digits of the "
          f"npz resume's")
    print(f"phase 19: {seconds:.1f} s")
    return {"seconds": seconds, "nodes": info["nodes"], "nodes14": info14["nodes"],
            "digits": digits, "back": back, "ref_digits": ref_digits, "wall": wall,
            "steady": steady}


def classic_limbs_diagnostic(torch, mp, kernels, dev, Ks):
    """--classic-limbs: the classic kernels at each K in Ks against their
    plain versions at phase 4's shapes (kernel_phase)."""
    phase(f"classic kernels at K={Ks} against plain versions (phase 4's shapes)")
    t0 = time.time()
    kernels.build(Ks, representations=(False,), wide_Ks=(), probe=False, wide3_Ks=())
    print(f"build: {time.time() - t0:.1f} s")
    for K in Ks:
        kernel_phase(torch, mp, kernels, dev, scaled=False, K=K)


def digits_diagnostic(torch, kernels, cli, dev, groups=("640", "400")):
    """--digits [640] [400]: the ladder in the host loop.  At --precision
    640 (WIDE3_ITERATIONS + 1 iterations): classic K = 13 with 2
    refinement passes (Kf = 7, the default) and none (Kf = 13), three words
    with the port's 4 passes and the JAX package's rule's 3.  At
    --precision 400 (WIDE_ITERATIONS + 1 iterations): classic K = 8 with 2
    passes (Kf = 5, the default) and none (Kf = 8), classic K = 13 at
    --precision 640 (a reference that resolves more digits than K = 8 has),
    two words of 9 with the port's 3 passes and the JAX rule's 2.  Prints
    the digits each run shares with each classic run before it, and the
    ladder's s/replay in the chunked loop (chunks of WIDE3_CHUNK,
    WIDE3_ITERATIONS + 1 iterations) in three words at 4 and 3 passes and
    in two words at 3 and 2.  The JAX rule, ceil(K / Kf), is put in place of
    solver/params.py::refinement_passes for the runs that name it."""
    from sdpb_tpu_torch.solver import solve
    phase(f"digits: the ladder at --precision {' and '.join(groups)} by refinement passes")
    t0 = time.time()
    kernels.build([5, 7, 8, 9, 13], wide_Ks=(9,), probe=False,
                  wide3_Ks=(9,) if "640" in groups else ())
    print(f"build: {time.time() - t0:.1f} s")
    port_rule = solve.refinement_passes

    def jax_rule(K, kf, scaled):
        return 0 if K <= kf else -(-K // kf)

    wide = LADDER_PREC["wide"]
    runs = {
        "640": (WIDE3_ITERATIONS, (
            ("classic K=13, Kf=7 (2 passes)", CLASSIC13_PREC, "classic", False),
            ("classic K=13, Kf=13 (none)", CLASSIC13_PREC + ("--factorLimbs", "13"), "classic",
             False),
            ("three words 3x9, Kf=9 (4 passes)", WIDE3_PREC, "wide3", False),
            ("three words 3x9, Kf=9, the JAX rule (3 passes)", WIDE3_PREC, "wide3", True))),
        "400": (WIDE_ITERATIONS, (
            ("classic K=8, Kf=5 (2 passes)", ("--precision", "400"), "classic", False),
            ("classic K=8, Kf=8 (none)", ("--precision", "400", "--factorLimbs", "8"),
             "classic", False),
            ("classic K=13 at --precision 640, Kf=7 (2 passes)", CLASSIC13_PREC, "classic",
             False),
            ("two words 2x9, Kf=9 (3 passes)", wide, "wide", False),
            ("two words 2x9, Kf=9, the JAX rule (2 passes)", wide, "wide", True)))}
    replays = {"640": ("three-word", WIDE3_PREC, "wide3", ("4 passes", "3 passes")),
               "400": ("two-word", wide, "wide", ("3 passes", "2 passes"))}
    try:
        for group in groups:
            iterations, todo = runs[group]
            got = {}
            for label, prec, path, jax in todo:
                solve.refinement_passes = jax_rule if jax else port_rule
                print(f"{label}:")
                got[label] = _ladder_run(torch, kernels, cli, dev, list(prec), iterations,
                                         kernel_path(kernels, path))
            labels = list(got)
            for i, mine in enumerate(labels):
                for ref in labels[:i]:
                    if not ref.startswith("classic"):
                        continue
                    digits, same = _shared_digits(got[mine], got[ref])
                    print(f"{mine} against {ref}: {digits:.1f} digits shared over "
                          f"{got[mine]['iterations']} iterations, step lengths identical in "
                          f"{same}")
        for group in groups:
            name, prec, path, (port, jax) = replays[group]
            replay = {}
            for label, rule in ((port, port_rule), (f"the JAX rule, {jax}", jax_rule)):
                solve.refinement_passes = rule
                run = _ladder_run(torch, kernels, cli, dev, list(prec), WIDE3_ITERATIONS,
                                  kernel_path(kernels, path), chunk_iterations=WIDE3_CHUNK)
                replay[label] = run["s_per_it"]
            extra = replay[port] - replay[f"the JAX rule, {jax}"]
            print(f"{name} ladder in the chunked loop, s/replay: "
                  + ", ".join(f"{lb} {v:.3f}" for lb, v in replay.items())
                  + f"; the last pass costs {extra:.3f} s a replay")
    finally:
        solve.refinement_passes = port_rule


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch port on one "
                                             "CUDA card (no arguments: every phase).")
    ap.add_argument("--classic-limbs", type=int, nargs="+", metavar="K",
                    help="only hold the classic kernels at these limb counts to their "
                         "plain versions")
    ap.add_argument("--digits", nargs="*", choices=("640", "400"),
                    help="only the ladder's digits by refinement passes (at 640 and 400 "
                         "bits, or those named)")
    args = ap.parse_args(argv)
    if not (ROOT / "sdpb_tpu_torch").is_dir() or not all(
            f.exists() for f in (LADDER, CERTIFICATE, LADDER_PERTURBED, LADDER_PMP,
                                 CERTIFICATE_PMP, LADDER_OUTER) + STUDY_FIXTURES):
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
    from sdpb_tpu_torch.io import sdp_zip
    from sdpb_tpu_torch.ops import kernels, mpfloat as mp
    diagnostic = args.classic_limbs or args.digits is not None
    if diagnostic:
        sdp_zip.read_sdp = _SdpReads(sdp_zip.read_sdp, ())
    else:
        sdp_zip.read_sdp = _SdpReads(sdp_zip.read_sdp, SDP_READS)
    atexit.register(sdp_zip.read_sdp.close)

    t_start = time.time()
    smi = device_phase(torch)
    if diagnostic:
        if args.classic_limbs:
            classic_limbs_diagnostic(torch, mp, kernels, dev, args.classic_limbs)
        if args.digits is not None:
            digits_diagnostic(torch, kernels, cli, dev, tuple(args.digits) or ("640", "400"))
        print(f"\ndiagnostics: {time.time() - t_start:.1f} s")
        print(smi)
        return 0
    # the background pool: the later builds, then the kernel phases' CPU
    # work (operands, plain versions on a few blocks)
    background = _pool(BACKGROUND_WORKERS + len(LATER_LIBS), low=True)
    atexit.register(background.shutdown, cancel_futures=True)
    build_s, (wait_mid, wait_late) = build_phase(kernels, background)
    tasks10, tasks17 = wide_tasks(background), wide3_tasks(background, kernels)
    tasks18 = study_tasks(background)
    exactness_phase(torch, mp, kernels, dev)
    rows = kernel_phase(torch, mp, kernels, dev, scaled=False)
    cert = certificate_phase(torch, kernels, cli, dev, scaled=False)
    ladder = ladder_phase(torch, kernels, cli, dev, scaled=False)
    srows = kernel_phase(torch, mp, kernels, dev, scaled=True)
    scert = certificate_phase(torch, kernels, cli, dev, scaled=True)
    sladder = ladder_phase(torch, kernels, cli, dev, scaled=True, classic=ladder)
    print(f"\nwaited {wait_mid():.1f} s for the libraries of phases 10-16")
    wrows = wide_kernel_phase(torch, kernels, dev, tasks10)
    wladder = wide_ladder_phase(torch, kernels, cli, dev)
    prows = probe_phase(torch, kernels, dev, smi)
    profiles, probe_launches = profile_phase(torch, kernels, cli, dev, {"wide": wladder})
    chunked = chunked_phase(torch, kernels, cli, dev,
                            {"classic": ladder, "scaled": sladder, "wide": wladder})
    outer_limits = outer_limits_start(dev)
    checkpoints = checkpoint_phase(torch, mp, kernels, cli, dev,
                                   chunked["wide"]["chunked"]["result"].state, smi)
    tools = tools_phase(torch, mp, kernels, cli, dev, smi, outer_limits)
    print(f"\nwaited {wait_late():.1f} s for the libraries of phase 17")
    wide3 = wide3_phase(torch, mp, kernels, cli, dev, tasks17)
    study = study_phase(torch, mp, kernels, cli, dev, tasks18)
    background.shutdown()
    multi = multiprocess_phase(torch, kernels, cli, dev, smi, chunked["classic"]["chunked"],
                               ladder, checkpoints)
    check("jax" not in sys.modules, "the port imported jax")
    check(not any(m == "sdpb_tpu" or m.startswith("sdpb_tpu.") for m in sys.modules),
          "the port imported the JAX package")

    record = []
    # launches on the main path: the chunked ladder runs of phase 14
    for scaled, krows, run in ((False, rows, chunked["classic"]["chunked"]),
                               (True, srows, chunked["scaled"]["chunked"])):
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
    name, source, replaces = WIDE_KERNEL
    # the GEMM rows come first, in WIDE_GEMM_ROWS' order
    first = wrows[WIDE_GEMM_ROWS.index(WIDE_RECORD_ROW)]
    record.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                   "launches": chunked["wide"]["chunked"]["launches"][name],
                   "max_abs_err": max(r[2] for r in wrows if r[0] == name), "ms": first[4],
                   "plain_ms": first[5], "bound_ms": first[6], "bound_by": first[7],
                   "library_ms": None})
    # the three-word kernels at Kg = 9, their launches those of phase 17's
    # chunked ladder run (the main path at --precision 640)
    for name, (source, replaces) in WIDE3_KERNELS.items():
        mine = [r for r in wide3["rows"] if r[0] == name]
        first = [r for r in mine if r[8]][0]
        record.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces,
                       "launches": wide3["loops"]["chunked"]["launches"][name],
                       "max_abs_err": max(r[2] for r in mine), "ms": first[4],
                       "plain_ms": first[5], "bound_ms": first[6], "bound_by": first[7],
                       "library_ms": None})
    name, source, replaces = PROBE_KERNEL
    _, _, _, _, ms, pms, bound, by = prows[0]
    record.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                   "launches": probe_launches, "max_abs_err": max(r[2] for r in prows),
                   "ms": ms, "plain_ms": pms, "bound_ms": bound, "bound_by": by,
                   "library_ms": None})
    wc = wladder["classic"]
    print(f"\nsummary: build {build_s:.1f} s; certificate {cert['iterations']} "
          f"iterations classic, {scert['iterations']} scaled; ladder "
          f"{ladder['s_per_it']:.3f} s/iteration classic (K=5), "
          f"{sladder['s_per_it']:.3f} scaled (K=9); peak "
          f"{ladder['peak_bytes'] / 2**30:.2f} / {sladder['peak_bytes'] / 2**30:.2f} GiB; "
          f"objectives shared to {sladder['digits']:.1f} digits; at 400 bits "
          f"{wladder['s_per_it']:.3f} s/iteration wide (2x9) vs {wc['s_per_it']:.3f} "
          f"classic (K=8), peak {wladder['peak_bytes'] / 2**30:.2f} / "
          f"{wc['peak_bytes'] / 2**30:.2f} GiB, {wladder['digits']:.1f} digits shared, "
          f"wide GEMM launches {wladder['launches']['mp_matmul_wide']} in "
          f"{wladder['iterations']} iterations; CUDA-core rates {prows[0][3]:.4e} float32, "
          f"{prows[1][3]:.4e} float64 per s; profiler iterations "
          + ", ".join(f"{lb} {profiles[lb]['iteration_ms']:.1f} ms" for lb, _, _ in PROFILES)
          + "; ladder s/iteration host loop -> chunked "
          + ", ".join(f"{lb} {c['host']['s_per_it']:.3f} -> {c['chunked']['s_per_it']:.3f}"
                      for lb, c in chunked.items())
          + "; checkpoints " + ", ".join(f"{lb} {c['bytes']} bytes (save {c['save_s']:.2f} s, "
                                         f"load {c['load_s']:.2f} s)"
                                         for lb, c in checkpoints.items() if lb != "timing")
          + f"; timing run {checkpoints['timing']['wall_s']:.1f} s"
          + f"; approx_objective setup " + ", ".join(
              f"{lb} {a['timings']['frozen_s']:.2f} s" for lb, a in tools["approx"].items())
          + f", quadratic error {tools['quad_err']:.3e} (linear {tools['lin_err']:.3e}); "
          f"outer_limits certificate {tools['outer']['certificate']['seconds']:.1f} s, "
          f"ladder {OUTER_BLOCKS} blocks {tools['outer']['ladder']['seconds']:.1f} s"
          + f"; at 640 bits the certificate optimal in "
          f"{wide3['certificate']['iterations']} iterations ({wide3['certificate']['seconds']:.1f}"
          f" s), the ladder {wide3['ladder']['s_per_it']:.3f} s/iteration three words "
          f"(3x9) vs {wide3['classic']['s_per_it']:.3f} classic (K=13), {wide3['digits']:.1f} "
          f"digits shared, chunked {wide3['loops']['chunked']['s_per_it']:.3f} s/replay"
          + f"; bootstrap study (phase 18) {study['seconds']:.1f} s: the toy's zero "
          f"{study['zero']:.12f} after {study['toy_iterations']} iterations, the generated "
          f"problem {study['run']['s_per_it']:.4f} s/replay, the GEMM (K={STUDY_K}), factor and "
          f"solve (K={STUDY_KF}) at n=150 at "
          + ", ".join(f"{r[6] / r[4]:.1%}" for r in study["rows"]) + " of their bounds"
          + f"; runs of several processes (phase 19) {multi['seconds']:.1f} s: world 1 over "
          f"NCCL bit for bit phase 14's (graph nodes {multi['nodes']} against "
          f"{multi['nodes14']}), two ranks on the card {multi['steady']:.3f} s/iteration, "
          f"{multi['digits']:.1f} digits shared with one process, a reference checkpoint "
          f"resumed within {multi['ref_digits']:.1f} digits"
          + f"; total {time.time() - t_start:.1f} s")
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
