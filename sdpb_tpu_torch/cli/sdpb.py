"""`sdpb` on PyTorch: solve a preprocessed SDP.

    python -m sdpb_tpu_torch.cli.sdpb -s sdp.zip --precision 216 \
        [--arithmetic classic|scaled] [--device cuda|cpu]
    torchrun --nproc_per_node 4 -m sdpb_tpu_torch.cli.sdpb -s sdp.zip ...

The flow, flags and output files of the JAX package's CLI
(sdpb_tpu/cli/sdpb.py): read the problem, run the timing run
on a multi-block problem that has no block_timings.json yet, resume from
--initialCheckpointDir (by default the checkpoint directory, sdpDir + '.ck',
so running a command again resumes it), solve with a checkpoint every
--checkpointInterval seconds, then the final checkpoint and the solution.
`--arithmetic` picks the representation, which the JAX CLI picks by
platform: classic float64 limbs (the default; on a CUDA card up to 13
limbs, --precision 681, more on the CPU) or scaled float32 limbs with an
int32 exponent per element: up to 9 limbs (216 bits) one scaled word,
10-18 limbs (--precision 209-424, covering the reference's default 400)
the wide representation of two words of Kg limbs, 19-27 (--precision
425-640) three words.  More than 27 scaled limbs are refused, as the JAX
CLI refuses them, and so is classic above 13 limbs on a card, both before
the SDP is read.  The device
defaults to `cuda` and is never chosen silently: without CUDA the run
stops unless `--device cpu` or `--platform cpu` is given.

A run of several processes (torchrun, or --coordinator, --numProcesses and
--processId in each) splits every bucket's blocks over the ranks
(parallel/mesh.py), each rank on its own card over NCCL, or on the CPU
over gloo (parallel/distributed.py); ranks that share a card go over gloo
too, and only in the host loop.  Every rank reads the SDP; rank 0 alone
runs the timing run (its record shared with the others), prints, writes
out.txt and saves the checkpoints of the state gathered from all ranks;
each rank loads a checkpoint whole and takes its shard, so a checkpoint
resumes at any world size.  At -v2 each rank writes profiling.<rank>.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from .common import add_solver_options, parse_with_param_file, solver_params_from_args

# three scaled words of at most 9 limbs (sdpb_tpu/cli/sdpb.py:113-117)
MAX_WIDE_LIMBS = 27
# classic float64 limbs the CUDA kernels take (csrc/mp.cuh; ROADMAP A23)
MAX_CARD_CLASSIC_LIMBS = 13


def limbs_for_precision(precision_bits: int, mant_bits: int = 53) -> int:
    """Limbs of `mant_bits` for `precision_bits` of significand (8 guard
    bits; sdpb_tpu/utils/platform.py:50-60)."""
    return max(2, -(-(precision_bits + 8) // mant_bits))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdpb", description="SDPB on PyTorch: semidefinite program solver")
    p.add_argument("--sdpDir", "-s", required=True,
                   help="Directory or zip containing preprocessed SDP data files.")
    p.add_argument("--paramFile", "-p", default=None,
                   help="Optional key=value file; command line overrides it.")
    p.add_argument("--outDir", "-o", default=None,
                   help="Output directory (default: sdpDir + '_out').")
    p.add_argument("--checkpointDir", "-c", default=None,
                   help="Checkpoint directory (default: sdpDir + '.ck').")
    p.add_argument("--initialCheckpointDir", "-i", default=None,
                   help="Directory to load the initial checkpoint from "
                        "(default: checkpointDir).")
    p.add_argument("--noFinalCheckpoint", action="store_true",
                   help="Don't save a final checkpoint after terminating.")
    p.add_argument("--writeSolution", default="x,y",
                   help="Comma-separated list among x,y,X,Y.")
    p.add_argument("--procsPerNode", type=int, default=0,
                   help="Accepted for reference compatibility.")
    p.add_argument("--procGranularity", type=int, default=1,
                   help="Accepted for reference compatibility.")
    p.add_argument("--verbosity", type=int, default=1,
                   help="0 -> no output, 1 -> regular output, 2 -> debug")
    p.add_argument("--device", default=None,
                   help="torch device to solve on (default cuda; 'cpu' only "
                        "when asked for by name).")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto",
                   help="'cpu' solves on the CPU (--device cpu); 'auto' keeps "
                        "--device.")
    p.add_argument("--maxBlockMemory", type=int, default=1 << 30,
                   help="Per-block device-memory budget in bytes, above which "
                        "the JAX CLI shards a block's rows over several devices; "
                        "a run of several processes with a larger block stops "
                        "(not ported), on one device it changes nothing.")
    p.add_argument("--timingRun", choices=("auto", "never"), default="auto",
                   help="'auto' (default): when checkpointDir has no "
                        "block_timings.json and the problem has more than one "
                        "block, time 2 iterations under each bucketing policy, "
                        "keep the fastest and persist the record; 'never' "
                        "skips it (quantized buckets of 8 points).")
    p.add_argument("--arithmetic", choices=("classic", "scaled"), default="classic",
                   help="MP representation: classic float64 limbs (on a "
                        "card up to --precision 681, 13 limbs; any on the "
                        "CPU) or scaled float32 limbs with an int32 exponent "
                        "per element (one word up to --precision 208, two "
                        "words up to 424, three up to 640).")
    p.add_argument("--coordinator", default=None,
                   help="A run of several processes: the rendezvous, host:port "
                        "(served by rank 0) or file:///path (default: torchrun's "
                        "MASTER_ADDR:MASTER_PORT).")
    p.add_argument("--numProcesses", type=int, default=None,
                   help="A run of several processes: their number (default: "
                        "WORLD_SIZE).")
    p.add_argument("--processId", type=int, default=None,
                   help="A run of several processes: this one's rank (default: "
                        "RANK; its card is LOCAL_RANK's, else processId modulo the "
                        "host's cards).")
    add_solver_options(p)
    return p


def check_precision(arithmetic: str, precision: int, device=None,
                    platform: str = "auto") -> int:
    """The scaled limbs of --arithmetic and --precision (0: classic), or a
    stop naming the limit: more than MAX_WIDE_LIMBS scaled limbs anywhere,
    more than MAX_CARD_CLASSIC_LIMBS classic ones on the CUDA device that
    --device and --platform ask for (no card is needed to refuse)."""
    if arithmetic == "scaled":
        scaled_limbs = limbs_for_precision(precision, 24)
        if scaled_limbs > MAX_WIDE_LIMBS:
            raise SystemExit(
                f"--precision {precision} needs {scaled_limbs} scaled float32 limbs; "
                f"the wide representation holds at most {MAX_WIDE_LIMBS} (three words "
                f"of 9, --precision 640).  Use --arithmetic classic.")
        return scaled_limbs
    K = limbs_for_precision(precision)
    on_card = platform != "cpu" and torch.device(device or "cuda").type == "cuda"
    if on_card and K > MAX_CARD_CLASSIC_LIMBS:
        raise SystemExit(
            f"--precision {precision} needs {K} classic float64 limbs; the CUDA "
            f"kernels take at most {MAX_CARD_CLASSIC_LIMBS} (--precision 681): "
            f"classic limbs past 13 on a card are ROADMAP A23.  Use --arithmetic "
            f"scaled (up to --precision 640) or --device cpu.")
    return 0


def resolve_device(name, platform: str = "auto") -> torch.device:
    """The device of --device and --platform: cuda unless either asks for
    the CPU; a CUDA device without CUDA, or a device other than the CPU
    under --platform cpu, stops the run."""
    if platform == "cpu":
        if name not in (None, "cpu"):
            raise SystemExit(f"--platform cpu contradicts --device {name}")
        name = "cpu"
    name = name or "cuda"
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: CUDA is not available "
                         f"(pass --device cpu or --platform cpu to solve on the CPU)")
    return device


def run(argv=None, chunk_iterations: int = 0):
    """Parse, solve and write the solution; returns the SolveResult.
    chunk_iterations as run_solver's (0: the chunked loop in chunks of 8;
    1: the host loop); the command line always takes the default."""
    args = parse_with_param_file(build_parser(), argv)
    params = solver_params_from_args(args)
    scaled_limbs = check_precision(args.arithmetic, params.precision, args.device,
                                   args.platform)
    device = resolve_device(args.device, args.platform)
    from ..parallel import distributed

    group = distributed.initialize(args.coordinator, args.numProcesses, args.processId,
                                   device, verbosity=args.verbosity)
    try:
        return _run(args, params, scaled_limbs, device if group is None else group.device,
                    group, chunk_iterations)
    finally:
        if group is not None:
            group.close()


def _run(args, params, scaled_limbs: int, device, group, chunk_iterations: int):
    """run() on `device`, as rank group.rank of a run of several processes
    when `group` is given."""

    from ..io.sdp_zip import read_sdp
    from ..io.solution import WriteSolution, mp_str, save_solution
    from ..models.sdp import build_device_sdp
    from ..parallel.mesh import check_block_memory, gather_state, shard_sdp, shard_state
    from ..parallel.timing import (bucketing, load_timings, save_timings, timing_run,
                                   timing_run_broadcast)
    from ..solver.checkpoint import load_checkpoint, save_checkpoint
    from ..solver.solve import run_solver
    from ..utils.timers import Timers

    sdp_path = args.sdpDir
    base = sdp_path[:-4] if sdp_path.endswith(".zip") else sdp_path
    out_dir = Path(args.outDir or (base + "_out"))
    ck_dir = Path(args.checkpointDir or (base + ".ck"))
    initial_ck = Path(args.initialCheckpointDir) if args.initialCheckpointDir else ck_dir
    write_solution = WriteSolution.parse(args.writeSolution)
    verbosity = args.verbosity
    rank0 = group is None or group.is_coordinator
    say = verbosity if rank0 else 0          # only rank 0 prints
    if scaled_limbs:
        K = -(-(24 * scaled_limbs) // 53) + 1      # float64 host limbs
        mant_bits, K_dev = 24, scaled_limbs
    else:
        K = limbs_for_precision(params.precision)
        mant_bits, K_dev = 53, K
    if say >= 1:
        print("SDPB PyTorch solver")
        print(f"SDP directory   : {sdp_path}")
        print(f"out directory   : {out_dir}")
        print(f"checkpoint dir  : {ck_dir}")
        if scaled_limbs > 9:
            from ..ops.mpwide import wide_config
            G, Kg = wide_config(scaled_limbs)
            print(f"precision       : {params.precision} bits ({G} words × {Kg} "
                  f"scaled float32 limbs)")
        elif scaled_limbs:
            print(f"precision       : {params.precision} bits ({scaled_limbs} "
                  f"scaled float32 limbs + exponent)")
        else:
            print(f"precision       : {params.precision} bits ({K} x float64 limbs)")
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        ranks = "" if group is None else \
            f", rank 0 of {group.world_size}, collectives over {group.backend}"
        print(f"device          : {device} ({name}){ranks}")

    timers = Timers()
    with timers.scope("read_sdp"):
        host = read_sdp(sdp_path, K, np.float64)

    # the timing run (src/sdpb/main.cxx:50-91): measured once, persisted in
    # the checkpoint directory and reused thereafter; in a run of several
    # processes rank 0's file decides and rank 0 alone measures
    timings = load_timings(ck_dir) if rank0 else None
    if group is not None:
        timings = json.loads(group.share(json.dumps(timings)))
    if timings is None and args.timingRun != "never" and host.num_blocks > 1:
        if say >= 1:
            print("no block timings found; running 2-iteration timing run "
                  "(persisted to checkpointDir/block_timings.json)")
        with timers.scope("timing_run"):
            if group is None:
                timings = timing_run(host, params, device, scaled_limbs=scaled_limbs,
                                     verbosity=verbosity)
                save_timings(ck_dir, timings)
            else:
                timings = timing_run_broadcast(host, params, device, ck_dir, group,
                                               scaled_limbs=scaled_limbs, verbosity=say)
        if say >= 1:
            print(f"timing run      : {timers.elapsed['timing_run']:.3f} s, chose "
                  f"{timings['chosen']['policy']} quant={timings['chosen']['quant']}")
    policy, quant = bucketing(timings)
    if group is None:
        sdp = whole = build_device_sdp(host, device, scaled_limbs=scaled_limbs, quant=quant,
                                       shape_policy=policy)
    else:
        # the whole problem on the host (its block structure is what
        # checkpoints and the solution need), each rank's shard on its device
        whole = build_device_sdp(host, "cpu", scaled_limbs=scaled_limbs, quant=quant,
                                 shape_policy=policy, pad_to=group.world_size,
                                 block_costs=(timings or {}).get("block_costs"))
        if group.world_size > 1:
            check_block_memory(whole, args.maxBlockMemory)
        sdp = shard_sdp(whole, group.rank, group.world_size, group.device)
    initial = load_checkpoint(initial_ck, whole, say, precision=params.precision) \
        if initial_ck.exists() else None
    if initial is not None and group is not None:
        initial = shard_state(initial, group.rank, group.world_size, group.device)

    def gathered(state):
        return state if group is None else gather_state(state, group)

    def checkpoint_fn(state, it):
        state = gathered(state)
        if rank0:
            save_checkpoint(ck_dir, whole, state, options=params.to_dict(), verbosity=say)

    result = run_solver(sdp, params, verbosity=verbosity, initial=initial, timers=timers,
                        chunk_iterations=chunk_iterations, checkpoint_fn=checkpoint_fn,
                        group=group)

    if say >= 1:
        print(f"-----{result.terminate_reason}-----")
        nd = int(mant_bits * K_dev * 0.30103) + 1
        print(f"primalObjective = {mp_str(result.primal_objective, nd)}")
        print(f"dualObjective   = {mp_str(result.dual_objective, nd)}")
        print(f"dualityGap      = {mp_str(result.duality_gap, nd)}")
        print(f"primalError     = {mp_str(result.primal_error, nd)}")
        print(f"dualError       = {mp_str(result.dual_error, nd)}")
    result.state = gathered(result.state)      # None on the other ranks
    if rank0:
        if not args.noFinalCheckpoint:
            save_checkpoint(ck_dir, whole, result.state, options=params.to_dict(),
                            verbosity=say)
        save_solution(out_dir, result, whole, write_solution, verbosity=say)
    if verbosity >= 2:
        if rank0:
            print(timers.to_json())
        # the reference's per-rank profile at -v2 (write_timing.cxx:10-14)
        prof_dir = Path(str(ck_dir) + ".profiling")
        prof_dir.mkdir(parents=True, exist_ok=True)
        timers.write_profile(prof_dir / f"profiling.{0 if group is None else group.rank}")
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
