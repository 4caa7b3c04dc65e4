"""Ranks of a run of several processes for the CPU tests of the port.

    python tests/torch_ranks.py TASK RANK WORLD INIT TMP ARGS_JSON

runs one rank of TASK over gloo with the file:// rendezvous INIT (no port
is needed) and writes what it found to TMP/result_<RANK>.* .  `launch`
starts WORLD such processes, waits for all and returns their results.
Neither imports JAX: the JAX side of a comparison runs in the test.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def launch(task: str, world: int, tmp: Path, args=None, timeout: float = 240.0) -> list:
    """Run `task` on `world` ranks; the ranks' results in rank order (a
    failing rank raises with every rank's stderr)."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    init = f"file://{tmp / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, task, str(r), str(world), init,
                               str(tmp), json.dumps(args or {})],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(REPO)) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("\n".join(f"rank {r} exited {p.returncode}:\n{err[-3000:]}"
                                     for r, (p, (_, err)) in enumerate(zip(procs, outs))))
    return [_load(tmp, r) for r in range(world)]


def _load(tmp: Path, rank: int):
    if (tmp / f"result_{rank}.json").exists():
        return json.loads((tmp / f"result_{rank}.json").read_text())
    import torch
    return torch.load(tmp / f"result_{rank}.pt", weights_only=False)


def _cli(rank, world, init, tmp, args):
    """cli.run of args["argv"] as this rank (--coordinator INIT); records
    the objectives of every iteration as exact strings, the reason, the
    iteration count, whether it printed and how often it wrote the
    solution."""
    import contextlib
    import io

    import mpmath

    from sdpb_tpu_torch.cli import sdpb as cli
    from sdpb_tpu_torch.io import solution
    from sdpb_tpu_torch.solver.solve import host_mpf

    writes = []
    save = solution.save_solution
    solution.save_solution = lambda *a, **k: (writes.append(1), save(*a, **k))[1]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        res = cli.run(args["argv"] + ["--coordinator", init, "--numProcesses", str(world),
                                      "--processId", str(rank)],
                      chunk_iterations=args.get("chunk", 0))
    with mpmath.workprec(800):
        objectives = [[mpmath.nstr(host_mpf(getattr(st, f)), 200) for f in
                       ("primal_objective", "dual_objective")] for st in res.history]
    return {"objectives": objectives, "reason": str(res.terminate_reason),
            "iterations": res.iterations, "printed": text.getvalue(),
            "solution_writes": len(writes), "state_gathered": res.state is not None}


def _iteration(rank, world, init, tmp, args):
    """One iteration on this rank's shard of TMP/shard_<rank>.pt (sdp,
    state, StepConfig): rank 0 records the host statistics and the state
    gathered from every rank."""
    import torch

    from sdpb_tpu_torch.parallel import distributed
    from sdpb_tpu_torch.parallel.mesh import gather_state
    from sdpb_tpu_torch.solver.solve import to_host
    from sdpb_tpu_torch.solver.step import make_iteration

    sdp, state, cfg = torch.load(Path(tmp) / f"shard_{rank}.pt", weights_only=False)
    group = distributed.initialize(init, world, rank, "cpu", timeout_s=120, verbosity=0)
    try:
        stats, new = make_iteration(cfg, group)(sdp, state)
        whole = gather_state(new, group)
    finally:
        group.close()
    return {"stats": to_host(stats), "state": whole}


def psum_inputs(rank: int) -> dict:
    """Rank `rank`'s values for the cross-rank sums: six elements each,
    classic (K=3), scaled (K=3; rank 1's first three are exact zeros, whose
    EXP_ZERO must not win the exponents' max), two words (K=10) and three
    words (K=19)."""
    import numpy as np
    import torch

    from sdpb_tpu_torch.ops import mpfloat as mp, mpwide
    from torch_parity import rand_limbs, rand_scaled

    rng = np.random.default_rng(10 + rank)
    limbs, exp = rand_scaled(rng, (6,), 3)
    if rank == 1:
        limbs[:, :3], exp[:3] = 0.0, mp.EXP_ZERO
    out = {"classic": mp.MP(torch.tensor(rand_limbs(rng, (6,), 3))),
           "scaled": mp.from_parts(limbs, exp, "cpu")}
    for name, K in (("wide2", 10), ("wide3", 19)):
        l64 = rand_limbs(rng, (6,), -(-(24 * K) // 53) + 1)
        l64 *= 10.0 ** rng.uniform(-6, 6, (6,))
        out[name] = mpwide.wide_parts_to_mp(mpwide.f64_limbs_to_wide_parts(l64, K), "cpu")
    return out


def pminmax_inputs(rank: int) -> dict:
    """Rank `rank`'s values for the cross-rank max and min: a float64
    vector whose last entry is NaN on rank 1 only, and a float32 scalar
    (an error norm of the scaled representation) that is NaN on rank 1."""
    import torch

    nan = float("nan")
    return {"vector": torch.tensor([rank + 1.0, -(rank + 1.0), nan if rank else 0.5],
                                   dtype=torch.float64),
            "scalar": torch.tensor(nan if rank else 3.0, dtype=torch.float32)}


def _collectives(rank, world, init, tmp, args):
    """timing_run_broadcast on a two-block problem, rank 0 measuring only
    after args["delay"] seconds, longer than the group's collective
    timeout; then solver/step.py's _psum_mp of psum_inputs(rank), as float64
    limb stacks, and its _pmax and _pmin of pminmax_inputs(rank)."""
    import time

    from sdpb_tpu_torch.cli import sdpb as cli
    from sdpb_tpu_torch.models.synthetic import random_sdp
    from sdpb_tpu_torch.ops import mpfloat as mp
    from sdpb_tpu_torch.parallel import distributed
    from sdpb_tpu_torch.parallel.timing import timing_run_broadcast
    from sdpb_tpu_torch.solver.step import _pmax, _pmin, _psum_mp

    host = random_sdp(num_blocks=2, dim=1, num_points=3, dual_dim=2, K=2, seed=1)
    params = cli.solver_params_from_args(cli.build_parser().parse_args(["-s", "x"]))
    group = distributed.initialize(init, world, rank, "cpu", timeout_s=args["timeout"],
                                   verbosity=0)
    try:
        if rank == 0:
            time.sleep(args["delay"])
        record = timing_run_broadcast(host, params, "cpu", Path(tmp) / "ck", group,
                                      verbosity=0)
        sums = {name: mp.host_f64_limbs(_psum_mp(v, group)).tolist()
                for name, v in psum_inputs(rank).items()}
        extremes = {name: {"max": _pmax(v, group).tolist(), "min": _pmin(v, group).tolist()}
                    for name, v in pminmax_inputs(rank).items()}
    finally:
        group.close()
    return {"record": record, "sums": sums, "extremes": extremes}


TASKS = {"cli": _cli, "iteration": _iteration, "collectives": _collectives}

if __name__ == "__main__":
    task, rank, world, init, tmp, args = sys.argv[1:]
    rank, world = int(rank), int(world)
    out = TASKS[task](rank, world, init, tmp, json.loads(args))
    if task == "iteration":
        import torch
        torch.save(out, Path(tmp) / f"result_{rank}.pt")
    else:
        (Path(tmp) / f"result_{rank}.json").write_text(json.dumps(out))
