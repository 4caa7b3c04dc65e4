"""The reader of the reference's binary checkpoint (io/ref_checkpoint.py)
and checkpoints across the world sizes of runs of several processes
(solver/checkpoint.py, cli/sdpb.py), on the CPU.

Tolerances:
  * the reader: a row-major reference-format checkpoint_0_0 of a state of
    the dim-2 certificate (K=2, written at 448 bits, which hold every
    value's limbs exactly) loads back to that state limb for limb (its X
    and Y are symmetric in value, not in their last limbs: the JAX
    reader's transpose differs there by ~1e-46); made exactly symmetric,
    the JAX package's reader gives the same limbs as the port's (x and y
    are one column); on a block made non-symmetric the port reads element
    (r, c) where the reference wrote it and the JAX reader its transpose
    (the JAX package's column-major decode, ROADMAP's reference defects);
  * whole runs at --precision 64 (K=2, ~32 digits) of a 3-block problem:
    a world-2 CLI run resumed from a world-1 checkpoint writes out.txt
    once (rank 0), and its objectives share at least 28 digits with the
    world-1 run of the same resume in every iteration (the ranks' sums
    meet in another order); the world-2 final checkpoint resumes at world
    1, whose first iteration's objectives share 28 digits with the
    world-2 run's last.
"""
import functools

import mpmath
import numpy as np
import pytest
import torch

import jax

from sdpb_tpu.io.ref_checkpoint import load_reference_binary_checkpoint as jax_load
from sdpb_tpu.io.sdp_zip import read_sdp as jax_read_sdp
from sdpb_tpu.models import sdp as jsdp
from sdpb_tpu_torch.cli import sdpb as cli
from sdpb_tpu_torch.io.sdp_zip import read_sdp, write_sdp
from sdpb_tpu_torch.models.synthetic import random_sdp
from sdpb_tpu_torch.io.solution import host_blocks
from sdpb_tpu_torch.models import sdp as tsdp
from sdpb_tpu_torch.ops import mpfloat as tmp
from sdpb_tpu_torch.solver import checkpoint as tck
from sdpb_tpu_torch.solver.solve import host_mpf, run_solver
from sdpb_tpu_torch.solver.step import state_tensors

import torch_ranks
from test_torch_slice import CERTIFICATE
from torch_parity import write_reference_checkpoint

PREC = 448
# the certificate at 64 bits, classic K=2, in the host loop
SOLVE = ("--platform", "cpu", "--precision", "64", "--initialMatrixScalePrimal", "1e2",
         "--initialMatrixScaleDual", "1e2", "--verbosity", "0")


@functools.lru_cache(maxsize=1)
def _certificate_state():
    """(sdp, state) of the certificate after 2 iterations."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        res = cli.run(["-s", str(CERTIFICATE), "-o", f"{tmp}/out", "-c", f"{tmp}/ck", *SOLVE,
                       "--maxIterations", "2"], chunk_iterations=1)
    return tsdp.build_device_sdp(read_sdp(CERTIFICATE, 2), "cpu"), res.state


def _write(directory, sdp, state, **kw):
    blocks = host_blocks(sdp, state)
    write_reference_checkpoint(directory, blocks, tmp.host_f64_limbs(state.y), PREC, **kw)
    return blocks


def test_reference_binary_checkpoint_loads_back(tmp_path):
    """The state loads back limb for limb (its X and Y are symmetric in
    value but not in their last limbs); with X and Y made exactly
    symmetric (the upper triangle mirrored) the JAX reader reads the same
    limbs as the port's."""
    sdp, state = _certificate_state()
    _write(tmp_path, sdp, state)
    loaded = tck.load_checkpoint(tmp_path, sdp, verbosity=0)
    assert all(torch.equal(a, b) for a, b in zip(state_tensors(loaded),
                                                 state_tensors(state)))
    blocks = host_blocks(sdp, state)
    for b in blocks.values():
        for f in ("X_even", "X_odd", "Y_even", "Y_odd"):
            upper = np.triu(b[f])
            b[f] = upper + np.swapaxes(np.triu(b[f], 1), -1, -2)
    write_reference_checkpoint(tmp_path / "sym", blocks, tmp.host_f64_limbs(state.y), PREC)
    loaded = tck.load_checkpoint(tmp_path / "sym", sdp, verbosity=0)
    jsd = jsdp.build_device_sdp(jax_read_sdp(str(CERTIFICATE), 2, np.float64))
    jstate = jax.tree.map(np.asarray, jax_load(tmp_path / "sym", jsd, PREC, verbosity=0))
    want = [jstate.y.limbs] + [getattr(b, f).limbs for b in jstate.buckets
                               for f in ("x", "X_even", "X_odd", "Y_even", "Y_odd")]
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(state_tensors(loaded), want))


def test_a_non_symmetric_block_shows_the_row_major_order(tmp_path):
    """X_even of block 0 made non-symmetric: the port reads (r, c) where
    the stream put it, row outer; the JAX reader transposes it."""
    sdp, state = _certificate_state()
    blocks = host_blocks(sdp, state)
    X = blocks[0]["X_even"]
    X[:, 0, 1] = 0.0
    X[0, 0, 1] = 0.75
    write_reference_checkpoint(tmp_path, blocks, tmp.host_f64_limbs(state.y), PREC)
    mine = host_blocks(sdp, tck.load_checkpoint(tmp_path, sdp, verbosity=0))[0]["X_even"]
    assert mine[0, 0, 1] == 0.75 and mine[0, 1, 0] == X[0, 1, 0] != 0.75
    jsd = jsdp.build_device_sdp(jax_read_sdp(str(CERTIFICATE), 2, np.float64))
    jx = np.asarray(jax_load(tmp_path, jsd, PREC, verbosity=0).buckets[0].X_even.limbs)
    assert jx[0, 0, 1, 0] == 0.75 and jx[0, 0, 0, 1] == X[0, 1, 0]


def test_multi_rank_reference_checkpoint_is_refused(tmp_path):
    sdp, state = _certificate_state()
    _write(tmp_path, sdp, state, ranks=(0, 1))
    with pytest.raises(ValueError, match="multi-rank"):
        tck.load_checkpoint(tmp_path, sdp, verbosity=0)


def test_missing_precision_asks_for_it(tmp_path):
    """No precision in checkpoint.json: without the run's, or with a run's
    that the BigFloats do not carry, the load stops naming --precision;
    with the right one it loads."""
    sdp, state = _certificate_state()
    _write(tmp_path, sdp, state, record_precision=False)
    with pytest.raises(SystemExit, match="pass --precision explicitly"):
        tck.load_checkpoint(tmp_path, sdp, verbosity=0)
    with pytest.raises(SystemExit, match=f"pass --precision {PREC} explicitly"):
        tck.load_checkpoint(tmp_path, sdp, verbosity=0, precision=64)
    loaded = tck.load_checkpoint(tmp_path, sdp, verbosity=0, precision=PREC)
    assert all(torch.equal(a, b) for a, b in zip(state_tensors(loaded), state_tensors(state)))


def test_cli_resumes_from_a_reference_binary_checkpoint(tmp_path, capsys):
    """--initialCheckpointDir of a reference checkpoint: the same run as
    the resume from the state in memory, bit for bit."""
    sdp, state = _certificate_state()
    _write(tmp_path / "ref", sdp, state)
    argv = ["-s", str(CERTIFICATE), "-o", str(tmp_path / "out"), *SOLVE,
            "--maxIterations", "1"]
    res = cli.run(argv + ["-c", str(tmp_path / "ck"), "-i", str(tmp_path / "ref"),
                          "--verbosity", "1"], chunk_iterations=1)
    assert "Loading reference binary checkpoint from" in capsys.readouterr().out
    params = cli.solver_params_from_args(cli.parse_with_param_file(cli.build_parser(), argv))
    memory = run_solver(sdp, params, verbosity=0, initial=state, chunk_iterations=1)
    assert [r.mu.tobytes() for r in res.history] == [r.mu.tobytes() for r in memory.history]


def _digits(a: str, b: str) -> float:
    with mpmath.workprec(800):
        a, b = mpmath.mpf(a), mpmath.mpf(b)
        return float("inf") if a == b else float(-mpmath.log10(abs(a - b) / abs(b)))


def test_checkpoints_cross_world_sizes(tmp_path):
    """World 1 -> a world-2 resume -> a world-1 resume of its checkpoint,
    on a 3-block problem with an objective constant of 1 (at world 2 the
    ranks hold 2 blocks and 1 block and a padding block)."""
    host = random_sdp(num_blocks=3, dim=1, num_points=3, dual_dim=2, K=2, seed=1)
    host.objective_const = np.array([1.0, 0.0])
    write_sdp(tmp_path / "sdp.zip", host)
    base = ["-s", str(tmp_path / "sdp.zip"), "-o", str(tmp_path / "out"), "--platform", "cpu",
            "--precision", "64", "--initialMatrixScalePrimal", "1e2",
            "--initialMatrixScaleDual", "1e2", "--verbosity", "1", "--timingRun", "never"]
    cli.run(base + ["-c", str(tmp_path / "w1"), "--maxIterations", "1"], chunk_iterations=1)
    two = torch_ranks.launch("cli", 2, tmp_path / "ranks", {
        "argv": base + ["-c", str(tmp_path / "w2"), "-i", str(tmp_path / "w1"),
                        "--maxIterations", "1"], "chunk": 1})
    assert [r["solution_writes"] for r in two] == [1, 0]
    assert [r["state_gathered"] for r in two] == [True, False]
    assert "rank 0 of 2, collectives over gloo" in two[0]["printed"]
    assert two[1]["printed"] == ""
    assert two[0]["objectives"] == two[1]["objectives"]
    assert (tmp_path / "out" / "out.txt").exists()
    one = cli.run(base + ["-c", str(tmp_path / "w1b"), "-i", str(tmp_path / "w1"),
                          "--maxIterations", "1", "--verbosity", "0"], chunk_iterations=1)
    mine = [_objectives(st) for st in one.history]
    assert len(mine) == len(two[0]["objectives"]) == 2
    assert min(_digits(a, b) for ra, rb in zip(two[0]["objectives"], mine)
               for a, b in zip(ra, rb)) >= 28
    back = cli.run(base + ["-c", str(tmp_path / "w1c"), "-i", str(tmp_path / "w2"),
                           "--maxIterations", "0", "--verbosity", "0"], chunk_iterations=1)
    assert min(_digits(a, b) for a, b in zip(_objectives(back.history[0]),
                                             two[0]["objectives"][-1])) >= 28


def _objectives(st) -> list:
    """The primal and dual objectives of a HostStats as exact strings (as
    tests/torch_ranks.py records them)."""
    with mpmath.workprec(800):
        return [mpmath.nstr(host_mpf(getattr(st, f)), 200)
                for f in ("primal_objective", "dual_objective")]
