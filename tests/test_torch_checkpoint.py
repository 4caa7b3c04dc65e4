"""The port's checkpoints, resume and timing run (solver/checkpoint.py,
parallel/timing.py, the CLI's flow) against the JAX package on the CPU.

Tolerances:
  * checkpoint files: a file either package writes loads in the other with
    every limb (and exponent) equal to that package's own load of it, in
    the classic (K=3), scaled (K32=3) and wide (K32=12, two words of 6)
    representations; the port writes the npz arrays byte for byte as the
    JAX package does, under the same keys in the same order.
  * the round trip state -> checkpoint -> state keeps every value
    exactly.  It gives every limb back bit for bit where the limbs are
    canonical (each tail at most half an ulp of the limb above it), which
    the states here are, in all three representations; so the CLI's
    resume from a file is held bit for bit to a resume from the state in
    memory.  The scaled arithmetic leaves a tail just above half an ulp on
    a few elements (on the card, 1 of the 180,615 in the scaled ladder's
    state after 15 iterations); the load re-distils them, as the JAX package's load of the same file does,
    to another representation of the same value.  A resume from such a
    state is held to the resume from memory at the tolerance of one scaled
    iteration in tests/test_torch_slice.py: MP statistics (each) and the
    state (each array, against its largest entry) within 2^-(24K-24)
    relative, the float64 statistics within 1e-12
    relative (the steps come out identical here), or 2^-(24K-24) absolute
    for those at the rounding floor (the KKT residual, ~2^-73); the values
    differ at ~2^-65 at K32=3.
  * resuming 3 host-loop iterations from a JAX-written checkpoint: every
    statistic within 1e-8 relative of the JAX package's resumed run (the
    tolerance of tests/test_torch_slice.py's free-running iterations).
  * the timing run: the record's keys, the bucket counts and the choice
    equal; the per-block costs proportional to the JAX package's (the same
    heuristic, scaled by each package's measured seconds); a JAX-written
    block_timings.json gives the port the JAX package's buckets, limbs and
    masks equal.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import jax

from sdpb_tpu.io.sdp_zip import write_sdp
from sdpb_tpu.models import sdp as jsdp
from sdpb_tpu.models.synthetic import random_sdp
from sdpb_tpu.ops import mpwide as jmw
from sdpb_tpu.parallel import timing as jtiming
from sdpb_tpu.solver import checkpoint as jck, solve as jsolve, state as jstate
from sdpb_tpu.solver.params import SolverParameters as JaxParameters
from sdpb_tpu_torch import interop
from sdpb_tpu_torch.cli import sdpb as cli
from sdpb_tpu_torch.io.sdp_zip import read_sdp
from sdpb_tpu_torch.io.solution import host_blocks
from sdpb_tpu_torch.models import sdp as tsdp
from sdpb_tpu_torch.ops import mpfloat as tmp
from sdpb_tpu_torch.parallel import planner, timing
from sdpb_tpu_torch.solver import checkpoint as tck, solve as tsolve, state as tstate
from sdpb_tpu_torch.solver.params import SolverParameters

from test_shape_padding import mixed_sdp
from test_timing_run import _skewed_host
from test_torch_slice import (CERTIFICATE, _RecordingJax, _assert_buckets_equal, _cmp,
                              _floor, _jax_iteration, _jax_two_iterations, _problem)
from torch_parity import J, JW, T, rand_limbs, rand_scaled, rel_err, scaled_rel_err

torch.set_num_threads(1)

FIELDS = ("x", "X_even", "X_odd", "Y_even", "Y_odd")
# representation: (device limbs, host float64 limbs of the problem)
REPS = {"classic": (3, 3), "scaled": (3, 3), "wide": (12, 7)}
# the certificate at 150 bits, classic (K=3)
CLI_SOLVE = ("--platform", "cpu", "--precision", "150", "--dualityGapThreshold", "1e-12",
             "--primalErrorThreshold", "1e-12", "--dualErrorThreshold", "1e-12",
             "--initialMatrixScalePrimal", "1e2", "--initialMatrixScaleDual", "1e2")


def _leaves(state) -> list:
    """Every limb and exponent array of a JAX or port state, in one order."""
    return [a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            for w in _words(state) for a in (w.limbs, w.exp) if a is not None]


def _same_state(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(la, lb))


def _words(state) -> list:
    """Every MP word of a state, in one order."""
    return [w for v in [state.y] + [getattr(b, f) for b in state.buckets for f in FIELDS]
            for w in getattr(v, "words", [v])]


def _same_blocks(sdp, a, b) -> bool:
    """Two states hold the same values in every block's real entries (the
    padding is the loader's: zero x, identity on padded PSD dims)."""
    ba, bb = host_blocks(sdp, a), host_blocks(sdp, b)
    return ba.keys() == bb.keys() and all(
        np.array_equal(ba[i][f], bb[i][f]) for i in ba for f in FIELDS)


def _problems(rep):
    """The mixed-shape problem (dims 1 and 2, 4-7 points: padded PSD dims
    in its quantized buckets) in both packages."""
    K, K64 = REPS[rep]
    host = mixed_sdp(K=K64)
    scaled = 0 if rep == "classic" else K
    return host, jsdp.build_device_sdp(host, scaled_limbs=scaled), \
        tsdp.build_device_sdp(host, "cpu", scaled_limbs=scaled)


def _random_state(sdp, rep, seed=0):
    """A JAX package SolverState of random renormalized values in sdp's
    layout and representation."""
    K = REPS[rep][0]
    rng = np.random.default_rng(seed)

    def value(shape):
        if rep == "classic":
            return J(rand_limbs(rng, shape, K))
        if rep == "scaled":
            return J(rand_scaled(rng, shape, K))
        l64 = rand_limbs(rng, shape, -(-(24 * K) // 53) + 2)
        l64 *= 10.0 ** rng.uniform(-6, 6, shape)
        return JW(jmw.f64_limbs_to_wide_parts(l64, K))

    buckets = []
    for bk in sdp.buckets:
        B, sh = bk.batch, bk.shape
        ne, no = sh.dim * sh.h_even, sh.dim * sh.h_odd
        buckets.append(jstate.BucketState(
            x=value((B, sh.schur_size)), X_even=value((B, ne, ne)), X_odd=value((B, no, no)),
            Y_even=value((B, ne, ne)), Y_odd=value((B, no, no))))
    return jstate.SolverState(y=value((sdp.dual_dim,)), buckets=buckets)


def _port_state(state):
    return interop.state_from_numpy(jax.tree.map(np.asarray, state), "cpu")


@pytest.mark.parametrize("rep", list(REPS))
def test_jax_checkpoint_loads_in_the_port(rep, tmp_path):
    _, jsdp_, tsdp_ = _problems(rep)
    state = _random_state(jsdp_, rep)
    jck.save_checkpoint(tmp_path, jsdp_, state, verbosity=0)
    mine = tck.load_checkpoint(tmp_path, tsdp_, verbosity=0)
    ref = jck.load_checkpoint(tmp_path, jsdp_, verbosity=0)
    assert _same_state(mine, ref)
    assert _same_blocks(tsdp_, mine, _port_state(state))    # the round trip is exact


@pytest.mark.parametrize("rep", list(REPS))
def test_port_checkpoint_is_the_jax_checkpoint(rep, tmp_path):
    """The port's file of a state carried across: the same npz keys in the
    same order, the arrays byte for byte, the same metadata; the JAX
    package loads it as it loads its own."""
    _, jsdp_, tsdp_ = _problems(rep)
    state = _random_state(jsdp_, rep, seed=1)
    mine, ref = tmp_path / "port", tmp_path / "jax"
    tck.save_checkpoint(mine, tsdp_, _port_state(state),
                        options=SolverParameters().to_dict(), verbosity=0)
    jck.save_checkpoint(ref, jsdp_, state, options=JaxParameters().to_dict(), verbosity=0)
    with np.load(mine / "checkpoint_0.npz") as a, np.load(ref / "checkpoint_0.npz") as b:
        assert a.files == b.files
        for key in a.files:
            assert a[key].dtype == b[key].dtype == np.float64, key
            assert a[key].shape == b[key].shape and a[key].tobytes() == b[key].tobytes(), key
    assert json.loads((mine / tck.METADATA).read_text()) == \
        json.loads((ref / jck.METADATA).read_text())
    assert _same_state(jck.load_checkpoint(mine, jsdp_, verbosity=0),
                       jck.load_checkpoint(ref, jsdp_, verbosity=0))


def test_generations_and_the_backup(tmp_path):
    """Three saves leave generations 1 and 2, current 2 and backup 1; with
    the current npz gone both packages load the backup."""
    _, jsdp_, tsdp_ = _problems("classic")
    states = [_port_state(_random_state(jsdp_, "classic", seed=s)) for s in range(3)]
    gens = [tck.save_checkpoint(tmp_path, tsdp_, st, verbosity=0) for st in states]
    assert gens == [0, 1, 2]
    assert sorted(p.name for p in tmp_path.glob("checkpoint_*.npz")) == \
        ["checkpoint_1.npz", "checkpoint_2.npz"]
    meta = json.loads((tmp_path / tck.METADATA).read_text())
    assert (meta["current"], meta["backup"], meta["version"]) == (2, 1, 1)
    assert _same_blocks(tsdp_, tck.load_checkpoint(tmp_path, tsdp_, verbosity=0), states[2])
    (tmp_path / "checkpoint_2.npz").unlink()
    mine = tck.load_checkpoint(tmp_path, tsdp_, verbosity=0)
    assert _same_blocks(tsdp_, mine, states[1])
    assert _same_state(mine, jck.load_checkpoint(tmp_path, jsdp_, verbosity=0))


def test_resume_from_a_jax_checkpoint_matches_jax(tmp_path, monkeypatch):
    """The certificate's state after one JAX iteration, saved by the JAX
    package; 3 host-loop iterations resumed from the file in each
    package agree at 1e-8 relative, and the port's resume from the file
    equals its resume from the state in memory bit for bit."""
    host, params, K = _problem("cert_K3")
    params.max_iterations = 3
    sdp_np, st1, _, _ = _jax_two_iterations("cert_K3")
    jck.save_checkpoint(tmp_path, sdp_np, st1, verbosity=0)
    jsdp_, compiled = _jax_iteration("cert_K3")
    rec = _RecordingJax(compiled)
    monkeypatch.setattr(jsolve, "jax", rec)
    jres = jsolve.run_solver(jsdp_, params, verbosity=0, chunk_iterations=1,
                             initial=jck.load_checkpoint(tmp_path, jsdp_, verbosity=0))
    tsdp_ = tsdp.build_device_sdp(host, "cpu")
    tres = tsolve.run_solver(tsdp_, params, verbosity=0, chunk_iterations=1,
                             initial=tck.load_checkpoint(tmp_path, tsdp_, verbosity=0))
    assert str(tres.terminate_reason) == str(jres.terminate_reason)
    assert len(tres.history) == len(rec.rows) == 4
    for i, (mine, ref) in enumerate(zip(tres.history, rec.rows)):
        for f in mine._fields:
            want = getattr(ref, f)
            _cmp(f"iteration {i + 1} {f}", getattr(mine, f), want, 1e-8, _floor(K),
                 hasattr(want, "limbs"))
    memory = tsolve.run_solver(tsdp_, params, verbosity=0, chunk_iterations=1,
                               initial=_port_state(st1))
    assert _same_state(memory.state, tres.state)


def test_a_redistilled_state_resumes_within_tolerance(tmp_path):
    """The scaled certificate after 2 iterations, with tails just above
    half an ulp written into Y (the same values, as the scaled arithmetic
    leaves them on a few elements): the load re-distils those elements,
    as the JAX package's load does, and 3 iterations resumed from the
    file stay within one scaled iteration's tolerance of the resume from
    memory (see the module docstring)."""
    K = 3
    sdp = tsdp.build_device_sdp(read_sdp(CERTIFICATE, 3), "cpu", scaled_limbs=K)
    params = SolverParameters(precision=64, duality_gap_threshold="1e-12",
                              primal_error_threshold="1e-12", dual_error_threshold="1e-12",
                              initial_matrix_scale_primal="1e2",
                              initial_matrix_scale_dual="1e2", max_iterations=2)
    state = tsolve.run_solver(sdp, params, verbosity=0).state
    Y = state.buckets[0].Y_even.limbs
    flat = Y.reshape(K, -1).double().numpy().copy()
    moved = 0
    for i in range(flat.shape[1]):
        hi, lo = flat[K - 2, i], flat[K - 1, i]
        u = 2.0 ** (np.frexp(abs(hi))[1] - 24) * (1.0 if lo >= 0 else -1.0)
        if hi and np.float32(hi + u) == hi + u and np.float32(lo - u) == lo - u:
            flat[K - 2, i], flat[K - 1, i] = hi + u, lo - u
            moved += 1
    assert moved >= 8
    Y.copy_(torch.as_tensor(flat.reshape(Y.shape), dtype=torch.float32))
    tck.save_checkpoint(tmp_path, sdp, state, verbosity=0)
    loaded = tck.load_checkpoint(tmp_path, sdp, verbosity=0)
    assert not _same_state(loaded, state) and _same_blocks(sdp, loaded, state)
    jsdp_ = jsdp.build_device_sdp(read_sdp(CERTIFICATE, 3), scaled_limbs=K)
    assert _same_state(loaded, jck.load_checkpoint(tmp_path, jsdp_, verbosity=0))
    params.max_iterations = 3
    from_file = tsolve.run_solver(sdp, params, verbosity=0, initial=loaded)
    from_memory = tsolve.run_solver(sdp, params, verbosity=0, initial=state)
    assert str(from_file.terminate_reason) == str(from_memory.terminate_reason)
    assert len(from_file.history) == len(from_memory.history) == 4
    mp_rel = 2.0 ** -(24 * K - 24)
    for i, (x, y) in enumerate(zip(from_file.history, from_memory.history)):
        for f in x._fields:
            a, b = getattr(x, f), getattr(y, f)
            if isinstance(a, tuple):
                assert scaled_rel_err(T(a), T(b)) <= mp_rel, (i, f)
            elif isinstance(a, float):
                assert abs(a - b) <= max(1e-12 * abs(b), mp_rel), (i, f)
    for a, b in zip(_words(from_file.state), _words(from_memory.state)):
        assert rel_err(tmp.host_f64_limbs(a), tmp.host_f64_limbs(b)) <= mp_rel


def test_the_loops_checkpoint_where_the_jax_loops_do():
    """checkpointInterval 0: the chunked loop (chunks of 3, maxIterations
    5: chunks at iterations 1 and 4) checkpoints each chunk's start, the
    one at chunk 2 the state after chunk 1 (the host loop's after 3
    iterations); the host loop checkpoints before every iteration."""
    host, params, _ = _problem("dim1_K2")
    params.max_iterations, params.checkpoint_interval = 5, 0
    sdp = tsdp.build_device_sdp(host, "cpu")
    seen = []

    def record(state, it):
        seen.append((it, tstate.clone_state(state)))

    tsolve.run_solver(sdp, params, verbosity=0, chunk_iterations=3, checkpoint_fn=record)
    assert [it for it, _ in seen] == [1, 4]
    params.max_iterations = 3
    three = tsolve.run_solver(sdp, params, verbosity=0, chunk_iterations=1)
    assert _same_state(seen[1][1], three.state)
    host_loop = tsolve.run_solver(sdp, params, verbosity=0, chunk_iterations=1,
                                checkpoint_fn=lambda st, it: seen.append((it, st)))
    assert [it for it, _ in seen[2:]] == [1, 2, 3, 4]
    assert host_loop.iterations == 4


@pytest.fixture(scope="module")
def text_solution(tmp_path_factory):
    """The certificate after one iteration written by the port's CLI with
    --writeSolution x,y,X,Y."""
    d = tmp_path_factory.mktemp("text")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.run(["-s", str(CERTIFICATE), "-o", str(d / "out"), "-c", str(d / "ck"),
                 *CLI_SOLVE, "--maxIterations", "1", "--writeSolution", "x,y,X,Y"])
    return d / "out"


@pytest.mark.parametrize("rep", list(REPS))
def test_text_checkpoint_matches_jax(rep, text_solution):
    K, K64 = REPS[rep]
    host = read_sdp(CERTIFICATE, K64)
    scaled = 0 if rep == "classic" else K
    mine = tck.load_checkpoint(text_solution, tsdp.build_device_sdp(host, "cpu", scaled),
                               verbosity=0)
    ref = jck.load_text_checkpoint(text_solution, jsdp.build_device_sdp(
        host, scaled_limbs=scaled), verbosity=0)
    assert _same_state(mine, ref)


def test_checkpoint_across_bucketing_matches_jax(tmp_path):
    """Written under "exact" bucketing, loaded under "quantized" (padded
    PSD dims): the port's load equals the JAX package's, and each block's
    values come back unchanged."""
    host = mixed_sdp(K=3)
    exact = tsdp.build_device_sdp(host, "cpu", shape_policy="exact")
    quant = tsdp.build_device_sdp(host, "cpu")
    assert len(exact.buckets) == 5 and len(quant.buckets) == 2
    state = _port_state(_random_state(jsdp.build_device_sdp(host, shape_policy="exact"),
                                      "classic", seed=2))
    tck.save_checkpoint(tmp_path, exact, state, verbosity=0)
    mine = tck.load_checkpoint(tmp_path, quant, verbosity=0)
    assert _same_state(mine, jck.load_checkpoint(tmp_path, jsdp.build_device_sdp(host),
                                                 verbosity=0))
    before, after = host_blocks(exact, state), host_blocks(quant, mine)
    assert before.keys() == after.keys()
    for idx in before:
        for name in FIELDS:
            assert np.array_equal(before[idx][name], after[idx][name]), (idx, name)


def _stub_seconds(sdp, params, n_timed=2):
    """A fixed s/iteration per bucket count, standing in for the JAX
    package's measurement (which would compile each candidate)."""
    return 0.01 * len(sdp.buckets)


def test_timing_run_record_like_jax(tmp_path, monkeypatch):
    host = _skewed_host()
    params = SolverParameters(precision=98, initial_matrix_scale_primal="1e2",
                              initial_matrix_scale_dual="1e2")
    rec = timing.timing_run(host, params, "cpu", verbosity=0)
    monkeypatch.setattr(jtiming, "_time_iterations", _stub_seconds)
    ref = jtiming.timing_run(host, JaxParameters(), verbosity=0)
    assert rec.keys() == ref.keys() and rec["version"] == 1
    assert [m.keys() for m in rec["measured"]] == [m.keys() for m in ref["measured"]]
    assert [(m["policy"], m["quant"], m["num_buckets"]) for m in rec["measured"]] == \
        [(m["policy"], m["quant"], m["num_buckets"]) for m in ref["measured"]] == \
        [("quantized", 8, 2), ("exact", 0, 2)]
    assert all(m["s_per_iteration"] > 0 for m in rec["measured"])
    best = min(rec["measured"], key=lambda m: m["s_per_iteration"])
    assert rec["chosen"] == {"policy": best["policy"], "quant": best["quant"]}
    assert rec["block_costs"].keys() == ref["block_costs"].keys()
    ratio = best["s_per_iteration"] / min(m["s_per_iteration"] for m in ref["measured"])
    for idx, cost in rec["block_costs"].items():
        assert cost == pytest.approx(ratio * ref["block_costs"][idx], rel=1e-12)
    b = host.blocks[0]
    assert planner.block_cost_heuristic(b.dim, b.num_points, b.bases_even.shape[1],
                                        b.bases_odd.shape[1], host.dual_dim) > 0
    timing.save_timings(tmp_path, rec)
    assert timing.load_timings(tmp_path) == json.loads(json.dumps(rec))
    assert jtiming.load_timings(tmp_path) == timing.load_timings(tmp_path)


@pytest.mark.parametrize("policy", ["quantized", "exact"])
def test_jax_timings_choose_the_port_buckets(policy, tmp_path, monkeypatch):
    host = mixed_sdp(K=2)
    monkeypatch.setattr(jtiming, "_time_iterations", _stub_seconds)
    rec = jtiming.timing_run(host, JaxParameters(), verbosity=0)
    rec["chosen"] = {"policy": policy, "quant": 8 if policy == "quantized" else 0}
    jtiming.save_timings(tmp_path, rec)
    shape_policy, quant = timing.bucketing(timing.load_timings(tmp_path))
    port = tsdp.build_device_sdp(host, "cpu", quant=quant, shape_policy=shape_policy)
    ref = jsdp.build_device_sdp(host, shape_policy=policy, quant=quant)
    assert len(port.buckets) == {"quantized": 2, "exact": 5}[policy]
    _assert_buckets_equal(port, ref)
    assert timing.bucketing(None) == ("quantized", 8)


def _cli(args, capsys):
    """The port's CLI in this process; (result, its standard output)."""
    res = cli.run([str(a) for a in args])
    return res, capsys.readouterr().out


def test_cli_writes_a_final_checkpoint_and_resumes(tmp_path, capsys):
    """-c writes the final checkpoint; running the same command again
    resumes from it (bit for bit the resume from the state in memory);
    -i resumes from another directory."""
    ck = tmp_path / "ck"
    cmd = ["-s", CERTIFICATE, "-o", tmp_path / "out", "-c", ck, *CLI_SOLVE,
           "--maxIterations", "1"]
    first, out = _cli(cmd, capsys)
    assert f"checkpoint dir  : {ck}" in out and "Loading" not in out
    assert f"Saving checkpoint to    : {ck}" in out
    assert json.loads((ck / tck.METADATA).read_text())["current"] == 0
    again, out = _cli(cmd, capsys)
    assert f"Loading binary checkpoint from : {ck / 'checkpoint_0.npz'}" in out
    sdp = tsdp.build_device_sdp(read_sdp(CERTIFICATE, 3), "cpu")
    params = cli.solver_params_from_args(cli.parse_with_param_file(
        cli.build_parser(), [str(a) for a in cmd]))
    memory = tsolve.run_solver(sdp, params, verbosity=0, initial=first.state)
    assert _same_state(again.state, memory.state)
    assert [r.mu.tobytes() for r in again.history] == [r.mu.tobytes() for r in memory.history]
    meta = json.loads((ck / tck.METADATA).read_text())
    assert (meta["current"], meta["backup"]) == (1, 0)
    other = tmp_path / "ck2"
    _, out = _cli(cmd[:5] + [other, "-i", ck] + cmd[6:], capsys)
    assert f"Loading binary checkpoint from : {ck / 'checkpoint_1.npz'}" in out
    assert (other / "checkpoint_0.npz").exists()


def test_cli_options_of_the_jax_cli(tmp_path, capsys):
    """--noFinalCheckpoint writes no checkpoint; -v2 writes the profile
    beside the checkpoint directory; --maxBlockMemory is accepted; the CPU
    by --platform, but not against --device cuda."""
    ck = tmp_path / "ck"
    _, out = _cli(["-s", CERTIFICATE, "-o", tmp_path / "out", "-c", ck, *CLI_SOLVE,
                   "--maxIterations", "1", "--noFinalCheckpoint", "--verbosity", "2",
                   "--maxBlockMemory", "4096"], capsys)
    assert "Saving checkpoint" not in out and not ck.exists()
    profile = json.loads((tmp_path / "ck.profiling" / "profiling.0").read_text())
    assert {"read_sdp", "run.chunk"} <= {r["name"] for r in profile}
    with pytest.raises(SystemExit, match="contradicts --device cuda"):
        cli.run(["-s", str(CERTIFICATE), "--platform", "cpu", "--device", "cuda"])


def test_cli_stops_at_a_reference_binary_checkpoint(tmp_path):
    """A reference binary checkpoint that does not fit the problem stops
    the run (its reader: tests/test_torch_ref_checkpoint.py); the run never
    starts afresh in its place."""
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "checkpoint_0_0").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="expected 15x1, found 0x0"):
        cli.run(["-s", str(CERTIFICATE), "-o", str(tmp_path / "out"), "-c", str(ck),
                 *CLI_SOLVE, "--maxIterations", "1", "--verbosity", "0"])
    assert not (tmp_path / "out").exists()


def test_cli_timing_run_then_reuse(tmp_path, capsys):
    """--timingRun auto on a 3-block problem measures both candidates and
    persists them; the same command again measures nothing; the JAX
    package reads the record."""
    write_sdp(tmp_path / "sdp.zip", random_sdp(num_blocks=3, dim=1, num_points=4,
                                                dual_dim=3, K=3, seed=2))
    ck = tmp_path / "ck"
    cmd = ["-s", tmp_path / "sdp.zip", "-o", tmp_path / "out", "-c", ck, *CLI_SOLVE,
           "--maxIterations", "1", "--timingRun", "auto"]
    _, out = _cli(cmd, capsys)
    assert "running 2-iteration timing run" in out and "timing run      : " in out
    rec = timing.load_timings(ck)
    assert [(m["policy"], m["num_buckets"]) for m in rec["measured"]] == \
        [("quantized", 1), ("exact", 1)]
    assert jtiming.load_timings(ck) == rec
    _, out = _cli(cmd, capsys)
    assert "timing run" not in out and "Loading binary checkpoint" in out
    _, out = _cli(cmd[:5] + [tmp_path / "ck2"] + cmd[6:-1] + ["never"], capsys)
    assert "timing run" not in out and not (tmp_path / "ck2" / timing.TIMINGS_FILE).exists()
