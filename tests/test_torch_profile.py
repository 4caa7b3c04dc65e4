"""The port's per-phase profiler (sdpb_tpu_torch/tools/profile_phases.py)
and its peak probe (sdpb_tpu_torch/ops/kernels.py::peak_probe) against the
JAX tool (sdpb_tpu/tools/profile_phases.py) on the CPU.

Tolerances:
  * the flop model and `report`: equal (the same integers; the same floats
    under the renamed keys).
  * the probe: the plain version (the wrapper on a CPU tensor) equals a
    numpy loop of x * a + b with the multiply and the add rounded on their
    own, bit for bit.  The JAX tool's Pallas kernel, run in interpret mode,
    equals a single-rounding loop bit for bit instead (the float32 product,
    exact in float64, plus b, rounded to float32 once): XLA:CPU contracts
    x * a + b into a fused multiply-add even with the fusion emitters off.
    So the two lie within steps + 1 float32 ulps of each other, one half ulp
    per step and the last rounding.
  * PosdefSolver.from_parts: its solves equal the solver's it came from,
    bit for bit.
  * build_device_sdp(quant=32): buckets, masks and limbs equal JAX's.
  * the phases on the dim-2 certificate, classic K = 4 (factor 3 limbs, 2
    refinement passes), each run on its own chain and again from the JAX
    tool's inputs: within 2^-(53 Kf - 20) relative of the JAX tool's
    output at factor precision (the factors, the step-length eigenvalue)
    and 2^-(53 K - 20) at full precision (pairings, S, Q): the port's
    products and solves run the Pallas kernels' operation order, JAX on
    the CPU its XLA loops.  From the JAX tool's inputs, the phases whose
    IEEE sequence is the same equal the JAX tool's bit for bit: the X/Y,
    S and Q factors (right-looking, one rsqrt chain per pivot; the Newton
    seeds differ, and on these inputs the chains end on the same limbs),
    the Schur complement (gathers and elementwise MP products) and the
    step-length eigenvalue.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas

from sdpb_tpu.models import sdp as jsdp
from sdpb_tpu.models.synthetic import random_sdp
from sdpb_tpu.tools import profile_phases as jpp
from sdpb_tpu_torch import interop
from sdpb_tpu_torch.models import sdp as tsdp
from sdpb_tpu_torch.models.sdp import DeviceSDP
from sdpb_tpu_torch.ops import kernels as tk, linalg as tlin, mpfloat as tmp
from sdpb_tpu_torch.solver.state import SolverState
from sdpb_tpu_torch.tools import profile_phases as tpp

from torch_parity import T, limbs_of, rand_limbs, rand_scaled, rel_err

torch.set_num_threads(1)

CERTIFICATE = str(Path(__file__).resolve().parents[1] / "fixtures" / "dim2_certificate"
                  / "sdp.zip")
A32, B32 = np.float32(tpp.PROBE_A), np.float32(tpp.PROBE_B)
PHASES = ("cholesky_XY", "pairings", "schur_S", "S_cholesky", "SinvB_Q",
          "Q_cholesky", "step_length_eig(x1)")


# ---------------------------------------------------------------------------
# Flop model and report


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("K", list(range(2, 19)))
def test_flop_model_equals_jax(K, scaled):
    assert tpp.mul_flops(K, scaled) == jpp.mul_flops(K, scaled)
    assert tpp.add_flops(K, scaled) == jpp.add_flops(K, scaled)
    for m in (0, 1, K, 2 * K, K * K + 1, 4 * K * K):
        assert tpp.renorm_flops(m, K) == jpp.renorm_flops(m, K)
    for shape in ((1, K, K + 1, 3), (120, 20, 20, 19), (120, 15, 57, 15)):
        assert tpp.matmul_ops(*shape) == jpp.matmul_ops(*shape)
        assert tpp.cholesky_ops(*shape[:2]) == jpp.cholesky_ops(*shape[:2])
        assert tpp.trsm_ops(*shape[:3]) == jpp.trsm_ops(*shape[:3])


@pytest.mark.parametrize("peak", [0.0, 1234.5])
def test_report_gives_jax_numbers(peak):
    phases = [(name, 1e-3 * (i + 1) ** 1.5, 3.7e9 * (i + 2))
              for i, name in enumerate(PHASES)]
    want = jpp.report(phases, 0.0712, peak, 3)
    got = tpp.report(phases, 0.0712, peak, 3, "float64")
    keys = {"vpu_gflops": "gflops", "vpu_peak_gflops_measured": "peak_gflops_measured"}

    def renamed(d):
        return {keys.get(k, k): v for k, v in d.items()}

    assert got.pop("peak_dtype") == "float64"
    assert got == {**renamed(want), "phases": [renamed(r) for r in want["phases"]]}
    assert all(r.get("pct_of_peak", 0) is None for r in got["phases"][:-1]) == (peak == 0)
    json.dumps(got)


# ---------------------------------------------------------------------------
# Peak probe


def _numpy_unfused(x, steps, dtype):
    a, b = dtype(tpp.PROBE_A), dtype(tpp.PROBE_B)
    x = x.astype(dtype)
    for _ in range(steps):
        x = (x * a).astype(dtype) + b
    return x


def _numpy_single_rounding(x, steps):
    a, b = np.float64(A32), np.float64(B32)
    x = x.astype(np.float32)
    for _ in range(steps):
        x = (x.astype(np.float64) * a + b).astype(np.float32)
    return x


@pytest.mark.parametrize("steps", [1, 64, 256])
def test_probe_plain_is_the_unfused_chain(steps):
    rng = np.random.default_rng(steps)
    x = rng.uniform(0.5, 2.0, (8, 128))
    for dtype, tdt in ((np.float32, torch.float32), (np.float64, torch.float64)):
        tk.reset_launches()
        got = tk.peak_probe(torch.tensor(x, dtype=tdt), steps, tpp.PROBE_A, tpp.PROBE_B)
        assert got.dtype == tdt and tk.LAUNCHES["peak_probe"] == 0
        assert np.array_equal(got.numpy(), _numpy_unfused(x, steps, dtype))


@pytest.mark.parametrize("steps", [1, 64, 256])
def test_jax_probe_kernel_within_steps_ulps_of_the_plain_version(steps, monkeypatch):
    """The JAX tool's Pallas kernel in interpret mode (it calls pallas_call
    without interpret=True), its warm-up output captured at jax.device_get,
    on its own input (ones)."""
    orig_call, orig_get = jax.experimental.pallas.pallas_call, jax.device_get
    seen = []
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        lambda *a, **k: orig_call(*a, interpret=True, **k))
    monkeypatch.setattr(jax, "device_get", lambda x: seen.append(orig_get(x)) or seen[-1])
    gflops = jpp.vpu_peak_gflops(reps=1, steps=steps, tile=(8, 128))
    assert gflops > 0
    pallas = np.asarray(seen[0])
    ones = np.ones((8, 128))
    assert np.array_equal(pallas, _numpy_single_rounding(ones, steps))
    plain = tk.peak_probe(torch.ones(8, 128), steps, tpp.PROBE_A, tpp.PROBE_B).numpy()
    assert np.array_equal(plain, _numpy_unfused(ones, steps, np.float32))
    ulps = np.abs(pallas.view(np.int32).astype(np.int64) - plain.view(np.int32))
    assert ulps.max() <= steps + 1


def test_probe_refuses_what_it_cannot_take():
    for bad in (torch.ones(4, dtype=torch.int32), torch.ones(4, dtype=torch.float16)):
        with pytest.raises(TypeError):
            tk.peak_probe(bad, 2, tpp.PROBE_A, tpp.PROBE_B)
    with pytest.raises(ValueError):
        tk.peak_probe(torch.ones(4), -1, tpp.PROBE_A, tpp.PROBE_B)
    with pytest.raises(ValueError):
        tk.peak_probe(torch.ones(4, device="meta"), 2, tpp.PROBE_A, tpp.PROBE_B)
    with pytest.raises(ValueError):
        tpp.cuda_core_peak_gflops(steps=2, tile=(2, 2), device="cpu")


# ---------------------------------------------------------------------------
# PosdefSolver.from_parts, build_device_sdp(quant)


@pytest.mark.parametrize("scaled", [False, True])
def test_posdef_solver_from_parts_solves_like_its_source(scaled):
    rng = np.random.default_rng(5)
    K, Kf, n = (4, 2, 6) if scaled else (3, 2, 6)
    G = rng.standard_normal((2, n, n))
    top = G @ np.swapaxes(G, -1, -2) + n * np.eye(n)
    if scaled:
        A64 = rand_limbs(rng, (2, n, n), 3)
        A64[1:] *= np.abs(top / A64[0])
        A64[0] = top
        A = T(tmp.f64_limbs_to_scaled_parts((A64 + np.swapaxes(A64, -1, -2)) / 2, K))
        B = T(rand_scaled(rng, (2, n, 3), K, decades=2.0))
    else:
        A64 = rand_limbs(rng, (2, n, n), K)
        A64[1:] *= np.abs(top / A64[0])
        A64[0] = top
        A = T((A64 + np.swapaxes(A64, -1, -2)) / 2)
        B = T(rand_limbs(rng, (2, n, 3), K))
    src = tlin.PosdefSolver(A, Kf)
    back = tlin.PosdefSolver.from_parts(src.A, src.L, Kf)
    assert back.Kf == Kf and back.A is src.A and back.L is src.L
    for n_refine in (0, 2):
        x, y = back.solve(B, n_refine), src.solve(B, n_refine)
        assert torch.equal(x.limbs, y.limbs)
        assert x.exp is None or torch.equal(x.exp, y.exp)
    assert rel_err(tlin.matmul(A, src.solve(B, 2)), B) < 2.0 ** -(24 if scaled else 53) * 4


def _mixed_points_sdp():
    """A random SDP whose blocks have 3..33 points, so that quant 8 and
    quant 32 bucket them differently."""
    host = None
    for i, npts in enumerate((3, 5, 9, 12, 17, 20, 33)):
        part = random_sdp(num_blocks=1, dim=2, num_points=npts, dual_dim=3, K=2, seed=i)
        part.blocks[0].index = i
        if host is None:
            host = part
        else:
            host.blocks.append(part.blocks[0])
    return host


@pytest.mark.parametrize("quant", [8, 32])
def test_build_device_sdp_buckets_like_jax(quant):
    host = _mixed_points_sdp()
    port = tsdp.build_device_sdp(host, "cpu", quant=quant)
    ref = jsdp.build_device_sdp(host, quant=quant)
    assert len(port.buckets) == len(ref.buckets) == {8: 4, 32: 2}[quant]
    for pb, rb in zip(port.buckets, ref.buckets):
        assert (pb.shape.dim, pb.shape.num_points, pb.shape.h_even, pb.shape.h_odd) == \
            (rb.shape.dim, rb.shape.num_points, rb.shape.h_even, rb.shape.h_odd)
        assert [r.block_index for r in pb.real_sizes] == [r.block_index for r in rb.real_sizes]
        for f in ("bases_even", "bases_odd", "emb_even", "emb_odd", "Bmat", "c",
                  "mask", "row_mask", "psd_mask_even", "psd_mask_odd"):
            a, b = limbs_of(getattr(pb, f)), limbs_of(getattr(rb, f))
            assert a.shape == b.shape and np.array_equal(a, b), f
    assert tsdp.bucket_key(2, 17, "quantized", quant) == \
        jsdp.bucket_key(2, 17, "quantized", quant)
    assert tsdp.bucket_key(2, 17) == (2, 24)


# ---------------------------------------------------------------------------
# The phases, port against the JAX tool


def _port(x):
    """A JAX tool output (MP, factor parts, nested lists) as the port's:
    (A, L, dinv) parts lose dinv, which the port's solver does not keep."""
    if isinstance(x, list):
        return [_port(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_port(v) for v in (x[:2] if len(x) == 3 else x))
    if hasattr(x, "limbs"):
        return interop._mp(x, "cpu")
    return torch.tensor(np.asarray(x))


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _flat(e)]
    return [x]


@pytest.fixture(scope="module")
def certificate_phases():
    """Each phase's output from the JAX tool and from the port (its own
    chain, and each phase again from the JAX tool's inputs), the timing
    stubbed to one call; the total iteration is not run."""
    jax_runs = []

    def jax_time(fn, args, reps):
        if len(jax_runs) == len(PHASES):
            return 1e-3, None
        out = fn(*args)
        jax_runs.append((args, out))
        return 1e-3, out

    port_runs = []

    def port_time(fn, args, reps, device):
        if len(port_runs) == len(PHASES):
            return 1e-3, None
        jargs, _ = jax_runs[len(port_runs)]
        from_jax = [a if isinstance(a, (DeviceSDP, SolverState)) else _port(j)
                    for a, j in zip(args, jargs)]
        port_runs.append((fn(*args), fn(*from_jax)))
        return 1e-3, port_runs[-1][0]

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jpp, "_time_fn", jax_time)
        mp.setattr(tpp, "_time_fn", port_time)
        mp.setattr(tpp, "_time_samples", lambda fn, args, reps, device: ([1e-3] * reps, None))
        jph, _ = jpp.profile_fixture(CERTIFICATE, 0, 32, "1e6", 1, use_cache=False)
        tph, _ = tpp.profile_fixture(CERTIFICATE, 0, 32, "1e6", 1, "cpu")
    finally:
        mp.undo()
    return jph, tph, [o for _, o in jax_runs], port_runs


def _rel(got, want) -> float:
    if isinstance(got, tmp.MP):
        return rel_err(got, want)
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("i", range(len(PHASES)))
def test_certificate_phase_matches_jax(certificate_phases, i):
    jph, tph, jax_outs, port_runs = certificate_phases
    K, Kf = 4, 3                        # Omega = 1e6: factor 3 limbs, 2 passes
    assert [p[0] for p in tph] == [p[0] for p in jph] == list(PHASES)
    assert tph[i][2] == jph[i][2]       # the flop count
    want = _flat(_port(jax_outs[i]))
    at_factor = PHASES[i] in ("cholesky_XY", "S_cholesky", "Q_cholesky",
                              "step_length_eig(x1)")
    bound = 2.0 ** -(53 * (Kf if at_factor else K) - 20)
    for run in port_runs[i]:
        got = _flat(run)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(g, tmp.MP):
                assert g.K == w.K and g.shape == w.shape
            assert _rel(g, w) <= bound, (PHASES[i], _rel(g, w))
    if PHASES[i] not in ("pairings", "SinvB_Q"):
        for g, w in zip(_flat(port_runs[i][1]), want):
            assert torch.equal(g.limbs, w.limbs) if isinstance(g, tmp.MP) else \
                torch.equal(g, w), PHASES[i]


def test_main_writes_every_phase_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "phases.json"
    assert tpp.main(["--fixture", CERTIFICATE, "--scaledLimbs", "0", "--reps", "1",
                     "--device", "cpu", "--json", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == rec
    assert rec["platform"] == "cpu" and "card" not in rec
    assert rec["peak_gflops_measured"] == 0.0 and rec["peak_dtype"] == "float64"
    assert [r["phase"] for r in rec["phases"][:-1]] == list(PHASES)
    for r in rec["phases"][:-1]:
        assert r["ms"] > 0 and r["pct_of_peak"] is None and r["gflops"] >= 0
    assert rec["iteration_ms"] > 0 and rec["reps"] == 1
    assert rec["iteration_samples_ms"] == [rec["iteration_ms"]]


def test_main_refuses_a_missing_card_and_bad_limbs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tpp.main(["--fixture", CERTIFICATE, "--scaledLimbs", "0", "--device", "cuda"])
    for bad in ("1", "28"):
        with pytest.raises(SystemExit):
            tpp.main(["--fixture", CERTIFICATE, "--scaledLimbs", bad, "--device", "cpu"])
