"""Runs of several processes in the port (parallel/distributed.py,
parallel/mesh.py, the planner's slot plan, build_device_sdp(pad_to=),
the iteration's collectives, timing_run_broadcast) against the JAX
package on the CPU.  Ranks are processes on gloo with a file://
rendezvous (tests/torch_ranks.py).

Tolerances:
  * the slot plan and the block order equal the JAX package's, and so do
    the masks, block order and shapes of build_device_sdp(pad_to=2, 4);
  * one iteration at world size 4 on random_sdp(12 blocks, dim 2, 3
    points, N=4, K=2, seed 3) (the input of tests/test_sharding.py, with an
    objective constant of 1) against
    JAX's make_sharded_iteration on 4 virtual CPU devices, from the same
    sharded problem and state (interop): each MP statistic (they describe
    the input state) within 2^-90 relative (K=2 carries ~2^-106), the
    float64 statistics within 1e-12 relative, and every entry of the new
    state within 1e-12 of its array's largest entry: the JAX package's
    cross-device sum adds the float64 limbs, one rounding each, and keeps
    ~53 bits of Q (a reference defect; its new state differs from the
    port's by ~2e-16 here, its step lengths in the last bit).  The port's
    sum is exact to the representation (gathered, added in MP), and its
    world-4 state is held to its own one-process iteration (unpadded) within
    2^-90 of each array's largest entry (~1e-31 here), its statistics
    within 2^-90.  The primal objective and the duality gap are held to
    the one-process run only: JAX's sharded iteration counts the
    objective's constant once per device (a reference defect), the port
    once;
  * at world size 1 through a gloo group the iteration is the one-process
    iteration bit for bit (the MP sum of one rank's gathered value is the
    value itself);
  * timing_run_broadcast: both ranks return the same record, rank 0's
    block_timings.json, though rank 0 starts measuring only after a delay
    longer than the group's collective timeout;
  * _psum_mp over two ranks: both ranks hold the same limbs, each the exact
    sum within 2^-(bits - 4) of the larger addend (classic K=3, scaled K=3
    with exact zeros on one rank, two and three words); through a group of
    one rank, the identity bit for bit in every representation;
  * _pmax and _pmin over two ranks: the exact max and min on both ranks,
    and NaN on both where one rank holds a NaN (as torch.maximum and
    torch.minimum pass it on in one process).
"""
import functools
import json
import tempfile
from pathlib import Path

import mpmath
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax

from sdpb_tpu.models import sdp as jsdp
from sdpb_tpu.models.synthetic import random_sdp
from sdpb_tpu.parallel import mesh as jmesh, planner as jplanner
from sdpb_tpu.solver import state as jstate, step as jstep
from sdpb_tpu.utils.strings import str_to_limbs
from sdpb_tpu_torch import interop
from sdpb_tpu_torch.io.sdp_zip import read_sdp
from sdpb_tpu_torch.models import sdp as tsdp
from sdpb_tpu_torch.ops import mpfloat as tmp
from sdpb_tpu_torch.parallel import distributed, mesh, planner
from sdpb_tpu_torch.solver import solve as tsolve, state as tstate, step as tstep
from sdpb_tpu_torch.utils.strings import limbs_to_mpf

import torch_ranks
from test_torch_slice import CERTIFICATE

WORLD = 4
K = 2
OMEGA = "1e1"


@settings(max_examples=60, deadline=None)
@given(costs=st.lists(st.one_of(st.integers(0, 50), st.floats(0, 1e3)), max_size=40),
       n=st.integers(1, 9))
@pytest.mark.parametrize("plan", ["plan_block_slots", "plan_block_order"])
def test_plans_equal_jax(plan, costs, n):
    assert getattr(planner, plan)(costs, n) == getattr(jplanner, plan)(costs, n)


@pytest.mark.parametrize("pad_to", [2, 4])
def test_padded_layout_equals_jax(pad_to):
    """Masks, block order and shapes of the padded buckets, on the
    certificate (one block: padding only) and on a 12-block problem with
    the JAX package's measured-cost and heuristic placements."""
    cases = [(read_sdp(CERTIFICATE, 2), None),
             (random_sdp(num_blocks=12, dim=2, num_points=3, dual_dim=4, K=K, seed=3), None),
             (random_sdp(num_blocks=7, dim=1, num_points=5, dual_dim=3, K=K, seed=4),
              {str(i): float((5 * i) % 7) for i in range(7)})]
    for host, costs in cases:
        mine = tsdp.build_device_sdp(host, "cpu", pad_to=pad_to, block_costs=costs)
        ref = jax.tree.map(np.asarray, jsdp.build_device_sdp(host, pad_to=pad_to,
                                                             block_costs=costs))
        assert len(mine.buckets) == len(ref.buckets)
        for a, b in zip(mine.buckets, ref.buckets):
            assert [tuple(vars(r).values()) for r in a.real_sizes] == \
                [(r.block_index, r.num_points, r.h_even, r.h_odd) for r in b.real_sizes]
            assert a.batch % pad_to == 0 and a.batch == b.mask.shape[0]
            for f in ("mask", "row_mask", "psd_mask_even", "psd_mask_odd"):
                assert np.array_equal(getattr(a, f).numpy(), getattr(b, f)), f
            for f in ("bases_even", "emb_odd", "Bmat", "c"):
                assert np.array_equal(getattr(a, f).limbs.numpy(), getattr(b, f).limbs), f
        assert mine.total_psd_rows == sum(
            bk.shape.dim * (r.h_even + r.h_odd) for bk in ref.buckets
            for r in bk.real_sizes if r.block_index >= 0)


def _cfg(total_psd_rows, axis):
    return jstep.StepConfig(
        total_psd_rows=total_psd_rows, axis=axis, gamma=0.7,
        feasible_beta_limbs=str_to_limbs("0.1", K, np.float64),
        infeasible_beta_limbs=str_to_limbs("0.3", K, np.float64),
        primal_error_threshold=1e-15, dual_error_threshold=1e-15,
        max_complementarity=1e100)


def _port_cfg(total_psd_rows):
    return tstep.StepConfig(
        total_psd_rows=total_psd_rows, gamma=0.7,
        feasible_beta_limbs=str_to_limbs("0.1", K, np.float64),
        infeasible_beta_limbs=str_to_limbs("0.3", K, np.float64),
        primal_error_threshold=1e-15, dual_error_threshold=1e-15,
        max_complementarity=1e100)


@functools.lru_cache(maxsize=1)
def _jax_sharded():
    """JAX's sharded iteration on 4 virtual CPU devices: (problem, state,
    stats, new state) as numpy trees."""
    host = random_sdp(num_blocks=12, dim=2, num_points=3, dual_dim=4, K=K,
                      np_dtype=np.float64, seed=3)
    host.objective_const = np.array([1.0, 0.0])
    devices = jax.devices()
    if len(devices) < WORLD:
        pytest.skip(f"need {WORLD} JAX devices, have {len(devices)}")
    m = jmesh.make_mesh(devices[:WORLD])
    sdp = jsdp.build_device_sdp(host, pad_to=WORLD)
    omega = str_to_limbs(OMEGA, K, np.float64)
    state = jstate.initial_state(sdp, omega, omega)
    np_sdp, np_state = jax.tree.map(np.asarray, (sdp, state))
    sdp_sh, state_sh = jmesh.shard_sdp(sdp, m), jmesh.shard_state(state, m)
    it = jmesh.make_sharded_iteration(sdp_sh, state_sh,
                                      _cfg(sdp.total_psd_rows, jmesh.BLOCK_AXIS), m)
    stats, new = jax.tree.map(np.asarray, it(sdp_sh, state_sh))
    return host, np_sdp, np_state, stats, new


def _mpf(limbs):
    return limbs_to_mpf(np.asarray(limbs, np.float64))


def _close(a, b, rel):
    with mpmath.workprec(300):
        a, b = mpmath.mpf(a), mpmath.mpf(b)
        return abs(a - b) <= rel * abs(b)


def _assert_stats(got: tsolve.HostStats, want, rel=2.0 ** -90,
                  mp_fields=("primal_objective", "dual_objective", "duality_gap", "mu")):
    """HostStats against JAX stats (numpy) or other HostStats."""
    for f in mp_fields:
        w = getattr(want, f)
        assert _close(_mpf(getattr(got, f)), _mpf(getattr(w, "limbs", w)), rel), f
    for f in ("primal_error_P", "primal_error_p", "dual_error", "primal_step", "dual_step",
              "beta_corrector"):
        assert _close(getattr(got, f), float(np.asarray(getattr(want, f))), 1e-12), f
    assert got.is_pd_feasible == bool(np.asarray(want.is_pd_feasible))


def _distance(a, b) -> float:
    """The largest entry of |a - b| over the largest of |b|, for two
    classic limb stacks [K, ...] (the limb differences summed top down: the
    top one is exact where the values are close)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(sum(a[k] - b[k] for k in range(a.shape[0]))).max()
                 / np.abs(b[0]).max())


def _assert_near(a, b, rel=2.0 ** -90):
    assert _distance(a, b) <= rel, _distance(a, b)


def _bits(st: tsolve.HostStats) -> tuple:
    return tuple(np.asarray(v).tobytes() for v in st)


def test_sharded_iteration_at_world_4(tmp_path):
    """The port's iteration on 4 ranks against JAX's make_sharded_iteration
    on 4 devices from the same sharded problem and state, and against the
    port's own iteration in one process."""
    host, np_sdp, np_state, jstats, jnew = _jax_sharded()
    sdp1 = tsdp.build_device_sdp(host, "cpu")
    cfg = _port_cfg(sdp1.total_psd_rows)
    for r in range(WORLD):
        torch.save((interop.device_sdp_from_numpy(np_sdp, "cpu", r, WORLD),
                    interop.state_from_numpy(np_state, "cpu", r, WORLD), cfg),
                   tmp_path / f"shard_{r}.pt")
    out = torch_ranks.launch("iteration", WORLD, tmp_path)
    stats, state = out[0]["stats"], out[0]["state"]
    assert all(o["state"] is None for o in out[1:])
    assert all(_bits(o["stats"]) == _bits(stats) for o in out[1:])
    # the objective's constant term (1 here): the port counts it once (on
    # rank 0); JAX's sharded iteration psums it with each device's share,
    # once per device (sdpb_tpu/solver/step.py:391-395), so at x = 0 its
    # primal objective is 4 and its duality gap follows
    assert float(_mpf(stats.primal_objective)) == 1.0
    assert float(_mpf(jstats.primal_objective.limbs)) == float(WORLD)
    _assert_stats(stats, jstats, mp_fields=("dual_objective", "mu"))
    want = [jnew.y.limbs] + [getattr(b, f).limbs for b in jnew.buckets
                             for f in ("x", "X_even", "X_odd", "Y_even", "Y_odd")]
    for a, b in zip(tstep.state_tensors(state), want):
        _assert_near(a, b, 1e-12)

    # the port in one process, unpadded: the same blocks in block order
    omega = str_to_limbs(OMEGA, K, np.float64)
    stats1, new1 = tstep.make_iteration(cfg)(sdp1, tstate.initial_state(sdp1, omega, omega))
    _assert_stats(stats, tsolve.to_host(stats1))
    order = [r.block_index for r in np_sdp.buckets[0].real_sizes]
    slots = [s for s, i in enumerate(order) if i >= 0]
    blocks = [i for i in order if i >= 0]
    for f in ("x", "X_even", "X_odd", "Y_even", "Y_odd"):
        _assert_near(getattr(state.buckets[0], f).limbs[:, slots],
                     getattr(new1.buckets[0], f).limbs[:, blocks])
    _assert_near(state.y.limbs, new1.y.limbs)
    # the JAX package's sharded sum keeps ~53 bits: its y lies ~1e-16 from
    # the one-process iteration's, the port's world-4 y within 2^-90
    assert _distance(np.asarray(jnew.y.limbs), new1.y.limbs.numpy()) > 1e-20


def test_world_1_group_is_the_one_process_iteration(tmp_path):
    """Through a gloo group of one rank every collective is the identity
    (the MP sum of the one gathered value is the value itself): statistics
    and state bit for bit."""
    host = random_sdp(num_blocks=3, dim=2, num_points=3, dual_dim=3, K=3, seed=5)
    sdp = tsdp.build_device_sdp(host, "cpu")
    omega = str_to_limbs(OMEGA, 3, np.float64)
    state = tstate.initial_state(sdp, omega, omega)
    cfg = tstep.StepConfig(
        total_psd_rows=sdp.total_psd_rows, gamma=0.7,
        feasible_beta_limbs=str_to_limbs("0.1", 3, np.float64),
        infeasible_beta_limbs=str_to_limbs("0.3", 3, np.float64),
        primal_error_threshold=1e-15, dual_error_threshold=1e-15,
        max_complementarity=1e100, kkt_residual_threshold=1e-2)
    stats0, new0 = tstep.make_iteration(cfg)(sdp, state)
    group = distributed.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, "cpu",
                                   timeout_s=60, verbosity=0)
    try:
        assert (group.backend, group.world_size) == ("gloo", 1)
        stats1, new1 = tstep.make_iteration(cfg, group)(mesh.shard_sdp(sdp, 0, 1, "cpu"),
                                                        mesh.shard_state(state, 0, 1, "cpu"))
        whole = mesh.gather_state(new1, group)
    finally:
        group.close()
    assert torch.equal(tstep.pack_stats(stats0), tstep.pack_stats(stats1))
    assert all(torch.equal(a, b) for a, b in zip(tstep.state_tensors(new0),
                                                 tstep.state_tensors(whole)))


@functools.lru_cache(maxsize=1)
def _two_ranks():
    """One launch of tests/torch_ranks.py's collectives task on two ranks:
    (its results, its directory)."""
    tmp = Path(tempfile.mkdtemp(prefix="sdpb_two_ranks_"))
    return torch_ranks.launch("collectives", 2, tmp, {"timeout": 3, "delay": 4}), tmp


def test_timing_run_broadcast_gives_every_rank_the_same_record():
    out, tmp = _two_ranks()
    assert out[0]["record"] == out[1]["record"]
    assert json.loads((tmp / "ck" / "block_timings.json").read_text()) == out[0]["record"]
    assert {m["policy"] for m in out[0]["record"]["measured"]} == {"quantized", "exact"}


# the bits each representation carries: K=3 classic, K=3 scaled, two words
# of 5 and three words of 7 float32 limbs
PSUM_BITS = {"classic": 159, "scaled": 72, "wide2": 240, "wide3": 504}


@pytest.mark.parametrize("name", list(PSUM_BITS))
def test_psum_mp_over_two_ranks(name):
    """_psum_mp over two gloo ranks: the same limbs on both, and each
    element the exact sum of the ranks' values within 2^-(bits - 4) of
    the larger (scaled: where one rank holds exact zeros, the other's
    value exactly)."""
    out, _ = _two_ranks()
    assert out[0]["sums"][name] == out[1]["sums"][name]
    got = np.asarray(out[0]["sums"][name])
    parts = [tmp.host_f64_limbs(torch_ranks.psum_inputs(r)[name]) for r in (0, 1)]
    with mpmath.workprec(1200):
        for i in range(got.shape[1]):
            a, b = (sum(mpmath.mpf(float(x)) for x in p[:, i]) for p in parts)
            s = sum(mpmath.mpf(float(x)) for x in got[:, i])
            if name == "scaled" and i < 3:
                assert s == a
            assert abs(s - (a + b)) <= mpmath.mpf(2) ** (4 - PSUM_BITS[name]) * max(abs(a),
                                                                                  abs(b))


def test_psum_mp_at_world_1_is_the_identity(tmp_path):
    """Through a gloo group of one rank the MP sum of the one gathered
    value is the value itself, in every representation."""
    group = distributed.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, "cpu",
                                   timeout_s=60, verbosity=0)
    try:
        for name, v in torch_ranks.psum_inputs(0).items():
            got = tstep._psum_mp(v, group)
            for a, b in zip(getattr(got, "words", [got]), getattr(v, "words", [v])):
                assert torch.equal(a.limbs, b.limbs), name
                assert a.exp is None or torch.equal(a.exp, b.exp), name
    finally:
        group.close()


@pytest.mark.parametrize("name", ["vector", "scalar"])
def test_pmax_pmin_over_two_ranks_pass_a_nan_on(name):
    """_pmax and _pmin over two gloo ranks: both ranks read the same
    values, the exact max and min of the ranks' finite entries, and NaN
    wherever one rank holds a NaN."""
    out, _ = _two_ranks()
    parts = torch.stack([torch_ranks.pminmax_inputs(r)[name] for r in (0, 1)])
    for op, ref in (("max", torch.maximum), ("min", torch.minimum)):
        for o in out:
            got = np.asarray(o["extremes"][name][op], np.float64)
            want = ref(parts[0], parts[1]).double().numpy()
            assert np.array_equal(got, want, equal_nan=True), (op, got, want)
            assert np.isnan(got).any()
