"""One interior-point iteration of the port in three words against the JAX
package's classic iteration, and a resume of a three-word state from its
checkpoint file, on the CPU (the companion of tests/test_torch_wide3.py,
in a file of its own: each three-word iteration takes ~25 s here).

Three words of Kg = 3 limbs (through a widened wide_config and a lowered
mpfloat.MAX_SCALED_K, as tests/test_torch_slice.py runs two words of 3);
the JAX package's three-word iteration would compile for far too long on
the CPU.

Tolerances:
  * the iteration from the JAX classic state (K = 3, 159 bits) after one
    iteration of the smallest random problem, rounded into three words,
    against the JAX classic iteration from that state: MP statistics
    within 2^-(159-24) relative, step lengths and the next state within
    1e-12 relative, float32 error norms within 2^-20 relative (the
    tolerances of tests/test_torch_slice.py's two-word iteration, against
    the classic run's precision, here the lower one);
  * a state's checkpoint loads bit for bit, so a resume from the file is
    the resume from memory; the resumed iteration's state saves and loads
    bit for bit too.
"""
import json

import mpmath
import numpy as np
import torch

from sdpb_tpu.utils.strings import limbs_to_mpf
from sdpb_tpu_torch import interop
from sdpb_tpu_torch.io.sdp_zip import read_sdp
from sdpb_tpu_torch.models import sdp as tsdp
from sdpb_tpu_torch.ops import mpfloat as tmp, mpwide as tmw
from sdpb_tpu_torch.solver import checkpoint as tck, solve as tsolve, state as tstate
from sdpb_tpu_torch.solver import step as tstep
from sdpb_tpu_torch.solver.params import SolverParameters
from sdpb_tpu_torch.utils.strings import str_to_scaled_limbs

from test_torch_mpwide3 import three_wide_config
from test_torch_slice import CERTIFICATE, _cmp, _jax_cfg, _jax_two_iterations, _problem
from test_torch_wide3 import _same_state
from torch_parity import limbs_of

torch.set_num_threads(1)

K = 9


def test_one_three_word_iteration_from_jax_classic_state(monkeypatch):
    """The port's three-word iteration (Kg = 3, factor 3 limbs, 3
    refinement passes) from the JAX classic state after one iteration of
    the smallest random problem, rounded into three words, against the JAX
    classic iteration from that state (tolerances in the module
    docstring)."""
    monkeypatch.setattr(tmp, "MAX_SCALED_K", 5)
    monkeypatch.setattr(tmw, "wide_config", three_wide_config)
    host, params, Kc = _problem("dim1_K3")
    sdp_np, st1_np, s2, st2 = _jax_two_iterations("dim1_K3")
    sdp = interop.device_sdp_from_numpy(sdp_np, "cpu")
    wide = lambda x: tmw.wide_parts_to_mp(tmw.f64_limbs_to_wide_parts(limbs_of(x), K), "cpu")
    sdp = tsdp.DeviceSDP(objective_const=wide(sdp.objective_const), b=wide(sdp.b),
                         buckets=[tsdp.Bucket(**{
                             **{f: wide(getattr(bk, f)) for f in (
                                 "bases_even", "bases_odd", "emb_even", "emb_odd",
                                 "Bmat", "c")},
                             **{f: getattr(bk, f).to(torch.float32) for f in (
                                 "mask", "row_mask", "psd_mask_even", "psd_mask_odd")},
                             "real_sizes": bk.real_sizes, "shape": bk.shape})
                             for bk in sdp.buckets])
    assert sdp.b.G == 3 and sdp.b.Kg == 3
    st1 = tstate.SolverState(
        y=wide(st1_np.y.limbs),
        buckets=[tstate.BucketState(*(wide(getattr(bs, f).limbs) for f in (
            "x", "X_even", "X_odd", "Y_even", "Y_odd"))) for bs in st1_np.buckets])
    jcfg = _jax_cfg(sdp_np, params, Kc)
    parse = lambda v: str_to_scaled_limbs(v, K)
    assert isinstance(parse("0.3"), list) and len(parse("0.3")) == 3
    tcfg = tstep.StepConfig(
        total_psd_rows=sdp.total_psd_rows, gamma=jcfg.gamma,
        feasible_beta_limbs=parse(params.feasible_centering_parameter),
        infeasible_beta_limbs=parse(params.infeasible_centering_parameter),
        primal_error_threshold=jcfg.primal_error_threshold,
        dual_error_threshold=jcfg.dual_error_threshold,
        max_complementarity=jcfg.max_complementarity,
        factor_limbs=3, n_refine=3, kkt_residual_threshold=jcfg.kkt_residual_threshold,
        kkt_heal=False)
    stats, new = tstep.make_iteration(tcfg)(sdp, st1)
    h = tsolve.to_host(stats)
    assert isinstance(h.mu, list) and len(h.mu) == 3
    with mpmath.workprec(300):
        for f in ("primal_objective", "dual_objective", "duality_gap", "mu"):
            mine, ref = tsolve.host_mpf(getattr(h, f)), limbs_to_mpf(getattr(s2, f).limbs)
            assert abs(mine - ref) <= mpmath.mpf(2) ** -(53 * Kc - 24) * abs(ref), f
    for f in ("primal_step", "dual_step"):
        _cmp(f, getattr(h, f), getattr(s2, f), 1e-12, 0.0)
    for f in ("primal_error_P", "primal_error_p", "dual_error"):
        _cmp(f, getattr(h, f), getattr(s2, f), 2.0 ** -20, 2.0 ** -(53 * Kc - 40))
    assert h.is_pd_feasible == bool(s2.is_pd_feasible)
    back = lambda m: tmp.host_f64_limbs(m, Kc)
    _cmp("y", back(new.y), st2.y.limbs, 1e-12, 2.0 ** -(53 * Kc - 40), True)
    for gb, jb in zip(new.buckets, st2.buckets):
        for f in ("x", "X_even", "X_odd", "Y_even", "Y_odd"):
            _cmp(f, back(getattr(gb, f)), getattr(jb, f).limbs, 1e-12,
                 2.0 ** -(53 * Kc - 40), True)


def test_three_word_checkpoint_round_trip_and_resume(tmp_path, monkeypatch):
    """Three words of 3 limbs: the certificate's initial state saved and
    loaded bit for bit (so a resume from the file is the resume from
    memory), and one iteration resumed from the file: its statistics and
    its next state finite, three words each; a second save keeps the
    generations."""
    monkeypatch.setattr(tmp, "MAX_SCALED_K", 5)
    monkeypatch.setattr(tmw, "wide_config", three_wide_config)
    sdp = tsdp.build_device_sdp(read_sdp(CERTIFICATE, 6), "cpu", scaled_limbs=K)
    params = SolverParameters(precision=208, initial_matrix_scale_primal="1e2",
                              initial_matrix_scale_dual="1e2", factor_limbs=3,
                              max_iterations=0)
    state = tstate.initial_state(sdp, str_to_scaled_limbs("1e2", K),
                                 str_to_scaled_limbs("1e2", K))
    assert state.y.G == 3
    tck.save_checkpoint(tmp_path, sdp, state, verbosity=0)
    loaded = tck.load_checkpoint(tmp_path, sdp, verbosity=0)
    assert _same_state(loaded, state)
    res = tsolve.run_solver(sdp, params, verbosity=0, initial=loaded, chunk_iterations=1)
    assert len(res.history) == 1 and res.state.y.G == 3
    h = res.history[0]
    assert np.isfinite(h.primal_step) and h.primal_step > 0 and h.dual_step > 0
    assert all(np.all(np.isfinite(w.limbs.numpy())) for v in [res.state.y]
               for w in v.words)
    tck.save_checkpoint(tmp_path, sdp, res.state, verbosity=0)
    meta = json.loads((tmp_path / tck.METADATA).read_text())
    assert (meta["current"], meta["backup"]) == (1, 0)
    assert _same_state(tck.load_checkpoint(tmp_path, sdp, verbosity=0), res.state)
