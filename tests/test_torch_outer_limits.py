"""The port's outer_limits (tools/outer_limits.py, the CLI) on the CPU,
against the JAX package and against the dim-2 certificate's bisected
optimum.

The run: the certificate's PMP (fixtures/dim2_certificate/pmp.json, the
PMP of tests/test_dim2_certificate.py) through the port's sdp2functions at
100 bits, initial points [0.5, 1, 2], --precision 100, gap threshold 1e-6,
Omega 1e2.  The JAX package's CLI on the same inputs compiles its solver
for minutes on the CPU, once per round's shape, so its out.json is
committed (fixtures/dim2_certificate/outer_limits_jax.json, made by
`python -m sdpb_tpu.cli.outer_limits` with these flags from a directory
holding functions.json and points.json); the host steps of a round are
held to the JAX package's functions directly.

Tolerances:
  * the host steps (constraints, the SVD y-transform, the SDP's host data,
    the search for new points, the checkpoint's contents): equal, value
    for value (the same mpmath operations).
  * out.json against the JAX package's: optimal and every weight within
    1e-20.  The JAX package pads each bucket's batch to a multiple of 8 and
    orders its blocks for a device mesh (build_device_sdp(host, pad_to=8));
    the port pads none.  The padded blocks add exact zeros to every sum,
    but the packages sum in different orders (the kernels' and XLA's), so
    the iterates agree to ~1e-25, not bit for bit.
  * the bisected optimum -y* = 1.685650770619604657526474: within the final
    gap threshold, 1e-6.
  * a run stopped after its first checkpoint and resumed from it (the
    port's file, which the JAX package reads to the same contents, written
    again by the JAX package): within 1e-20 of the uninterrupted run.
"""
import json
import shutil
from pathlib import Path

import mpmath
import numpy as np
import pytest
import torch

from sdpb_tpu.convert.pmp import max_normalization_index
from sdpb_tpu.tools import functions as jfn, outer_limits as jol
from sdpb_tpu_torch.cli import outer_limits as cli, sdp2functions
from sdpb_tpu_torch.tools import functions as tfn, outer_limits as tol

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CERT = REPO / "fixtures" / "dim2_certificate"
BISECTED = "1.685650770619604657526474"
PREC = 100
FLAGS = ["--precision", str(PREC), "--dualityGapThreshold", "1e-6",
         "--primalErrorThreshold", "1e-10", "--dualErrorThreshold", "1e-10",
         "--initialMatrixScalePrimal", "1e2", "--initialMatrixScaleDual", "1e2"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("outer")
    assert sdp2functions.main(["-i", str(CERT / "pmp.json"), "-o", str(d / "functions.json"),
                               "--precision", str(PREC)]) == 0
    (d / "points.json").write_text('{"points": [["0.5", "1", "2"]]}')
    return d


def _run(inputs, out, *extra, rounds=None):
    return cli.run(["--functions", str(inputs / "functions.json"), "--points",
                    str(inputs / "points.json"), "--out", str(out), "--device", "cpu",
                    "--verbosity", "0"] + FLAGS + list(extra), rounds=rounds)


@pytest.fixture(scope="module")
def full_run(inputs):
    """The uninterrupted run, its first outer checkpoint kept aside in
    first_ck/ (what a run killed right after it leaves behind)."""
    save = tol.save_outer_checkpoint

    def save_and_keep_the_first(directory, *args, **kw):
        gen = save(directory, *args, **kw)
        if not (inputs / "first_ck").exists():
            shutil.copytree(directory, inputs / "first_ck")
        return gen

    rounds = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tol, "save_outer_checkpoint", save_and_keep_the_first)
        out = _run(inputs, inputs / "out.json", "-c", str(inputs / "ck"), rounds=rounds)
    return out, rounds


def _close(a, b, tol):
    with mpmath.workprec(400):
        return abs(mpmath.mpf(a) - mpmath.mpf(b)) <= mpmath.mpf(tol)


def test_matches_jax_and_the_bisected_optimum(inputs, full_run):
    out, rounds = full_run
    assert json.loads((inputs / "out.json").read_text()) == out
    ref = json.loads((CERT / "outer_limits_jax.json").read_text())
    assert ref["options"]["precision"] == str(PREC)
    assert _close(out["optimal"], ref["optimal"], "1e-20"), (out["optimal"], ref["optimal"])
    assert len(out["y"]) == len(ref["y"]) == 2
    assert all(_close(a, b, "1e-20") for a, b in zip(out["y"], ref["y"]))
    assert _close(out["optimal"], BISECTED, "1e-6")
    # three rounds of 5, 6 and 7 constraints; the threshold falls to 1e-6
    assert [r["constraints"] for r in rounds][0] == 5 and rounds[-1]["constraints"] == 7
    assert all(r["reason"] == "found primal-dual optimal solution" for r in rounds)
    assert all(r["host_s"] >= 0 and r["solve_s"] > 0 and r["capture_s"] == 0
               for r in rounds)


def test_host_steps_match_jax(inputs):
    """One round's host work in both packages: constraints, the SVD
    y-transform, the SDP's host data (with its empty odd parity) and the
    new points of a weighted functional."""
    with mpmath.workprec(PREC):
        obj, norm, fns = tfn.read_functions_json(inputs / "functions.json")
        jobj, jnorm, jfns = jfn.read_functions_json(inputs / "functions.json")
        inf = mpmath.mpf(np.finfo(np.float64).max)
        eps = mpmath.mpf(2) ** (1 - PREC)
        mi = max_normalization_index(norm)
        pts = [{eps, inf} | {mpmath.mpf(v) for v in ("0.5", "1", "2")}]
        c, fv = tol.setup_constraints(mi, fns, norm, pts, eps, inf)
        assert (c, fv) == jol.setup_constraints(mi, jfns, jnorm, pts, eps, inf)
        oc = obj[mi] / norm[mi]
        b = [obj[i] - norm[i] * oc for i in range(len(norm)) if i != mi]
        T, bs, cs = tol.compute_y_transform(c, fv, b, True)
        jT, jbs, jcs = jol.compute_y_transform(c, fv, b, True)
        assert (T.tolist(), bs, cs) == (jT.tolist(), jbs, jcs)
        host = tol._build_sdp_data(oc, bs, c, fv, [2] * 5, T, cs, 2)
        ref = jol._build_sdp_data(oc, bs, c, fv, [2] * 5, T, cs, 2, np.float64)
        assert np.array_equal(host.b, ref.b)
        assert np.array_equal(host.objective_const, ref.objective_const)
        for h, r in zip(host.blocks, ref.blocks):
            assert (h.index, h.dim, h.num_points) == (r.index, r.dim, r.num_points)
            for f in ("bases_even", "bases_odd", "c", "B"):
                assert np.array_equal(getattr(h, f), getattr(r, f)), f
            assert h.bases_odd.shape == (2, 0, 1)
        w = [mpmath.mpf("1.0"), mpmath.mpf("-1.7")]    # beyond the optimum: a dip
        got = tol._find_block_new_points(fns[0], w, pts[0], eps, inf, mpmath.mpf("1e-3"))
        assert got == jol._find_block_new_points(jfns[0], w, pts[0], eps, inf,
                                                 mpmath.mpf("1e-3"))
        assert got


def test_checkpoint_resumes_across_packages(inputs, full_run, tmp_path):
    """A run's first outer checkpoint (full_run's, as a run killed right
    after writing it leaves it) resumes and ends where the uninterrupted
    run ends.  The port's checkpoint loads in the JAX package to the
    contents the port loads; the resume reads the file the JAX package
    writes from them."""
    shutil.copytree(inputs / "first_ck", tmp_path / "ck")
    with mpmath.workprec(PREC):
        inf = mpmath.mpf(np.finfo(np.float64).max)
        mine = tol.load_outer_checkpoint(tmp_path / "ck", inf, verbosity=0)
        ref = jol.load_outer_checkpoint(tmp_path / "ck", inf, verbosity=0)
        assert mine.keys() == ref.keys()
        for k in mine:
            v, r = mine[k], ref[k]
            assert (v.tolist() if k == "yp_to_y" else v) == (r.tolist() if k == "yp_to_y" else r)
        assert len(mine["points"][0]) == 5
        jol.save_outer_checkpoint(tmp_path / "jax_ck", ref["generation"], ref["threshold"],
                                  ref["c_scale"], ref["yp"], ref["points"], inf,
                                  ref["yp_to_y"], ref["b_star"], verbosity=0)
    out = _run(inputs, tmp_path / "resumed.json", "-c", str(tmp_path / "jax_ck"))
    full, _ = full_run
    assert _close(out["optimal"], full["optimal"], "1e-20"), (out["optimal"], full["optimal"])
    assert all(_close(a, b, "1e-20") for a, b in zip(out["y"], full["y"]))
    # a checkpoint of a finished run returns its result without solving
    again = _run(inputs, tmp_path / "again.json", "-c", str(inputs / "ck"))
    assert again["optimal"] == full["optimal"]


def test_cli_refuses_a_missing_card(inputs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.run(["--functions", str(inputs / "functions.json"), "--points",
                 str(inputs / "points.json"), "--out", str(tmp_path / "o.json")] + FLAGS)


def test_points_nsv_recursion(tmp_path):
    (tmp_path / "a.json").write_text('{"points": [["1", "2"]]}')
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.json").write_text('{"points": [["3"], ["4.5"]]}')
    (tmp_path / "sub" / "inner.nsv").write_bytes(b"b.json\0")
    (tmp_path / "all.nsv").write_bytes(b"a.json\0sub/inner.nsv\0")
    with mpmath.workprec(64):
        assert cli.read_points(tmp_path / "all.nsv") == [
            [mpmath.mpf(1), mpmath.mpf(2)], [mpmath.mpf(3)], [mpmath.mpf("4.5")]]
