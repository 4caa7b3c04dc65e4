"""The port's host tools of outer_limits' front end (convert/poly.py,
convert/pmp.py's readers, tools/functions.py, tools/mesh.py,
tools/spectrum.py::fill_weights, cli/sdp2functions.py) against the JAX
package's.  All of it is mpmath on the host, copied: the results are held
equal, value for value, and the files byte for byte."""
import json
from pathlib import Path

import mpmath
import pytest

from sdpb_tpu.cli import sdp2functions as jcli
from sdpb_tpu.convert import pmp as jpmp
from sdpb_tpu.tools import functions as jfn, mesh as jmesh, spectrum as jspec
from sdpb_tpu_torch.cli import sdp2functions as tcli
from sdpb_tpu_torch.convert import pmp as tpmp
from sdpb_tpu_torch.convert.poly import Polynomial
from sdpb_tpu_torch.tools import functions as tfn, mesh as tmesh, spectrum as tspec

REPO = Path(__file__).resolve().parents[1]
CERT_PMP = REPO / "fixtures" / "dim2_certificate" / "pmp.json"
LADDER_PMP = REPO / "fixtures" / "ising_ladder_120" / "pmp.json"


def test_functions_roundtrip():
    """values -> coeffs -> Clenshaw evaluation reproduces a polynomial
    (tests/test_outer_limits.py::test_functions_roundtrip on the port)."""
    with mpmath.workprec(200):
        poly = Polynomial([mpmath.mpf(v) for v in ("1", "-2", "0.5", "3")])
        max_delta = mpmath.mpf(10)
        pts = tfn.chebyshev_points(6, max_delta)
        values = [poly(x) for x in pts]
        f = tfn.Function(max_delta=max_delta, epsilon_value=poly(0),
                         infinity_value=mpmath.mpf(3),
                         chebyshev_coeffs=tfn.values_to_coeffs(values))
        for x in (mpmath.mpf("0.37"), mpmath.mpf(5), mpmath.mpf("9.9")):
            assert abs(f.eval(-1, -2, x) - poly(x)) < mpmath.mpf("1e-45")
        assert f.eval(-1, -2, -1) == poly(0) and f.eval(-1, -2, -2) == 3
        with pytest.raises(ValueError):
            f.eval(-1, -2, mpmath.mpf(11))


def test_committed_certificate_pmp_is_the_test_pmp():
    from test_dim2_certificate import PMP

    assert json.loads(CERT_PMP.read_text()) == PMP


def _ladder_subset(tmp_path, blocks):
    doc = json.loads(LADDER_PMP.read_text())
    doc["PositiveMatrixWithPrefactorArray"] = [
        doc["PositiveMatrixWithPrefactorArray"][i] for i in blocks]
    path = tmp_path / "ladder_subset.json"
    path.write_text(json.dumps(doc))
    return path


@pytest.mark.parametrize("source,precision", [("certificate", 150), ("certificate", 216),
                                              ("ladder", 216)])
def test_sdp2functions_byte_identical(tmp_path, source, precision, capsys):
    """The port's sdp2functions writes the JAX package's file byte for byte:
    the certificate's PMP, and three of the ladder's blocks (the first, a
    middle and the last one: 2x2, N = 15, degree 18)."""
    pmp = CERT_PMP if source == "certificate" else _ladder_subset(tmp_path, (0, 60, 119))
    argv = ["-i", str(pmp), "--precision", str(precision)]
    assert tcli.main(argv + ["-o", str(tmp_path / "port.json")]) == 0
    assert jcli.main(argv + ["-o", str(tmp_path / "jax.json")]) == 0
    port, ref = (tmp_path / "port.json").read_bytes(), (tmp_path / "jax.json").read_bytes()
    assert port == ref
    doc = json.loads(port)
    assert len(doc["functions"]) == (1 if source == "certificate" else 3)
    assert len(doc["normalization"]) == (2 if source == "certificate" else 16)


def _same_functions(a, b):
    assert len(a) == len(b)
    for ba, bb in zip(a, b):
        for ra, rb in zip(ba, bb):
            for ca, cb in zip(ra, rb):
                for fa, fb in zip(ca, cb):
                    assert (fa.max_delta, fa.epsilon_value, fa.infinity_value) == \
                        (fb.max_delta, fb.epsilon_value, fb.infinity_value)
                    assert fa.chebyshev_coeffs == fb.chebyshev_coeffs


def test_read_functions_json_matches(tmp_path):
    """The functions reader gives the JAX package's Function blocks, value
    for value, and both evaluate them to the same numbers."""
    path = tmp_path / "f.json"
    tcli.main(["-i", str(_ladder_subset(tmp_path, (5,))), "-o", str(path),
               "--precision", "216"])
    with mpmath.workprec(216):
        to, tn, tf = tfn.read_functions_json(path)
        jo, jn, jf = jfn.read_functions_json(path)
        assert (to, tn) == (jo, jn)
        _same_functions(tf, jf)
        eps, inf = mpmath.mpf(2) ** -215, mpmath.mpf(10) ** 300
        for x in (eps, inf, mpmath.mpf("0.25"), mpmath.mpf(37)):
            assert tf[0][1][0][3].eval(eps, inf, x) == jf[0][1][0][3].eval(eps, inf, x)


def test_mesh_and_zeros_match():
    """The adaptive mesh and its zero finder give the JAX package's points
    (a quartic with two double roots and a near-zero dip)."""
    with mpmath.workprec(150):
        def f(x):
            return (x - 1) ** 2 * (x - mpmath.mpf("3.5")) ** 2 + \
                mpmath.mpf("0.01") * (x - 2) ** 2 - mpmath.mpf("1e-3")

        args = (mpmath.mpf(0), mpmath.mpf(6), f, mpmath.mpf("1e-3"), mpmath.mpf("1e-30"))
        tm, jm = tmesh.Mesh.create(*args), jmesh.Mesh.create(*args)

        def leaves(m, acc):
            acc.append((m.x, m.f))
            for child in (m.lower, m.upper):
                if child is not None:
                    leaves(child, acc)
            return acc

        assert leaves(tm, []) == leaves(jm, [])
        zeros = tmesh.get_zeros(tm, mpmath.mpf("1e-2"))
        assert zeros == jmesh.get_zeros(jm, mpmath.mpf("1e-2")) and zeros


def test_fill_weights_matches():
    with mpmath.workprec(200):
        y = [mpmath.mpf(v) for v in ("0.5", "-1.25", "3")]
        norm = [mpmath.mpf(v) for v in ("0.1", "-2", "0.3", "1")]
        w = tspec.fill_weights(y, 1, norm)
        assert w == jspec.fill_weights(y, 1, norm)
        assert abs(mpmath.fsum(n * x for n, x in zip(norm, w)) - 1) < mpmath.mpf("1e-55")


def test_pmp_readers_match(tmp_path):
    """read_pmp_input of JSON, of a nested .nsv list and of a Mathematica
    file, read_nsv_paths and max_normalization_index agree with the JAX
    package; a positive pole is refused."""
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "cert.json").write_text(CERT_PMP.read_text())
    (sub / "inner.nsv").write_bytes(b"cert.json\0")
    (tmp_path / "outer.nsv").write_bytes(b"sub/inner.nsv\0\0")
    assert tpmp.read_nsv_paths(tmp_path / "outer.nsv") == \
        jpmp.read_nsv_paths(tmp_path / "outer.nsv") == [sub / "cert.json"]
    with mpmath.workprec(150):
        for path in (CERT_PMP, tmp_path / "outer.nsv"):
            to, tn, tm = tpmp.read_pmp_input(path)
            jo, jn, jm = jpmp.read_pmp_input(path)
            assert (to, tn) == (jo, jn)
            assert [[[[p.coefficients for p in pv] for pv in r] for r in m.polynomials]
                    for m in tm] == \
                [[[[p.coefficients for p in pv] for pv in r] for r in m.polynomials]
                 for m in jm]
            assert tm[0].damped_rational.base == jm[0].damped_rational.base
        assert tpmp.max_normalization_index(tn) == jpmp.max_normalization_index(jn) == 0
        bad = json.loads(CERT_PMP.read_text())
        bad["PositiveMatrixWithPrefactorArray"][0]["DampedRational"]["poles"] = ["0.5"]
        (tmp_path / "bad.json").write_text(json.dumps(bad))
        with pytest.raises(ValueError, match="negative"):
            tpmp.read_pmp_input(tmp_path / "bad.json")
        from test_convert import MATHEMATICA_TOY

        (tmp_path / "p.m").write_text(MATHEMATICA_TOY)
        (to, tn, tm), (jo, jn, jm) = (pkg.read_pmp_input(tmp_path / "p.m")
                                      for pkg in (tpmp, jpmp))
        assert (to, tn) == (jo, jn) and len(tm) == len(jm) == 1
        assert [p.coefficients for p in tm[0].polynomials[0][0]] == \
            [p.coefficients for p in jm[0].polynomials[0][0]]
        assert tm[0].damped_rational.base == jm[0].damped_rational.base


def test_perturbed_pmp_keeps_the_structure():
    """torch_parity.perturbed_pmp, which made fixtures/ising_ladder_120/
    sdp_perturbed.zip: the same seed gives the same document; every
    coefficient and the objective move by a few delta relative (zeros stay
    zero), the normalization and the prefactors not at all, and each
    matrix stays symmetric."""
    from torch_parity import perturbed_pmp

    doc = json.loads(LADDER_PMP.read_text())
    doc["PositiveMatrixWithPrefactorArray"] = doc["PositiveMatrixWithPrefactorArray"][:2]
    new = perturbed_pmp(doc, 1e-8, seed=9)
    assert new == perturbed_pmp(doc, 1e-8, seed=9) != perturbed_pmp(doc, 1e-8, seed=8)
    assert new["normalization"] == doc["normalization"]
    with mpmath.workprec(300):
        def rel(a, b):
            a, b = mpmath.mpf(a), mpmath.mpf(b)
            return abs(a - b) / abs(b) if b else abs(a)

        pairs = list(zip(new["objective"], doc["objective"]))
        for m, o in zip(new["PositiveMatrixWithPrefactorArray"],
                        doc["PositiveMatrixWithPrefactorArray"]):
            assert m["DampedRational"] == o["DampedRational"]
            p = m["polynomials"]
            assert all(p[r][c] == p[c][r] for r in range(2) for c in range(2))
            pairs += [(x, y) for pv, qv in zip(p[1][0] + p[0][0] + p[1][1],
                                               o["polynomials"][1][0] + o["polynomials"][0][0]
                                               + o["polynomials"][1][1])
                      for x, y in zip(pv, qv)]
        errs = [rel(a, b) for a, b in pairs]
        assert max(errs) < 6e-8 and sum(e > 1e-10 for e in errs) > 0.9 * len(errs)
