"""The port's spectrum (tools/spectrum.py, cli/spectrum.py) at the end of a
bootstrap study on the port alone: the toy PMP of tests/test_spectrum.py
(one block, base 1/e) through the port's sdp2input at 512 bits, a CPU solve
through the port's sdpb CLI (--writeSolution x,y), then the port's
spectrum.  Its zero is held to the independently computed double root of
the optimal functional, x0 = 1.042496785718158..., within 1e-5 (the JAX
test's value and tolerance); and the JAX package's spectrum (host mpmath,
nothing compiled) run on the port's solution directory writes the same
spectrum.json byte for byte, for PMP input (JSON and Mathematica) and for
the PVM XML the port's write_bootstrap_sdp writes."""
import json
import random
from pathlib import Path

import mpmath
import pytest

from sdpb_tpu.cli import spectrum as jspec_cli
from sdpb_tpu.tools import spectrum as jspec
from sdpb_tpu_torch.cli import sdp2input, sdpb, spectrum as tspec_cli
from sdpb_tpu_torch.convert import pmp as tpmp
from sdpb_tpu_torch.tools import spectrum as tspec, write_bootstrap_sdp as twbs

from test_convert import MATHEMATICA_TOY
from test_spectrum import TOY_PMP

REPO = Path(__file__).resolve().parents[1]
X0 = "1.042496785718158120984007"


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy converted and solved by the port on the CPU: (dir, solution)."""
    d = tmp_path_factory.mktemp("toy")
    (d / "toy.json").write_text(json.dumps(TOY_PMP))
    (d / "toy.m").write_text(MATHEMATICA_TOY)
    assert sdp2input.convert(d / "toy.json", d / "sdp.zip", 512, "json") == 1
    res = sdpb.run(["-s", str(d / "sdp.zip"), "-o", str(d / "out"), "-c", str(d / "ck"),
                    "--device", "cpu", "--precision", "96", "--dualityGapThreshold", "1e-15",
                    "--primalErrorThreshold", "1e-15", "--dualErrorThreshold", "1e-15",
                    "--initialMatrixScalePrimal", "1e2", "--initialMatrixScaleDual", "1e2",
                    "--maxIterations", "250", "--verbosity", "0", "--writeSolution", "x,y"])
    assert str(res.terminate_reason) == "found primal-dual optimal solution"
    with mpmath.workprec(512):
        twbs.write_bootstrap_sdp(d / "toy.xml", *tpmp.read_pmp_input(d / "toy.json"))
    return d, d / "out"


def _one_zero_at_x0(path):
    doc = json.loads(Path(path).read_text())
    assert len(doc) == 1 and len(doc[0]["zeros"]) == 1, doc
    with mpmath.workprec(200):
        zero = mpmath.mpf(doc[0]["zeros"][0]["zero"])
        assert abs(zero - mpmath.mpf(X0)) < mpmath.mpf("1e-5"), mpmath.nstr(zero, 12)
    return doc


def test_spectrum_of_the_ports_solution(toy, tmp_path, capsys):
    """The port's spectrum and the JAX package's on the port's solution, for
    the PMP as JSON (with and without the lambda fit) and as Mathematica,
    and for the PVM XML: the same file, one zero at x0."""
    d, sol = toy
    for source, fmt, need_lambda in (("toy.json", "PMP", "true"), ("toy.json", "PMP", "false"),
                                     ("toy.m", "PMP", "true"), ("toy.xml", "PVM", "true")):
        argv = ["--input", str(d / source), "--solution", str(sol), "--precision", "96",
                "--threshold", "1e-8", "--format", fmt, "--lambda", need_lambda, "--output"]
        port, ref = tmp_path / f"port_{source}_{need_lambda}.json", tmp_path / "jax.json"
        assert tspec_cli.main(argv + [str(port)]) == 0
        assert jspec_cli.main(argv + [str(ref)]) == 0
        assert port.read_bytes() == ref.read_bytes(), (source, need_lambda)
        doc = _one_zero_at_x0(port)
        assert ("lambda" in doc[0]["zeros"][0]) == (need_lambda == "true")


def test_matrix_block_spectrum_matches():
    """compute_spectrum_pmp on a 2x2 block (the dim-2 certificate's PMP; the
    smallest eigenvalue by eigsy, the lambda fit by SVD) from a y near the
    certificate's optimum and a seeded x: the JAX package's zeros, lambdas
    and errors, value for value."""
    rng = random.Random(4)
    with mpmath.workprec(80):
        _, norm, mats = tpmp.read_pmp_input(REPO / "fixtures" / "dim2_certificate" / "pmp.json")
        y = [mpmath.mpf("-1.685650770619604657526474")]
        terms = max(len(p.coefficients) for r in mats[0].polynomials for pv in r for p in pv)
        xs = [[mpmath.mpf(rng.uniform(-1, 1)) for _ in range(3 * terms)]]
        args = (norm, y, mats, xs, mpmath.mpf("1e-3"), mpmath.mpf("1e-3"), True)
        port, ref = tspec.compute_spectrum_pmp(*args), jspec.compute_spectrum_pmp(*args)
        assert [(z.zero, z.Lambda) for z in port[0].zeros] == \
            [(z.zero, z.Lambda) for z in ref[0].zeros]
        assert port[0].error == ref[0].error
        assert abs(tspec._min_eig_sym(mpmath.matrix([[2, 1], [1, 2]])) - 1) < mpmath.mpf("1e-20")

