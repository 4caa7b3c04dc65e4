"""The port's sdp2input (cli/sdp2input.py over convert/pmp.py's reduction,
convert/dual_constraint_group.py, convert/mathematica.py and the writers
of io/sdp_zip.py and io/sdpb_bin.py) against the JAX package's, and against
the committed fixtures, which the JAX converter made.  It is host mpmath in
both packages: an sdp.zip is held entry by entry, byte for byte (the zip's
timestamps and control.json's `command` aside), every mpmath value equal as
an mpf."""
import json
import zipfile
from pathlib import Path

import mpmath
import numpy as np
import pytest

from sdpb_tpu.cli import sdp2input as jcli
from sdpb_tpu.convert import pmp as jpmp
from sdpb_tpu.convert.poly import DampedRational as JDR
from sdpb_tpu.io import sdpb_bin as jbin
from sdpb_tpu_torch.cli import sdp2input as tcli
from sdpb_tpu_torch.convert import pmp as tpmp
from sdpb_tpu_torch.convert.poly import DampedRational
from sdpb_tpu_torch.io import sdpb_bin as tbin
from sdpb_tpu_torch.io.sdp_zip import entries
from sdpb_tpu_torch.tools import gen_pmp as tgen

from test_convert import MATHEMATICA_TOY
from torch_parity import same_sdp
from test_spectrum import TOY_PMP

REPO = Path(__file__).resolve().parents[1]
CERT = REPO / "fixtures" / "dim2_certificate"
LADDER = REPO / "fixtures" / "ising_ladder_120"


@pytest.mark.parametrize("fmt", ["json", "bin"])
def test_certificate_matches_the_jax_converter(tmp_path, fmt, capsys):
    """The dim-2 certificate at 400 bits through the port's CLI: json gives
    the committed fixture (the JAX converter's output), bin the JAX CLI's
    zip."""
    argv = ["-i", str(CERT / "pmp.json"), "--precision", "400", "--outputFormat", fmt]
    assert tcli.main(argv + ["-o", str(tmp_path / "port.zip")]) == 0
    if fmt == "json":
        same_sdp(tmp_path / "port.zip", CERT / "sdp.zip")
    else:
        assert jcli.main(argv + ["-o", str(tmp_path / "jax.zip")]) == 0
        same_sdp(tmp_path / "port.zip", tmp_path / "jax.zip")
        assert any(n.endswith(".bin") for n in zipfile.ZipFile(tmp_path / "port.zip").namelist())


def test_ladder_blocks_match_the_committed_fixture(tmp_path):
    """The ladder's first two PMP blocks at 256 bits (bin) give the
    committed ladder zip's objectives and first two blocks' files."""
    doc = json.loads((LADDER / "pmp.json").read_text())
    doc["PositiveMatrixWithPrefactorArray"] = doc["PositiveMatrixWithPrefactorArray"][:2]
    (tmp_path / "two.json").write_text(json.dumps(doc))
    assert tcli.convert(tmp_path / "two.json", tmp_path / "two.zip", 256) == 2
    mine, ref = zipfile.ZipFile(tmp_path / "two.zip"), zipfile.ZipFile(LADDER / "sdp.zip")
    names = ["objectives.json"] + [f"block_{kind}_{j}.{ext}" for j in (0, 1)
                                   for kind, ext in (("info", "json"), ("data", "bin"))]
    assert set(names) < set(mine.namelist())
    for name in names:
        assert mine.read(name) == ref.read(name), name


def test_nsv_list_and_a_pole_at_zero(tmp_path):
    """An NSV list (objective and normalization in one file, blocks in two)
    and a block whose prefactor has a pole at 0 (in the sample scalings,
    not in the basis' measure) convert as in the JAX package."""
    toy = json.loads(json.dumps(TOY_PMP))
    toy["PositiveMatrixWithPrefactorArray"][0]["DampedRational"]["poles"] = ["0", "-1.5"]
    cert = json.loads((CERT / "pmp.json").read_text())
    blocks = cert.pop("PositiveMatrixWithPrefactorArray")
    (tmp_path / "head.json").write_text(json.dumps(dict(cert, PositiveMatrixWithPrefactorArray=[])))
    (tmp_path / "blocks.json").write_text(json.dumps({"PositiveMatrixWithPrefactorArray": blocks}))
    (tmp_path / "zero.json").write_text(json.dumps(
        {"PositiveMatrixWithPrefactorArray": toy["PositiveMatrixWithPrefactorArray"]}))
    (tmp_path / "list.nsv").write_bytes(b"head.json\0blocks.json\0zero.json\0")
    for name, pkg in (("port", tcli), ("jax", jcli)):
        assert pkg.convert(tmp_path / "list.nsv", tmp_path / f"{name}.zip", 128, "json") == 2
    same_sdp(tmp_path / "port.zip", tmp_path / "jax.zip")
    with mpmath.workprec(128):
        _, _, mats = tpmp.read_pmp_input(tmp_path / "zero.json")
        dr = mats[0].damped_rational
        pts = tpmp.sample_points(5)
        assert tpmp.sample_scalings(pts, dr) == jpmp.sample_scalings(pts, dr)
        assert all(s > 0 for s in tpmp.sample_scalings(pts, dr))


def _prefactors():
    with mpmath.workprec(256):
        _, _, cert = tpmp.read_pmp_input(CERT / "pmp.json")
        gen = tgen.generate_pmp(1, 1, 1, 6, num_poles=3, seed=7)
        dr = gen["PositiveMatrixWithPrefactorArray"][0]["DampedRational"]
        return {"certificate": cert[0].damped_rational,
                "three poles": DampedRational(mpmath.mpf(dr["constant"]), mpmath.mpf(dr["base"]),
                                              [mpmath.mpf(p) for p in dr["poles"]]),
                "pole at zero": DampedRational(mpmath.mpf(1), mpmath.mpf("0.25"),
                                               [mpmath.mpf(0), mpmath.mpf(-2)])}


@pytest.mark.parametrize("name", ["certificate", "three poles", "pole at zero"])
def test_bilinear_basis_and_moments_match(name):
    """bilinear_basis (and so _moments_batch), sample_points and the
    adaptive-quadrature _moment give the JAX package's mpf values."""
    damped = _prefactors()[name]
    with mpmath.workprec(160):
        for half in (0, 3):
            tb, jb = tpmp.bilinear_basis(damped, half), jpmp.bilinear_basis(damped, half)
            assert [p.coefficients for p in tb] == [p.coefficients for p in jb]
            assert len(tb) == half + 1 and all(tb[i].degree == i for i in range(half + 1))
        assert tpmp.sample_points(7) == jpmp.sample_points(7)
    with mpmath.workprec(64):
        measure = JDR(damped.constant, damped.base, [p for p in damped.poles if p < 0])
        assert tpmp._moment(measure, 2) == jpmp._moment(measure, 2)


def test_block_data_bin_bytes_and_cross_reading():
    """write_block_data_bin gives the JAX writer's bytes (rounding on
    narrowing at 64 bits, zeros, negatives, an empty odd basis) and each
    package parses the other's."""
    from sdpb_tpu_torch.models.synthetic import random_sdp

    sdp = random_sdp(num_blocks=2, dim=2, num_points=3, dual_dim=2, K=3, seed=5)
    blk = sdp.blocks[1]
    blk.B[1] = blk.B[0] * 2.0 ** -60              # a second and a third limb
    blk.B[2] = blk.B[0] * 2.0 ** -130
    blk.c[:, 0] = 0.0
    blk.bases_odd = np.zeros((3, 0, 3))
    for prec in (64, 200):
        data = tbin.write_block_data_bin(blk, prec)
        assert data == jbin.write_block_data_bin(blk, prec)
        for parse in (tbin.parse_block_data_bin, jbin.parse_block_data_bin):
            got = parse(data, 1, 2, 3, 2, 4, np.float64)
            if prec == 200:
                np.testing.assert_array_equal(got.B[:3], blk.B)
                assert not got.B[3:].any()
            assert got.c[0, 0] == 0 and got.bases_odd.shape == (4, 0, 3)
        assert tbin.parse_block_data_bin(data, 1, 2, 3, 2, 4).B.tobytes() == \
            jbin.parse_block_data_bin(data, 1, 2, 3, 2, 4, np.float64).B.tobytes()


def test_mathematica_toy_matches(tmp_path):
    """The .m toy (precision marks, *^ exponents, line continuations) reads
    to the JAX reader's PMP and converts to its sdp.zip."""
    (tmp_path / "toy.m").write_text(MATHEMATICA_TOY)
    with mpmath.workprec(256):
        to, tn, tm = tpmp.read_pmp_input(tmp_path / "toy.m")
        jo, jn, jm = jpmp.read_pmp_input(tmp_path / "toy.m")
        assert (to, tn) == (jo, jn) == ([0, -1], [1, 0])
        assert [p.coefficients for p in tm[0].polynomials[0][0]] == \
            [p.coefficients for p in jm[0].polynomials[0][0]]
        assert (tm[0].damped_rational.base, tm[0].damped_rational.constant) == \
            (jm[0].damped_rational.base, jm[0].damped_rational.constant)
    for name, pkg in (("port", tcli), ("jax", jcli)):
        pkg.convert(tmp_path / "toy.m", tmp_path / f"{name}.zip", 256, "json")
    same_sdp(tmp_path / "port.zip", tmp_path / "jax.zip")
    with pytest.raises(ValueError, match="SDP"):
        (tmp_path / "bad.m").write_text("nothing here")
        tpmp.read_pmp_input(tmp_path / "bad.m")


def test_chip_smoke_study_inputs(tmp_path):
    """chip_smoke.py phase 18's inputs: its toy PMP is tests/test_spectrum.py's
    and its x0 that test's value, and its background sdp2input task writes
    what the port's sdp2input writes (here the toy PMP at 128 bits)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.TOY_PMP == TOY_PMP and cs.STUDY_X0 == "1.042496785718158120984007"
    data, gen_s, conv_s = cs._sdp2input_task({"toy.json": json.dumps(TOY_PMP)}, "toy.json",
                                             128, "json")
    (tmp_path / "toy.json").write_text(json.dumps(TOY_PMP))
    assert tcli.convert(tmp_path / "toy.json", tmp_path / "toy.zip", 128, "json") == 1
    assert list(entries(data).items()) == list(entries(tmp_path / "toy.zip").items())
    assert gen_s >= 0 and conv_s > 0
