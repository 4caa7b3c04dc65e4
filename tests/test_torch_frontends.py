"""The port's other front ends against the JAX package's, byte for byte:
gen_pmp's JSON, sdp2input of a generated problem with a pool of spawned
processes, write_bootstrap_sdp's XML, pvm2sdp (json and bin) and
pvm2functions on that XML, random_sdp's arrays and block_grid_mapping's
output.  All of it is host Python (mpmath, numpy), copied."""
import json
from pathlib import Path

import mpmath
import numpy as np
import pytest

from sdpb_tpu.cli import (block_grid_mapping as jbgm, pvm2functions as jp2f,
                          pvm2sdp as jp2s, sdp2input as jcli)
from sdpb_tpu.convert import pmp as jpmp
from sdpb_tpu.models import synthetic as jsyn
from sdpb_tpu.parallel import planner as jplan
from sdpb_tpu.tools import gen_pmp as jgen, write_bootstrap_sdp as jwbs
from sdpb_tpu_torch.cli import (block_grid_mapping as tbgm, pvm2functions as tp2f,
                                pvm2sdp as tp2s, sdp2input as tcli)
from sdpb_tpu_torch.convert import pmp as tpmp
from sdpb_tpu_torch.convert.dual_constraint_group import assemble_sdp
from sdpb_tpu_torch.io import sdp_zip as tzip
from sdpb_tpu_torch.models import synthetic as tsyn
from sdpb_tpu_torch.parallel import planner as tplan
from sdpb_tpu_torch.tools import gen_pmp as tgen, write_bootstrap_sdp as twbs

from torch_parity import same_sdp

REPO = Path(__file__).resolve().parents[1]
CERT_PMP = REPO / "fixtures" / "dim2_certificate" / "pmp.json"


@pytest.mark.parametrize("solvable", [False, True])
def test_gen_pmp_writes_the_same_json(tmp_path, solvable, capsys):
    argv = ["--blocks", "3", "--dim", "2", "--dual", "4", "--degree", "6", "--poles", "3",
            "--seed", "11", "-o"]
    flag = ["--solvable"] if solvable else []
    assert tgen.main(argv + [str(tmp_path / "port.json")] + flag) == 0
    port_out = capsys.readouterr().out
    assert jgen.main(argv + [str(tmp_path / "jax.json")] + flag) == 0
    assert capsys.readouterr().out.replace("jax.json", "port.json") == port_out
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    doc = json.loads((tmp_path / "port.json").read_text())
    assert len(doc["PositiveMatrixWithPrefactorArray"]) == 3
    assert tgen.entry_count(3, 2, 4, 6) == jgen.entry_count(3, 2, 4, 6) == 3 * 4 * 5 * 7


def test_generated_problem_and_procs(tmp_path):
    """gen_pmp's 4 blocks (dim 2, dual 5, degree 8, seed 3; every block's
    moments fall back to adaptive quadrature) at 212 bits: the port's CLI
    with --procs 2 writes the JAX CLI's zip; and the spawned pool's blocks
    equal the serial ones (three blocks of the certificate)."""
    (tmp_path / "g.json").write_text(json.dumps(tgen.generate_pmp(4, 2, 5, 8, seed=3)))
    argv = ["-i", str(tmp_path / "g.json"), "--precision", "212"]
    assert tcli.main(argv + ["-o", str(tmp_path / "port.zip"), "--procs", "2"]) == 0
    assert jcli.main(argv + ["-o", str(tmp_path / "jax.zip")]) == 0
    same_sdp(tmp_path / "port.zip", tmp_path / "jax.zip")
    with mpmath.workprec(212):
        o, n, m = tpmp.read_pmp_input(CERT_PMP)
        const, b, pvms = tpmp.reduce_pmp(o, n, m * 3)
        for procs in (1, 3):
            tzip.write_sdp(tmp_path / f"p{procs}", assemble_sdp(const, b, pvms, 4, procs=procs),
                           block_format="bin", precision=212)
    same_sdp(tmp_path / "p1", tmp_path / "p3")


@pytest.fixture(scope="module")
def xml_pair(tmp_path_factory):
    """The certificate's PMP written as PVM XML at 200 bits by each
    package's write_bootstrap_sdp."""
    d = tmp_path_factory.mktemp("xml")
    with mpmath.workprec(200):
        for name, pmp, wbs in (("port", tpmp, twbs), ("jax", jpmp, jwbs)):
            wbs.write_bootstrap_sdp(d / f"{name}.xml", *pmp.read_pmp_input(CERT_PMP))
    return d / "port.xml", d / "jax.xml"


def test_write_bootstrap_sdp_xml(xml_pair, tmp_path):
    port, jax = xml_pair
    assert port.read_bytes() == jax.read_bytes()
    text = port.read_text()
    assert text.count("<polynomialVectorMatrix>") == 1 and "<bilinearBasis>" in text
    with mpmath.workprec(120):
        for name, wbs in (("p", twbs), ("j", jwbs)):
            wbs.write_bootstrap_sdp(tmp_path / f"{name}.xml", *tpmp.read_pmp_input(CERT_PMP),
                                    digits=20)
    assert (tmp_path / "p.xml").read_bytes() == (tmp_path / "j.xml").read_bytes()


@pytest.mark.parametrize("fmt", ["json", "bin"])
def test_pvm2sdp(xml_pair, tmp_path, fmt, capsys):
    """pvm2sdp of the port's XML, directly and through an NSV list."""
    port_xml, _ = xml_pair
    (tmp_path / "list.nsv").write_bytes(str(port_xml).encode() + b"\0")
    for name, cli in (("port", tp2s), ("jax", jp2s)):
        assert cli.main([fmt, "200", str(port_xml), str(tmp_path / f"{name}.zip")]) == 0
    same_sdp(tmp_path / "port.zip", tmp_path / "jax.zip")
    assert tp2s.main([fmt, "200", str(tmp_path / "list.nsv"), str(tmp_path / "dir")]) == 0
    same_sdp(tmp_path / "dir", tmp_path / "jax.zip")
    assert tp2s.main(["200"]) == 2


def test_pvm2functions(xml_pair, tmp_path, capsys):
    port_xml, _ = xml_pair
    for name, cli in (("port", tp2f), ("jax", jp2f)):
        assert cli.main(["-i", str(port_xml), "-o", str(tmp_path / f"{name}.json"),
                         "--precision", "200"]) == 0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert len(json.loads((tmp_path / "port.json").read_text())["functions"]) == 1


@pytest.mark.parametrize("kw", [{}, {"num_blocks": 3, "dim": 2, "num_points": 5, "dual_dim": 4,
                                     "K": 3, "seed": 7, "scale": 0.5},
                                {"dim": 3, "num_points": 1, "np_dtype": np.float32, "seed": 2}])
def test_random_sdp_arrays(kw):
    t, j = tsyn.random_sdp(**kw), jsyn.random_sdp(**kw)
    for a, b in ((t.objective_const, j.objective_const), (t.b, j.b)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(t.blocks) == len(j.blocks)
    for tb, jb in zip(t.blocks, j.blocks):
        assert (tb.index, tb.dim, tb.num_points) == (jb.index, jb.dim, jb.num_points)
        for f in ("bases_even", "bases_odd", "c", "B"):
            x, y = getattr(tb, f), getattr(jb, f)
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), f


@pytest.mark.parametrize("argv", [["4", "2", "100", "5", "5", "5", "300", "1"],
                                  ["3", "1", "7", "7", "7", "7", "7"],
                                  ["2", "3", "1000", "10", "20", "30", "40", "900", "5"]])
def test_block_grid_mapping_output(argv, capsys):
    assert tbgm.main(argv) == 0
    port = capsys.readouterr().out
    assert jbgm.main(argv) == 0
    assert capsys.readouterr().out == port and port.strip()
    costs = sorted(((int(c), i) for i, c in enumerate(argv[2:])), reverse=True)
    t = tplan.compute_block_grid_mapping(int(argv[0]), int(argv[1]), costs)
    j = jplan.compute_block_grid_mapping(int(argv[0]), int(argv[1]), costs)
    assert [[(m.num_procs, m.cost, m.block_indices) for m in node] for node in t] == \
        [[(m.num_procs, m.cost, m.block_indices) for m in node] for node in j]
    assert sorted(i for node in t for m in node for i in m.block_indices) == \
        list(range(len(costs)))
    assert tbgm.main(["1"]) == 1
