"""WriteBootstrapSDP, the Mathematica front end's entry path (the port's
copy of sdpb_tpu/tools/write_bootstrap_sdp.py).

The reference ships `mathematica/SDPB.m`, whose `WriteBootstrapSDP[]`
serializes an `SDP[objective, normalization, positiveMatrices]` expression
to PVM XML: sample points, sample scalings and the orthogonal bilinear
basis computed from each matrix's DampedRational prefactor (SDPB.m:111-127
and the bilinearForm moment formulas around it).  This module gives the
same entry path on the conversion code of convert/:

    write_bootstrap_sdp(path, objective, normalization, matrices)

writes the XML file `pvm2sdp` (ours or the reference's) converts to
sdp.zip.  The sampling rules are the package's own (`convert/pmp.py`:
rescaled-Laguerre points, prefactor scalings, Gram-Hankel ON basis), which
match the reference's by construction, so the JSON PMP pipeline
(`sdp2input`) and the XML one (`WriteBootstrapSDP` + `pvm2sdp`) make the
same SDP.

A minimal original Mathematica wrapper with the same name lives at
`mathematica/SDPB.m` (serializes the SDP expression to PMP JSON for
`sdp2input`, covering users who drive everything from Mathematica).
"""
from __future__ import annotations

from typing import List

import mpmath

from ..convert.pmp import reduce_pmp
from ..convert.poly import PositiveMatrixWithPrefactor


def _fmt(x, digits: int) -> str:
    return mpmath.nstr(mpmath.mpf(x), digits, strip_zeros=True)


def write_bootstrap_sdp(path, objective, normalization,
                        matrices: List[PositiveMatrixWithPrefactor],
                        digits: int = 0) -> None:
    """Serialize a PMP to the reference's PVM XML format.

    objective/normalization: vectors (mpf-convertible); matrices: PMP
    blocks with DampedRational prefactors.  The normalization constraint
    is eliminated exactly as in `sdp2input` (reduce_pmp), the per-matrix
    sampling data is computed here, and everything is written with
    `digits` significant decimal digits (0 = enough for the current
    mpmath working precision plus guard)."""
    if not digits:
        digits = int(mpmath.mp.prec * 0.30103) + 10
    const, b, pvms = reduce_pmp(objective, normalization, matrices)

    def poly_xml(p, out, indent):
        out.append(f"{indent}<polynomial>")
        for c in p.coefficients:
            out.append(f"{indent}  <coeff>{_fmt(c, digits)}</coeff>")
        out.append(f"{indent}</polynomial>")

    out: List[str] = ["<sdp>", "  <objective>"]
    for v in [const] + list(b):
        out.append(f"    <elt>{_fmt(v, digits)}</elt>")
    out.append("  </objective>")
    out.append("  <polynomialVectorMatrices>")
    for pvm in pvms:
        out.append("    <polynomialVectorMatrix>")
        out.append(f"      <rows>{pvm.rows}</rows>")
        out.append(f"      <cols>{pvm.cols}</cols>")
        out.append("      <elements>")
        for vec in pvm.elements:
            out.append("        <polynomialVector>")
            for p in vec:
                poly_xml(p, out, "          ")
            out.append("        </polynomialVector>")
        out.append("      </elements>")
        out.append("      <samplePoints>")
        for x in pvm.sample_points:
            out.append(f"        <elt>{_fmt(x, digits)}</elt>")
        out.append("      </samplePoints>")
        out.append("      <sampleScalings>")
        for s in pvm.sample_scalings:
            out.append(f"        <elt>{_fmt(s, digits)}</elt>")
        out.append("      </sampleScalings>")
        out.append("      <bilinearBasis>")
        for p in pvm.bilinear_basis:
            poly_xml(p, out, "        ")
        out.append("      </bilinearBasis>")
        out.append("    </polynomialVectorMatrix>")
    out.append("  </polynomialVectorMatrices>")
    out.append("</sdp>")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
