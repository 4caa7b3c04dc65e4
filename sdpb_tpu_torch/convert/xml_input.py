"""XML PVM input (the "pvm" format that mathematica/SDPB.m's
WriteBootstrapSDP writes), the port's copy of sdpb_tpu/convert/xml_input.py:
a streaming parse after the reference's libxml2 SAX reader
(read_pvm_input/read_xml_input/):

  <sdp>
    <objective><elt>...</elt>...</objective>
    <polynomialVectorMatrices>
      <polynomialVectorMatrix>
        <rows>..</rows><cols>..</cols>
        <elements><polynomialVector><polynomial><coeff>..</coeff>..
        <samplePoints><elt>..</elt>..</samplePoints>
        <sampleScalings><elt>..</elt>..</sampleScalings>
        <bilinearBasis><polynomial><coeff>..</coeff>..</bilinearBasis>
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List, Tuple

import mpmath

from .poly import Polynomial, PolynomialVectorMatrix


def read_pvm_xml(path) -> Tuple[List[mpmath.mpf], List[PolynomialVectorMatrix]]:
    """Parse one XML file -> (objective vector, [PolynomialVectorMatrix]).

    Uses iterparse and clears consumed subtrees so inputs of many MB (nmax >= 6
    bootstrap files) stream without holding the whole DOM.
    """
    objective: List[mpmath.mpf] = []
    matrices: List[PolynomialVectorMatrix] = []

    for event, elem in ET.iterparse(str(path), events=("end",)):
        if elem.tag == "objective":
            objective = [mpmath.mpf(e.text.strip()) for e in elem.iter("elt")]
            elem.clear()
        elif elem.tag == "polynomialVectorMatrix":
            matrices.append(_parse_matrix(elem))
            elem.clear()
    if not objective:
        raise ValueError(f"{path}: no <objective> found")
    return objective, matrices


def _poly(elem) -> Polynomial:
    return Polynomial([mpmath.mpf(c.text.strip()) for c in elem.iter("coeff")])


def _parse_matrix(elem) -> PolynomialVectorMatrix:
    rows = int(elem.findtext("rows"))
    cols = int(elem.findtext("cols"))
    elements = []
    for pv in elem.find("elements").iter("polynomialVector"):
        elements.append([_poly(p) for p in pv.iter("polynomial")])
    points = [mpmath.mpf(e.text.strip())
              for e in elem.find("samplePoints").iter("elt")]
    scalings = [mpmath.mpf(e.text.strip())
                for e in elem.find("sampleScalings").iter("elt")]
    basis = [_poly(p) for p in elem.find("bilinearBasis").iter("polynomial")]
    if len(elements) != rows * cols:
        raise ValueError(
            f"polynomialVectorMatrix: {len(elements)} elements, "
            f"expected rows*cols = {rows * cols}")
    return PolynomialVectorMatrix(
        rows=rows, cols=cols, elements=elements,
        sample_points=points, sample_scalings=scalings,
        bilinear_basis=basis)
