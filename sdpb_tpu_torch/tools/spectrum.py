"""Functional weights from a dual solution (the port's copy of
fill_weights from sdpb_tpu/tools/spectrum.py; the rest of the spectrum
tool is not ported)."""
from __future__ import annotations

from typing import List

import mpmath


def fill_weights(y: List, max_index: int, normalization: List) -> List:
    """weights with dot(normalization, weights) = 1 (fill_weights.hxx:6-20)."""
    weights = [mpmath.mpf(0)] * len(normalization)
    weights[max_index] = mpmath.mpf(1)
    for block_row in range(len(y)):
        index = block_row + (0 if block_row < max_index else 1)
        weights[index] = y[block_row]
        weights[max_index] -= weights[index] * normalization[index]
    weights[max_index] /= normalization[max_index]
    return weights
