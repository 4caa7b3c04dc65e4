"""Text matrix blocks (the port's copy of write_text_matrix from
sdpb_tpu/io/text_blocks.py): the reference's write_distmatrix format,

    <height> <width>
    <element row0 col0>
    <element row0 col1>
    ...

one decimal number per line, row-major, at full working precision.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.strings import limbs_to_str


def write_text_matrix(path, limbs: np.ndarray, ndigits=None) -> None:
    """limbs: [K, h, w] host float64 array -> text file."""
    K, h, w = limbs.shape
    lines = [f"{h} {w}"]
    for r in range(h):
        for c in range(w):
            lines.append(limbs_to_str(limbs[:, r, c], ndigits=ndigits))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")
