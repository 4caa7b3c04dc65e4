"""Text matrix blocks (the port's copy of write_text_matrix and
read_text_matrix from sdpb_tpu/io/text_blocks.py): the reference's
write_distmatrix format,

    <height> <width>
    <element row0 col0>
    <element row0 col1>
    ...

one decimal number per line, row-major, at full working precision: the
solution files and the text checkpoints that solver/checkpoint.py reads.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.strings import limbs_to_str, strs_to_limbs


def write_text_matrix(path, limbs: np.ndarray, ndigits=None) -> None:
    """limbs: [K, h, w] host float64 array -> text file."""
    K, h, w = limbs.shape
    lines = [f"{h} {w}"]
    for r in range(h):
        for c in range(w):
            lines.append(limbs_to_str(limbs[:, r, c], ndigits=ndigits))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")


def read_text_matrix(path, K: int, np_dtype=np.float64,
                     expect_shape=None) -> np.ndarray:
    """Text file -> [K, h, w] limbs, the dimensions checked as the
    reference's read_text_block checks them."""
    tokens = Path(path).read_text().split()
    if len(tokens) < 2:
        raise RuntimeError(f"Corrupted header in file: {path}")
    h, w = int(tokens[0]), int(tokens[1])
    if expect_shape is not None and (h, w) != tuple(expect_shape):
        raise RuntimeError(
            f"Incompatible checkpoint file: '{path}'. Expected dimensions "
            f"{tuple(expect_shape)}, but found ({h},{w})")
    vals = tokens[2:]
    if len(vals) != h * w:
        raise RuntimeError(f"Corrupted data in file: {path}")
    return strs_to_limbs(vals, K, np_dtype).reshape(K, h, w)
