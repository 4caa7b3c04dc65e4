"""Reader of the reference's rank-local binary checkpoint (the port's copy
of sdpb_tpu/io/ref_checkpoint.py).

A reference binary checkpoint (`checkpoint_<gen>_<rank>`) is the raw
stream of the rank's local blocks of x, X, y and Y, in that order, each
block as [int64 height, int64 width, height * width El::BigFloat images]
(save_checkpoint.cxx:11-35, read back by load_binary_checkpoint.cxx:33-67).
The writer streams a block's elements ROW-MAJOR, the row outer and the
column inner, and so does this reader: element (row, col) is
vals[row * width + col].  (The JAX reader decodes column-major; x and y
are one column wide and X and Y are symmetric, so the two orders agree on
every real checkpoint, and only a non-symmetric block tells them apart.)
The file has no precision header; the precision is the writing run's
--precision, echoed into the options of checkpoint.json.

Only the single-rank layout (one `checkpoint_<gen>_0`) is read: on one
rank every El::DistMatrix is the whole matrix, so the local blocks are the
global blocks in block-index order, two parity blocks of X and of Y per
SDP block.  A multi-rank dump holds each rank's blocks under the
reference's own allocation and is refused, as the reference's own advice
has it (docs/Usage.md:148-157): resume from its text solution instead.

A BigFloat image is {prec: i64, sign: i32, exp: i64, ceil(prec/64) u64
mantissa words, least significant first}, value sign * M * 2^(exp - 64 n).
Every record of a file has the same size, so a block is decoded from one
numpy view of its records; M is peeled into float64 limbs by correctly
rounded int -> float conversions, which give the limbs of the JAX reader's
mpmath peel (hi = nearest double of the remainder, then the remainder
less hi) exactly.
"""
from __future__ import annotations

import json
import math
import re
from pathlib import Path

import numpy as np

from .sdpb_bin import _EXP_INF, _EXP_NAN, _EXP_ZERO


class PrecisionMismatch(ValueError):
    """The files' BigFloats carry another precision than the one asked."""

    def __init__(self, path, found: int, expected: int):
        super().__init__(f"{path}: BigFloat precision {found} != {expected}")
        self.found = found


def checkpoint_precision(checkpoint_dir):
    """The precision in the options of checkpoint.json (or
    checkpoint_new.json), None when neither records one."""
    for name in ("checkpoint.json", "checkpoint_new.json"):
        p = Path(checkpoint_dir) / name
        if not p.exists():
            continue
        try:
            opts = json.loads(p.read_text()).get("options", {})
        except ValueError:
            continue
        if "precision" in opts:
            return int(opts["precision"])
    return None


def _record_dtype(prec: int) -> np.dtype:
    return np.dtype([("prec", "<i8"), ("sign", "<i4"), ("exp", "<i8"),
                     ("m", "V%d" % (8 * -(-prec // 64)))])


def _peel(m: int, e: int, K64: int) -> list:
    """float64 limbs of m * 2^e: each the nearest double of what is left."""
    out = []
    for _ in range(K64):
        hi = float(m)                  # correctly rounded, ties to even
        out.append(math.ldexp(hi, e))
        m -= int(hi)
    return out


class _Blocks:
    """Sequential reader of a checkpoint file's blocks."""

    def __init__(self, path: Path, prec: int, K64: int):
        self.path, self.data, self.off = path, path.read_bytes(), 0
        self.prec, self.K64 = prec, K64
        self.dtype = _record_dtype(prec)
        self.bits = 64 * -(-prec // 64)     # of the mantissa M

    def read(self, shape: tuple, what: str) -> np.ndarray:
        """The next block, which must have `shape` (rows, cols), as float64
        limbs [K64, rows, cols], row-major."""
        if self.off + 16 > len(self.data):
            raise ValueError(f"{self.path}: ends before {what}")
        h, w = np.frombuffer(self.data, "<i8", 2, self.off)
        self.off += 16
        if (int(h), int(w)) != tuple(shape):
            raise ValueError(f"{self.path}: {what}: expected {shape[0]}x{shape[1]}, "
                             f"found {h}x{w}")
        n = int(h) * int(w)
        if self.off + n * self.dtype.itemsize > len(self.data):
            raise ValueError(f"{self.path}: ends inside {what}")
        rec = np.frombuffer(self.data, self.dtype, n, self.off)
        self.off += n * self.dtype.itemsize
        bad = rec["prec"] != self.prec
        if bad.any():
            raise PrecisionMismatch(self.path, int(rec["prec"][bad][0]), self.prec)
        out = np.zeros((self.K64, n))
        for i, (sign, exp, m) in enumerate(zip(rec["sign"].tolist(), rec["exp"].tolist(),
                                               rec["m"].tolist())):
            if exp == _EXP_ZERO:
                continue
            if exp in (_EXP_NAN, _EXP_INF):
                raise ValueError(f"{self.path}: non-finite BigFloat in {what}")
            mant = int.from_bytes(m, "little")
            if sign not in (-1, 1):
                raise ValueError(f"{self.path}: bad BigFloat sign {sign} in {what}")
            out[:, i] = _peel(sign * mant, exp - self.bits, self.K64)
        # the stream is row-major: (row, col) at row * w + col
        return out.reshape(self.K64, int(h), int(w))


def load_reference_binary_checkpoint(checkpoint_dir, sdp, precision: int,
                                     verbosity: int = 1, print_fn=print):
    """The state of a reference binary checkpoint directory, laid out in
    sdp's buckets (solver/checkpoint.py::_state_from_block_arrays).  `sdp`
    gives the block structure the reference checks at
    load_binary_checkpoint.cxx:33-45 (its padding blocks, block index -1,
    are not in the file); `precision` is the writing run's --precision in
    bits.  Raises PrecisionMismatch when the BigFloats carry another."""
    from ..solver.checkpoint import _state_from_block_arrays

    ck = Path(checkpoint_dir)
    gen = None
    meta = ck / "checkpoint.json"
    if meta.exists():
        try:
            gen = json.loads(meta.read_text()).get("current")
        except ValueError:
            gen = None
    ranks = {}
    for f in ck.iterdir():
        m = re.fullmatch(r"checkpoint_(\d+)_(\d+)", f.name)
        if m and (gen is None or int(m.group(1)) == int(gen)):
            ranks.setdefault(int(m.group(1)), set()).add(int(m.group(2)))
    if not ranks:
        raise FileNotFoundError(f"{ck}: no reference binary checkpoint files "
                                f"(checkpoint_<gen>_<rank>)")
    g = int(gen) if gen is not None else max(ranks)
    if ranks[g] != {0}:
        raise ValueError(
            f"{ck}: multi-rank reference checkpoint (ranks {sorted(ranks[g])}): "
            f"rank-local layouts are not portable; re-run the reference with "
            f"--writeSolution=x,y,X,Y and resume from the text solution "
            f"(docs/Usage.md:148-157)")
    path = ck / f"checkpoint_{g}_0"
    if verbosity >= 1:
        print_fn(f"Loading reference binary checkpoint from : {path}")

    blocks = sorted((rs.block_index, bk.shape.n_pairs * rs.num_points,
                     bk.shape.dim * rs.h_even, bk.shape.dim * rs.h_odd)
                    for bk in sdp.buckets for rs in bk.real_sizes if rs.block_index >= 0)
    r = _Blocks(path, precision, -(-precision // 53) + 1)
    out = {idx: {} for idx, *_ in blocks}
    for idx, P, _, _ in blocks:
        out[idx]["x"] = r.read((P, 1), f"block {idx} x")[:, :, 0]
    for mat in ("X", "Y"):
        if mat == "Y":
            y = r.read((sdp.dual_dim, 1), "y")[:, :, 0]
        for idx, _, ne, no in blocks:
            for parity, n in (("even", ne), ("odd", no)):
                out[idx][f"{mat}_{parity}"] = r.read((n, n), f"block {idx} {mat}_{parity}")
    if r.off != len(r.data):
        raise ValueError(f"{path}: {len(r.data) - r.off} trailing bytes: layout mismatch "
                         f"(a multi-group run?)")
    return _state_from_block_arrays(sdp, y, out)
