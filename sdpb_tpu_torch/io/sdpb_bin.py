"""Parser and writer of SDPB's binary block_data format (the port's copy
of sdpb_tpu/io/sdpb_bin.py).

The reference writes block_data_<j>.bin as a boost binary_oarchive
(little-endian x86_64) holding, in order: the GMP/MPFR precision (u64),
the constraint matrix B (El::Matrix<El::BigFloat>), the constraint
constants c (std::vector<El::BigFloat>), and the even and odd bilinear
bases (El::Matrix).  A matrix saves Height/Width/LDim (El::Int) and then
LDim*Width elements column-major; a BigFloat saves its mpfr fields
{prec: i64, sign: i32, exp: i64, limbs: ceil(prec/64) x u64}.

Boost's framing varies across releases and El::Int widths, so the parser
tries the known framing variants and accepts the one that parses with
consistent dimensions and consumes the whole archive.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Tuple

import mpmath
import numpy as np

SIGNATURE = b"serialization::archive"

# mpfr special exponents: MPFR_EXP_MAX = 2^63 - 1 on LP64
_EXP_MAX = (1 << 63) - 1
_EXP_ZERO = -_EXP_MAX + 1
_EXP_NAN = -_EXP_MAX + 2
_EXP_INF = -_EXP_MAX + 3


@dataclass(frozen=True)
class BinLayout:
    """One boost framing variant."""
    int_size: int       # sizeof(El::Int): 4 or 8
    class_meta: int     # tracking + version bytes at a class's first use
    item_version: int   # item_version bytes before vector elements


# most likely first
_LAYOUTS = [
    BinLayout(4, 5, 4), BinLayout(8, 5, 4),
    BinLayout(4, 3, 2), BinLayout(8, 3, 2),
    BinLayout(4, 0, 4), BinLayout(8, 0, 4),
    BinLayout(4, 0, 0), BinLayout(8, 0, 0),
    BinLayout(4, 5, 0), BinLayout(8, 5, 0),
]


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ValueError("unexpected EOF")
        out = self.data[self.off:self.off + n]
        self.off += n
        return out

    def u(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little", signed=False)

    def i(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little", signed=True)


def _read_bigfloat(r: _Reader, prec: int) -> mpmath.mpf:
    p = r.i(8)
    if p != prec:
        raise ValueError(f"BigFloat precision {p} != archive precision {prec}")
    sign = r.i(4)
    exp = r.i(8)
    nlimbs = -(-prec // 64)
    limbs = r.take(8 * nlimbs)
    if exp == _EXP_ZERO:
        return mpmath.mpf(0)
    if exp in (_EXP_NAN, _EXP_INF):
        raise ValueError("non-finite BigFloat in block data")
    if sign not in (-1, 1):
        raise ValueError(f"bad BigFloat sign {sign}")
    m = int.from_bytes(limbs, "little", signed=False)
    if m == 0:
        return mpmath.mpf(0)
    with mpmath.workprec(prec + 64):
        val = mpmath.mpf(m) * mpmath.power(2, exp - 64 * nlimbs)
        # negate inside workprec: mpmath rounds unary minus too
        return val if sign > 0 else -val


class _Archive:
    """Boost binary archive reader for this file's object sequence."""

    def __init__(self, data: bytes, layout: BinLayout):
        self.r = _Reader(data)
        self.layout = layout
        self.seen = set()
        siglen = self.r.u(8)
        if siglen != len(SIGNATURE) or self.r.take(siglen) != SIGNATURE:
            raise ValueError("not a boost serialization archive")
        libver = self.r.u(2)
        if not 3 <= libver <= 40:
            raise ValueError(f"implausible boost archive version {libver}")

    def class_meta(self, flag: str):
        if flag not in self.seen:
            self.r.take(self.layout.class_meta)
            self.seen.add(flag)

    def read_matrix(self, prec: int) -> Tuple[int, int, List[List[mpmath.mpf]]]:
        self.class_meta("matrix")
        isz = self.layout.int_size
        h, w, ld = self.r.i(isz), self.r.i(isz), self.r.i(isz)
        if not (0 <= h <= 10**7 and 0 <= w <= 10**7 and ld >= max(h, 1)):
            raise ValueError(f"implausible matrix dims {h}x{w} ld {ld}")
        if ld * w:
            self.class_meta("bigfloat")
        vals = [_read_bigfloat(self.r, prec) for _ in range(ld * w)]
        # column-major with leading dimension ld: (row, col) at col*ld + row
        return h, w, [[vals[c * ld + r] for c in range(w)] for r in range(h)]

    def read_vector(self, prec: int) -> List[mpmath.mpf]:
        count = self.r.u(8)
        if count > 10**7:
            raise ValueError(f"implausible vector count {count}")
        self.r.take(self.layout.item_version)
        if count:
            self.class_meta("bigfloat")
        return [_read_bigfloat(self.r, prec) for _ in range(count)]


def _mpf_matrix_to_limbs(mat, K, np_dtype, rows, cols) -> np.ndarray:
    out = np.zeros((K, rows, cols), dtype=np_dtype)
    for rr in range(rows):
        for cc in range(cols):
            x = mat[rr][cc]
            for k in range(K):
                hi = np_dtype(float(x))
                out[k, rr, cc] = hi
                x = x - mpmath.mpf(float(hi))
    return out


def parse_block_data_bin(data: bytes, index: int, dim: int, num_points: int,
                         N: int, K: int, np_dtype=np.float64):
    """Parse one block_data_<j>.bin into a BlockData of limb arrays."""
    from .sdp_zip import BlockData

    P = num_points * dim * (dim + 1) // 2
    errors = []
    for layout in _LAYOUTS:
        try:
            ar = _Archive(data, layout)
            prec = ar.r.u(8)
            if not 16 <= prec <= 1 << 20:
                raise ValueError(f"implausible precision {prec}")
            hB, wB, B = ar.read_matrix(prec)
            if (hB, wB) != (P, N):
                raise ValueError(f"B dims {hB}x{wB}, expected {P}x{N}")
            c = ar.read_vector(prec)
            if len(c) != P:
                raise ValueError(f"c length {len(c)}, expected {P}")
            he, we, be = ar.read_matrix(prec)
            ho, wo, bo = ar.read_matrix(prec)
            if we != num_points or wo not in (num_points, 0):
                raise ValueError(f"bases widths {we}/{wo} != {num_points}")
            if ar.r.off != len(data):
                raise ValueError(f"{len(data) - ar.r.off} trailing bytes")
        except ValueError as e:
            errors.append((layout, str(e)))
            continue
        with mpmath.workprec(prec + 64):
            return BlockData(
                index=index, dim=dim, num_points=num_points,
                bases_even=_mpf_matrix_to_limbs(be, K, np_dtype, he, we),
                bases_odd=_mpf_matrix_to_limbs(bo, K, np_dtype, ho, wo)
                if ho else np.zeros((K, 0, num_points), dtype=np_dtype),
                c=_mpf_matrix_to_limbs([c], K, np_dtype, 1, P)[:, 0],
                B=_mpf_matrix_to_limbs(B, K, np_dtype, hB, wB))
    detail = "; ".join(f"{l}: {e}" for l, e in errors[:4])
    raise ValueError(f"block_data_{index}.bin matches no known boost archive "
                     f"layout ({detail})")


# Writer: the canonical layout (El::Int of 4 bytes, boost >= 1.59 framing)


def _write_bigfloat(out: bytearray, x: mpmath.mpf, prec: int) -> None:
    nlimbs = -(-prec // 64)
    out += struct.pack("<q", prec)
    if x == 0:
        out += struct.pack("<i", 1)
        out += struct.pack("<q", _EXP_ZERO)
        out += b"\0" * (8 * nlimbs)
        return
    # exact, from mpmath's own fields: x = (-1)^s * man * 2^e, man of bit
    # length b -> mpfr's M * 2^(exp - 64 nlimbs) with 2^(64n-1) <= M
    sgn_bit, man, e, b = x._mpf_
    sign = -1 if sgn_bit else 1
    shift = 64 * nlimbs - b
    if shift >= 0:
        m = man << shift
        exp = e + b
    else:
        # round to nearest, ties to even, when narrowing
        drop = -shift
        half = 1 << (drop - 1)
        low = man & ((1 << drop) - 1)
        m = man >> drop
        if low > half or (low == half and (m & 1)):
            m += 1
        exp = e + b
        if m >= 1 << (64 * nlimbs):
            m >>= 1
            exp += 1
    out += struct.pack("<i", sign)
    out += struct.pack("<q", exp)
    out += m.to_bytes(8 * nlimbs, "little")


_CANON = BinLayout(int_size=4, class_meta=5, item_version=4)


def write_block_data_bin(blk, prec: int) -> bytes:
    """Serialize a BlockData to the canonical .bin layout (it round-trips
    with parse_block_data_bin; the framing is modern boost
    binary_oarchive's)."""
    from ..utils.strings import limbs_to_mpf as ltm

    out = bytearray()
    out += struct.pack("<Q", len(SIGNATURE))
    out += SIGNATURE
    out += struct.pack("<H", 19)          # boost archive library version
    out += struct.pack("<Q", prec)

    state = {"matrix": False, "bigfloat": False}

    def class_meta(flag):
        if not state[flag]:
            out.extend(b"\0" * _CANON.class_meta)
            state[flag] = True

    def write_matrix(limbs3):  # [K, h, w]
        class_meta("matrix")
        K, h, w = limbs3.shape
        ld = max(h, 1)
        out.extend(struct.pack("<iii", h, w, ld))
        if ld * w:
            class_meta("bigfloat")
        for cc in range(w):
            for rr in range(ld):
                val = ltm(limbs3[:, rr, cc]) if rr < h else mpmath.mpf(0)
                _write_bigfloat(out, val, prec)

    write_matrix(blk.B)
    out.extend(struct.pack("<Q", blk.c.shape[1]))
    out.extend(b"\0" * _CANON.item_version)
    if blk.c.shape[1]:
        class_meta("bigfloat")
    for i in range(blk.c.shape[1]):
        _write_bigfloat(out, ltm(blk.c[:, i]), prec)
    write_matrix(blk.bases_even)
    write_matrix(blk.bases_odd)
    return bytes(out)
