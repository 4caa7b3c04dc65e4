"""Error-free transformations on float64 and float32 tensors (port of
sdpb_tpu/ops/eft.py).

Each returns a pair (result, error) whose sum is EXACTLY the true value,
given correctly rounded IEEE arithmetic with no FP contraction.  Every
torch op below is a separate kernel, so nothing is fused into an FMA;
never route these through `torch.compile`, `addcmul` or `alpha=`.
"""
from __future__ import annotations

import torch

# Dekker-split power 2**ceil(p/2) (2**27 for float64, 2**12 for float32),
# applied in the contraction-immune form t = fl(2^s*a + a)
# (sdpb_tpu/ops/eft.py:20-31).
SPLIT_POW = 134217728.0
SPLIT_POW_F32 = 4096.0


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def quick_two_sum(a, b):
    """Fast TwoSum: requires |a| >= |b| or a == 0."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split into two halves of the mantissa (exact)."""
    w = (SPLIT_POW_F32 if a.dtype == torch.float32 else SPLIT_POW) * a
    t = w + a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod_presplit(a, ah, al, b, bh, bl):
    """Dekker TwoProd of pre-split operands: p + e == a * b exactly."""
    p = a * b
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly (no FMA)."""
    ah, al = split(a)
    bh, bl = split(b)
    return two_prod_presplit(a, ah, al, b, bh, bl)
