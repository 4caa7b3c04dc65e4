"""The wide GEMM kernel's arithmetic in plain PyTorch, in the kernel's own
operation order: the port of the compact ops of
sdpb_tpu/ops/mpwide_kernel.py:410-734 (add_st_c, mul_st_c, add_full_c,
mul_full_c, wfma_acc_c, wnormalize_c), which csrc/mp_wide.cuh performs
operation for operation.  kernels.mp_matmul_wide_plain runs it.

A value here is an SVal pair (float32 limbs [K, *shape], int32 exp
[*shape]); a wide value a WVal pair (w0, w1) of SVals with
|w1| <~ 2^-(24K) |w0|.  Shapes broadcast (the GEMM feeds [.., M, 1] and
[.., 1, N] operands).

The Pallas kernel keeps its row stacks in a VMEM scratch ref and runs the
sweeps as loops over dynamically indexed rows; here a row stack is a
Python list of row tensors in the same LOGICAL order, which is all the
bits depend on, and the renorms are mpfloat.renorm's.  That order
differs from the list forms of the JAX package (mpwide_kernel.py:184-406)
in two places, so the two agree only to the renorm's chain-sum tail
there:
  * add_full_c puts the exact residual of the hi stack before the spilled
    limbs on the lo stack (the list form: spill first) and ends it with two
    zero rows;
  * mul_full_c keeps each routed lo term at its product slot, so its lo
    stack is in slot order (all products i*K+j, then all errors), not in
    plan order, and puts residual, spill and two zero rows before it.
add_st_c and mul_st_c append two zero rows to the list forms' rows, which
changes no bit.

Subnormals: a Mosaic multiply flushes subnormal results, which is why the
hi extraction spills limbs near the bottom of float32's range onto the lo
ladder through an exact bit-assembled lift (_mul_pow2_lift).  Nothing
flushes here or in the CUDA kernel (-ftz=false), but the lift is kept, so
that kernel, plain version on the card and plain version on the CPU agree
bit for bit.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from .eft import split
from .mpfloat import (EXP_ZERO, MUL_UNIFORM_EXP, SCALED_DTYPE, _compact_hi, _exp_bits,
                      _normalize_scaled, _scale_pow2, center_for, mul_term_plan,
                      mul_term_plan_full, renorm, sweeps)

SVal = Tuple[torch.Tensor, torch.Tensor]
WVal = Tuple[SVal, SVal]


@lru_cache(maxsize=None)
def plan_tables(K: int):
    """(int32 [2 + 2K^2 + n_mul], float32 [2, n_mul]) as in
    mpwide_kernel.py:433-448: header [n_full, n_mul], the full-product
    plan, the truncated-product plan; the two placement factors of each
    truncated-product row."""
    full = mul_term_plan_full(K)
    idx, diag = mul_term_plan(K)
    d = (center_for(K) - 2 * MUL_UNIFORM_EXP - 24 * diag).astype(np.int64)
    d1 = np.clip(d, -126, 127)
    d2 = np.clip(d - d1, -126, 127)
    f1 = np.exp2(d1.astype(np.float64)).astype(np.float32)
    f2 = np.exp2(d2.astype(np.float64)).astype(np.float32)
    ints = np.concatenate([np.asarray([len(full), len(idx)], np.int32),
                           full.astype(np.int32), idx.astype(np.int32)])
    return ints, np.stack([f1, f2], 0)


def rows_for(K: int) -> int:
    """Float32 scratch rows per output element of the kernel (4K^2 + K + 2;
    plus K^2 int32 placement exponents)."""
    return 4 * K * K + K + 2


def _mul_pow2_lift(x: torch.Tensor, p: int) -> torch.Tensor:
    """Exact x * 2^p (p = 24K) for normal and subnormal x: normals by
    exponent-field addition, subnormals as their integer mantissa (exact in
    float32) times 2^(p-149)."""
    bits = x.view(torch.int32)
    eb = (bits >> 23) & 0xFF
    normal = torch.where(eb == 0, torch.zeros_like(bits), bits + (p << 23)).view(
        torch.float32)
    mant = (bits & 0x7FFFFF).to(torch.float32)
    sign = torch.where(bits < 0, -1.0, 1.0).to(torch.float32)
    sub = sign * mant * 2.0 ** (p - 149)
    return torch.where(eb == 0, sub, normal)


def _finish_renorm(rows: List[torch.Tensor], K: int, e: torch.Tensor) -> SVal:
    """Sweeps with the chain-sum tail, quick-TwoSum compaction forward and
    back over rows 0..K, normalize (renorm_st): mpfloat.renorm."""
    rows = list(torch.broadcast_tensors(*rows))
    r = renorm(rows, K, torch.broadcast_to(e, rows[0].shape))
    return r.limbs, r.exp


def wzeros(shape, K: int, device) -> WVal:
    shape = tuple(shape)
    z = (torch.zeros((K,) + shape, dtype=SCALED_DTYPE, device=device),
         torch.full(shape, EXP_ZERO, dtype=torch.int32, device=device))
    return z, z


def add_st_c(a: SVal, b: SVal, K: int) -> SVal:
    """Aligned scaled add (mpfloat.add order, two zero rows appended)."""
    (al, ae), (bl, be) = a, b
    shape = tuple(torch.broadcast_shapes(al.shape[1:], bl.shape[1:], ae.shape, be.shape))
    ae, be = torch.broadcast_to(ae, shape), torch.broadcast_to(be, shape)
    e = torch.maximum(ae, be)
    al = _scale_pow2(torch.broadcast_to(al, (K,) + shape), ae - e)
    bl = _scale_pow2(torch.broadcast_to(bl, (K,) + shape), be - e)
    z = torch.zeros(shape, dtype=SCALED_DTYPE, device=al.device)
    rows = []
    for i in range(K):
        rows += [al[i], bl[i]]
    return _finish_renorm(rows + [z, z], K, e)


def _pe(a: SVal, b: SVal, K: int, lifted: bool):
    """The K^2 products and their K^2 Dekker errors of a word product,
    stacked by slot (i*K+j: product of limbs i, j; K^2 + i*K+j: its
    error), from limbs lifted one by one to about 2^MUL_UNIFORM_EXP
    (lifted, with the per-pair placement exponents) or prescaled by their
    rung."""
    al, bl = a[0], b[0]
    U = MUL_UNIFORM_EXP
    D = None
    if lifted:
        ea, eb = _exp_bits(al), _exp_bits(bl)
        lift_a = torch.where(ea == 0, torch.zeros_like(ea), U + 127 - ea)
        lift_b = torch.where(eb == 0, torch.zeros_like(eb), U + 127 - eb)
        As, Bs = _scale_pow2(al, lift_a), _scale_pow2(bl, lift_b)
    else:
        C = center_for(K)
        As = torch.stack([al[i] * 2.0 ** (24 * i - C + U) for i in range(K)], 0)
        Bs = torch.stack([bl[i] * 2.0 ** (24 * i - C + U) for i in range(K)], 0)
    ah, alo = split(As)
    bh, blo = split(Bs)
    P = As[:, None] * Bs[None, :]
    E = ((ah[:, None] * bh[None, :] - P) + ah[:, None] * blo[None, :]
         + alo[:, None] * bh[None, :]) + alo[:, None] * blo[None, :]
    shape = tuple(P.shape[2:])
    PE = torch.cat([P.reshape((K * K,) + shape), E.reshape((K * K,) + shape)], 0)
    if lifted:
        D = (-(lift_a[:, None] + lift_b[None, :]) - center_for(K)).broadcast_to(
            (K, K) + shape).reshape((K * K,) + shape)
    return PE, D, shape


def mul_st_c(a: SVal, b: SVal, K: int) -> SVal:
    """Truncated scaled product (mpfloat.mul order, plan rows put back on
    the result's ladder by their two factors, two zero rows appended)."""
    PE, _, shape = _pe(a, b, K, lifted=False)
    ints, fmul = plan_tables(K)
    n_full, n_mul = int(ints[0]), int(ints[1])
    rows = [PE[int(i)] * float(fmul[0, j]) * float(fmul[1, j])
            for j, i in enumerate(ints[2 + n_full:2 + n_full + n_mul])]
    z = torch.zeros(shape, dtype=SCALED_DTYPE, device=a[0].device)
    e = torch.broadcast_to(a[1], shape) + torch.broadcast_to(b[1], shape) + center_for(K)
    return _finish_renorm(rows + [z, z], K, e)


def _extract_hi(xs: List[torch.Tensor], K: int):
    """Compact the K extracted rows into hi limbs and spill every limb whose
    exponent bits are < 26 (within 2 of float32's subnormal range) onto the
    lo ladder, exactly."""
    stack = _compact_hi(xs, K)
    keep = _exp_bits(stack) >= 26
    zero = torch.zeros_like(stack)
    spill = _mul_pow2_lift(torch.where(keep, zero, stack), 24 * K)
    return torch.where(keep, stack, zero), list(spill)


def add_full_c(a: SVal, b: SVal, K: int) -> Tuple[SVal, SVal]:
    """Word TwoSum hi + lo == a + b (mpfloat.add_full with the spill); lo
    stack: lifted residual, spill, the routed lo rows, two zero rows."""
    (al, ae), (bl, be) = a, b
    shape = tuple(torch.broadcast_shapes(al.shape[1:], bl.shape[1:], ae.shape, be.shape))
    al, bl = torch.broadcast_to(al, (K,) + shape), torch.broadcast_to(bl, (K,) + shape)
    ae, be = torch.broadcast_to(ae, shape), torch.broadcast_to(be, shape)
    e_hi = torch.maximum(ae, be)

    def route(limbs, we):
        d = we - e_hi
        keep = (_exp_bits(limbs) + d) >= 24
        zero = torch.zeros_like(limbs)
        return (_scale_pow2(torch.where(keep, limbs, zero), d),
                _scale_pow2(torch.where(keep, zero, limbs), d + 24 * K))

    a_hi, a_lo = route(al, ae)
    b_hi, b_lo = route(bl, be)
    rows = []
    for i in range(K):
        rows += [a_hi[i], b_hi[i]]
    xs = sweeps(rows, K, chain=False)
    his, spill = _extract_hi(xs, K)
    hi = _normalize_scaled(his, e_hi, K)
    lo_rows = list(_mul_pow2_lift(torch.stack(xs[K:]), 24 * K)) + spill
    for i in range(K):
        lo_rows += [a_lo[i], b_lo[i]]
    z = torch.zeros(shape, dtype=SCALED_DTYPE, device=al.device)
    return hi, _finish_renorm(lo_rows + [z, z], K, e_hi - 24 * K)


def mul_full_c(a: SVal, b: SVal, K: int) -> Tuple[SVal, SVal]:
    """Exact word product hi + lo == a * b (mpfloat.mul_full with the
    spill): the terms in plan order routed to the hi stack, each routed lo
    term kept at its slot; lo stack: lifted residual, spill, two zero rows,
    the slots in slot order."""
    PE, D, shape = _pe(a, b, K, lifted=True)
    exp_hi = torch.broadcast_to(a[1], shape) + torch.broadcast_to(b[1], shape) + \
        center_for(K)
    # every term routed at once (elementwise, so the same bits as the
    # kernel's loop over the plan): hi rows in plan order, lo parts back at
    # their slots
    plan = torch.as_tensor(mul_term_plan_full(K), dtype=torch.long, device=D.device)
    t = PE[plan]
    Dr = D[plan % (K * K)]
    keep = (_exp_bits(t) + Dr) >= 24
    zero = torch.zeros_like(t)
    hi_rows = list(_scale_pow2(torch.where(keep, t, zero), Dr))
    lo = torch.empty_like(t)
    lo[plan] = _scale_pow2(torch.where(keep, zero, t), Dr + 24 * K)
    xs = sweeps(hi_rows, K, chain=False)
    his, spill = _extract_hi(xs, K)
    hi = _normalize_scaled(his, exp_hi, K)
    z = torch.zeros(shape, dtype=SCALED_DTYPE, device=a[0].device)
    lo_rows = list(_mul_pow2_lift(torch.stack(xs[K:]), 24 * K)) + spill + [z, z] + \
        list(lo)
    return hi, _finish_renorm(lo_rows, K, exp_hi - 24 * K)


def wfma_acc_c(acc: WVal, a: WVal, b: WVal, K: int) -> WVal:
    """acc + a b with the cheap carry of mpwide_kernel.py:389-401: the hi
    product accumulates through one word TwoSum, everything at the
    2^-(24K) level through truncated adds (the lo word may grow a few bits
    past its rung until wnormalize_c)."""
    p0, p1 = mul_full_c(a[0], b[0], K)
    cross = add_st_c(mul_st_c(a[0], b[1], K), mul_st_c(a[1], b[0], K), K)
    h, e = add_full_c(acc[0], p0, K)
    l = add_st_c(add_st_c(acc[1], e, K), add_st_c(cross, p1, K), K)
    return h, l


def wnormalize_c(a: WVal, K: int) -> WVal:
    """Re-establish |w1| <~ 2^-(24K) |w0| after wfma_acc_c chains."""
    return add_full_c(a[0], a[1], K)
