"""The wide GEMM kernel's arithmetic in plain PyTorch, in the kernel's own
operation order: the port of the compact ops of
sdpb_tpu/ops/mpwide_kernel.py:410-734 (add_st_c, mul_st_c, add_full_c,
mul_full_c, wfma_acc_c, wnormalize_c), which csrc/mp_wide.cuh performs
operation for operation.  wfma_acc_c is split into its accumulator-free
part wfma_term_c and its accumulate part wacc_c, the kernel's two passes;
kernels.mp_matmul_wide_plain runs them.

A value here is an SVal pair (float32 limbs [K, *shape], int32 exp
[*shape]); a wide value a WVal pair (w0, w1) of SVals with
|w1| <~ 2^-(24K) |w0|.  Shapes broadcast (the GEMM feeds [.., M, 1] and
[.., 1, N] operands).

The three-word kernels (csrc/mp_wide3.cuh: the elementwise sum and
product, and the GEMM) compose the same word ops in the order of
renormalize_words_c, wmul_g_c and wadd_g_c below; a value there is a
tuple of G SVals.

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
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .eft import split
from .mpfloat import (EXP_ZERO, MUL_UNIFORM_EXP, SCALED_DTYPE, _compact_hi, _exp_bits,
                      _normalize_scaled, _scale_pow2, center_for, device_const,
                      mul_term_plan, mul_term_plan_full, renorm, sweeps)

SVal = Tuple[torch.Tensor, torch.Tensor]
WVal = Tuple[SVal, SVal]
# Called with the `apart` mask of each word TwoSum (word_two_sum_c)
Skip = Optional[Callable[[torch.Tensor], None]]


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
    plan = device_const(("mul_plan_full", K), D.device, lambda: torch.as_tensor(
        mul_term_plan_full(K), dtype=torch.long, device=D.device))
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


def mul_full3_c(a: SVal, b: SVal, K: int) -> Tuple[SVal, SVal, SVal]:
    """The exact word product as three words, hi + mid + lo == a * b up to
    the last word's truncation (2^-(72K) of the product): mul_full_c with
    a third ladder 48K binary digits down for the terms the second cannot
    hold as normals, and the second word extracted error-free as the first
    is (its residual and spill join the third).  The stacks, each in the
    order of mul_full_c's lo stack: mid: lifted residual of hi, spill, two
    zero rows, the mid slots; lo: lifted residual of mid, its spill, two
    zero rows, the third ladder's slots."""
    PE, D, shape = _pe(a, b, K, lifted=True)
    exp_hi = torch.broadcast_to(a[1], shape) + torch.broadcast_to(b[1], shape) + \
        center_for(K)
    plan = device_const(("mul_plan_full", K), D.device, lambda: torch.as_tensor(
        mul_term_plan_full(K), dtype=torch.long, device=D.device))
    t = PE[plan]
    Dr = D[plan % (K * K)]
    eb = _exp_bits(t)
    keep = (eb + Dr) >= 24
    keep_mid = ~keep & ((eb + Dr + 24 * K) >= 24)
    zero = torch.zeros_like(t)
    hi_rows = list(_scale_pow2(torch.where(keep, t, zero), Dr))
    mid = torch.empty_like(t)
    mid[plan] = _scale_pow2(torch.where(keep_mid, t, zero), Dr + 24 * K)
    third = torch.empty_like(t)
    third[plan] = _scale_pow2(torch.where(keep | keep_mid, zero, t), Dr + 48 * K)
    z = torch.zeros(shape, dtype=SCALED_DTYPE, device=a[0].device)
    xs = sweeps(hi_rows, K, chain=False)
    his, spill = _extract_hi(xs, K)
    hi = _normalize_scaled(his, exp_hi, K)
    ys = sweeps(list(_mul_pow2_lift(torch.stack(xs[K:]), 24 * K)) + spill + [z, z] +
                list(mid), K, chain=False)
    mids, spill2 = _extract_hi(ys, K)
    mw = _normalize_scaled(mids, exp_hi - 24 * K, K)
    lo_rows = list(_mul_pow2_lift(torch.stack(ys[K:]), 24 * K)) + spill2 + [z, z] + \
        list(third)
    return hi, mw, _finish_renorm(lo_rows, K, exp_hi - 48 * K)


def wfma_term_c(a: WVal, b: WVal, K: int) -> Tuple[SVal, SVal]:
    """The accumulator-free part of wfma_acc_c: the exact hi product p0 and
    the carry cp = (a0 b1 + a1 b0) + p1 of one term a b.  Every term of a
    contraction is independent of the others, so the GEMM computes them all
    at once."""
    p0, p1 = mul_full_c(a[0], b[0], K)
    cross = add_st_c(mul_st_c(a[0], b[1], K), mul_st_c(a[1], b[0], K), K)
    return p0, add_st_c(cross, p1, K)


def wacc_c(acc: WVal, p0: SVal, cp: SVal, K: int) -> WVal:
    """The accumulate part of wfma_acc_c: acc + (p0, cp), the hi product
    through one word TwoSum, the rest through truncated adds."""
    h, e = add_full_c(acc[0], p0, K)
    return h, add_st_c(add_st_c(acc[1], e, K), cp, K)


def wfma_acc_c(acc: WVal, a: WVal, b: WVal, K: int) -> WVal:
    """acc + a b with the cheap carry of mpwide_kernel.py:389-401: the hi
    product accumulates through one word TwoSum, everything at the
    2^-(24K) level through truncated adds (the lo word may grow a few bits
    past its rung until wnormalize_c).  wacc_c of wfma_term_c: the same
    operations on the same operands."""
    p0, cp = wfma_term_c(a, b, K)
    return wacc_c(acc, p0, cp, K)


def wnormalize_c(a: WVal, K: int) -> WVal:
    """Re-establish |w1| <~ 2^-(24K) |w0| after wfma_acc_c chains."""
    return add_full_c(a[0], a[1], K)


# ---------------------------------------------------------------------------
# Three words: the elementwise sum and product and the GEMM
#
# The generic-G branches of the JAX package's mpwide.add and mul
# (sdpb_tpu/ops/mpwide.py:229-306), with three changes, each where the JAX
# branch misses mpmath at G = 3 (ROADMAP C; two words never meet them):
#   * the word TwoSum leaves words more than 24 K digits apart as they
#     are: add_full routes what its hi ladder cannot hold onto a lo ladder
#     24 K digits down, whose float32 limbs reach only ~24 K + 150 digits
#     below the top, and a word farther down loses its low limbs there;
#   * after the bottom-up sweeps and the tail, two rounds of a bottom-up
#     and a top-down pass of word TwoSums over the kept words (the
#     compaction that closes mpfloat.renorm, a word up, twice, since a
#     cancellation inside the first round can leave a zero word between
#     two that overlap): after a cancellation the sweeps can leave word 0
#     zero or holding a few digits and a lower word holding the value, so
#     that word 0 no longer carries the value to 24 K digits, which the
#     mixed-precision solves' round_to(r, Kf) reads (refined solves stalled
#     at 2^-219, 2^-442 and 2^-456 of 648 bits with fewer passes);
#   * the exact product a0 b0 is three words (mul_full3_c): a word's limbs
#     can span a little more than 24 K digits (much more where its content
#     has gaps), and a product of two such needs more than mul_full's two
#     words, which lost ~2^-(48 K + 8) of it.


def apart(ae: torch.Tensor, be: torch.Tensor, K: int) -> torch.Tensor:
    """Where two words' exponents lie more than 24 K binary digits apart:
    the smaller word then lies wholly below the larger's last digit, and
    (larger, smaller) is already an exact word TwoSum."""
    return torch.abs(ae - be) > 24 * K


class SkipTally:
    """Counts the word TwoSums that word_two_sum_c leaves as they are
    (words more than 24 K digits apart), which the three-word kernels skip
    alike: the data-dependent work their bounds take off.  `skip(needed)`
    gives the callable an op takes, counting the elements that the bool
    mask `needed` marks (all of them where it is None)."""

    def __init__(self):
        self._parts: List[torch.Tensor] = []

    def skip(self, needed: Optional[torch.Tensor] = None) -> Skip:
        return lambda far: self._parts.append((far if needed is None else far & needed).sum())

    @property
    def count(self) -> int:
        return sum(int(p) for p in self._parts)


def word_two_sum_c(a: SVal, b: SVal, K: int, skip: Skip = None) -> Tuple[SVal, SVal]:
    """add_full_c(a, b), but (larger, smaller) as they are where the
    exponents lie more than 24 K apart; `skip` gets that mask."""
    hi, lo = add_full_c(a, b, K)
    shape = hi[1].shape
    far = torch.broadcast_to(apart(a[1], b[1], K), shape)
    if skip is not None:
        skip(far)
    a_top = torch.broadcast_to(a[1] >= b[1], shape)

    def pick(c, x, y):
        return (torch.where(c, torch.broadcast_to(x[0], (K,) + shape),
                            torch.broadcast_to(y[0], (K,) + shape)),
                torch.where(c, torch.broadcast_to(x[1], shape),
                            torch.broadcast_to(y[1], shape)))

    return pick(far, pick(a_top, a, b), hi), pick(far, pick(a_top, b, a), lo)


def renormalize_words_c(ws: List[SVal], G: int, K: int, skip: Skip = None) -> Tuple[SVal, ...]:
    """renormalize_words of ops/mpwide.py (the JAX package's) with the
    compact ops: G word TwoSum sweeps (word_two_sum_c) over the list,
    bottom up, the residue below word G-1 folded into it (add_st_c), then
    two rounds of a bottom-up and a top-down pass of word TwoSums over the
    G words."""
    xs = list(ws)
    m = len(xs)
    for k in range(min(G, m - 1)):
        for i in range(m - 2, k - 1, -1):
            xs[i], xs[i + 1] = word_two_sum_c(xs[i], xs[i + 1], K, skip)
    if m > G:
        tail = xs[G - 1]
        for i in range(G, m):
            tail = add_st_c(tail, xs[i], K)
        xs[G - 1] = tail
    xs = xs[:G]
    for i in (list(range(G - 2, -1, -1)) + list(range(G - 1))) * 2:
        xs[i], xs[i + 1] = word_two_sum_c(xs[i], xs[i + 1], K, skip)
    return tuple(xs)


def wmul_g_c(a: Tuple[SVal, ...], b: Tuple[SVal, ...], K: int,
             skip: Skip = None) -> Tuple[SVal, ...]:
    """The generic-G product: the top word product exact in three words
    (mul_full3_c), the others below the last kept word diagonal in two
    (mul_full_c), truncated ones (mul_st_c) on it, the words listed by
    diagonal in the loop order of (g1, g2), then renormalize_words_c."""
    G = len(a)
    diag: List[List[SVal]] = [[] for _ in range(G + 1)]
    for g1 in range(G):
        for g2 in range(G - g1):
            n = g1 + g2
            if n == 0:
                for d, w in enumerate(mul_full3_c(a[0], b[0], K)):
                    diag[d].append(w)
            elif n < G - 1:
                hi, lo = mul_full_c(a[g1], b[g2], K)
                diag[n].append(hi)
                diag[n + 1].append(lo)
            else:
                diag[n].append(mul_st_c(a[g1], b[g2], K))
    return renormalize_words_c([w for d in diag for w in d], G, K, skip)


def wadd_g_c(a: Tuple[SVal, ...], b: Tuple[SVal, ...], K: int,
             skip: Skip = None) -> Tuple[SVal, ...]:
    """The generic-G sum: the words interleaved a0 b0 a1 b1 ..., then
    renormalize_words_c."""
    ws: List[SVal] = []
    for wa, wb in zip(a, b):
        ws += [wa, wb]
    return renormalize_words_c(ws, len(a), K, skip)
