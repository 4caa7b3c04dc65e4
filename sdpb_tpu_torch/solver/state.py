"""Solver state: the iterates (x, X, y, Y) as bucketed batches (port of
sdpb_tpu/solver/state.py: classic, scaled and wide)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..models.sdp import DeviceSDP
from ..ops import mpfloat as mp
from ..ops.mpfloat import MP
from ..ops.mpwide import MPW


@dataclass
class BucketState:
    x: MP        # [B, P]
    X_even: MP   # [B, pe, pe]
    X_odd: MP    # [B, po, po]
    Y_even: MP
    Y_odd: MP


@dataclass
class SolverState:
    y: MP                       # [N]
    buckets: List[BucketState]


def _clone(v):
    if isinstance(v, MPW):
        return MPW(_clone(w) for w in v.words)
    return MP(v.limbs.clone(), None if v.exp is None else v.exp.clone())


def clone_state(state: SolverState) -> SolverState:
    """A copy of a state that shares no storage with it."""
    return SolverState(y=_clone(state.y), buckets=[
        BucketState(**{f: _clone(getattr(b, f))
                       for f in ("x", "X_even", "X_odd", "Y_even", "Y_odd")})
        for b in state.buckets])


def _omega_word(g: int, wl, we, diag_real: torch.Tensor, diag_pad: torch.Tensor) -> MP:
    """Scaled Omega I on the real diagonal (limbs wl, exponent we), or word
    g of a wide one; word 0 also carries 1.0 on the padded diagonal, on its
    CENTER ladder (top limb 2^C at exponent -C)."""
    Kg = wl.shape[0]
    C = mp.center_for(Kg)
    limbs = torch.zeros((Kg,) + tuple(diag_real.shape), dtype=diag_real.dtype,
                        device=diag_real.device)
    limbs[0] = diag_real * float(wl[0])
    if g == 0:
        limbs[0] = limbs[0] + diag_pad * 2.0 ** C
    for k in range(1, Kg):
        limbs[k] = diag_real * float(wl[k])
    exp = torch.full(diag_real.shape, mp.EXP_ZERO, dtype=torch.int32,
                     device=diag_real.device)
    if g == 0:
        exp = torch.where(diag_pad > 0, -C, exp)
    return MP(limbs, torch.where(diag_real > 0, int(we), exp).to(torch.int32))


def initial_state(sdp: DeviceSDP, omega_primal, omega_dual) -> SolverState:
    """x = y = 0, X = Omega_p I and Y = Omega_d I on the real PSD dims;
    padded PSD dims get X = Y = I so their factorizations stay perfectly
    conditioned.  omega_* are host parts: float64 limbs [K] (classic) or a
    (float32 limbs [K], int32 exp) pair (scaled), where Omega keeps its own
    exponent and the padded 1.0 sits on the CENTER(K) ladder (top limb
    2^C at exponent -C), or a list of such pairs, one per word (wide): word
    0 carries Omega's top word and the padded identity, the lower words
    Omega's remaining mantissa on the real diagonal only."""
    K = sdp.b.K
    scaled = sdp.b.scaled
    device = sdp.device
    dtype = sdp.b.dtype
    buckets = []
    for bk in sdp.buckets:
        B = bk.batch

        def psd_init(psd_mask: torch.Tensor, omega) -> MP:
            n = psd_mask.shape[1]
            if n == 0:
                return mp.zeros((B, n, n), K, device, scaled=scaled)
            eye = torch.eye(n, dtype=dtype, device=device)
            diag_real = eye * psd_mask[:, None, :]
            diag_pad = eye * (1 - psd_mask)[:, None, :]
            if isinstance(omega, list):
                return MPW(_omega_word(g, wl, we, diag_real, diag_pad)
                           for g, (wl, we) in enumerate(omega))
            if scaled:
                return _omega_word(0, *omega, diag_real, diag_pad)
            limbs = torch.zeros((K, B, n, n), dtype=dtype, device=device)
            limbs[0] = diag_real * float(omega[0]) + diag_pad
            for k in range(1, K):
                limbs[k] = diag_real * float(omega[k])
            return MP(limbs)


        buckets.append(BucketState(
            x=mp.zeros((B, bk.shape.schur_size), K, device, scaled=scaled),
            X_even=psd_init(bk.psd_mask_even, omega_primal),
            X_odd=psd_init(bk.psd_mask_odd, omega_primal),
            Y_even=psd_init(bk.psd_mask_even, omega_dual),
            Y_odd=psd_init(bk.psd_mask_odd, omega_dual)))
    return SolverState(y=mp.zeros((sdp.dual_dim,), K, device, scaled=scaled),
                       buckets=buckets)
