"""Solver state: the iterates (x, X, y, Y) as bucketed batches (port of
sdpb_tpu/solver/state.py, classic and scaled)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..models.sdp import DeviceSDP
from ..ops import mpfloat as mp
from ..ops.mpfloat import MP


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


def initial_state(sdp: DeviceSDP, omega_primal, omega_dual) -> SolverState:
    """x = y = 0, X = Omega_p I and Y = Omega_d I on the real PSD dims;
    padded PSD dims get X = Y = I so their factorizations stay perfectly
    conditioned.  omega_* are host parts: float64 limbs [K] (classic) or a
    (float32 limbs [K], int32 exp) pair (scaled), where Omega keeps its own
    exponent and the padded 1.0 sits on the CENTER(K) ladder (top limb
    2^C at exponent -C)."""
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
            limbs_h, exp_h = omega if scaled else (omega, None)
            one = 2.0 ** mp.center_for(K) if scaled else 1.0
            eye = torch.eye(n, dtype=dtype, device=device)
            diag_real = eye * psd_mask[:, None, :]
            diag_pad = eye * (1 - psd_mask)[:, None, :]
            limbs = torch.zeros((K, B, n, n), dtype=dtype, device=device)
            limbs[0] = diag_real * float(limbs_h[0]) + diag_pad * one
            for k in range(1, K):
                limbs[k] = diag_real * float(limbs_h[k])
            if not scaled:
                return MP(limbs)
            exp = torch.full((B, n, n), mp.EXP_ZERO, dtype=torch.int32, device=device)
            exp = torch.where(diag_pad > 0, -mp.center_for(K), exp)
            exp = torch.where(diag_real > 0, int(exp_h), exp).to(torch.int32)
            return MP(limbs, exp)

        buckets.append(BucketState(
            x=mp.zeros((B, bk.shape.schur_size), K, device, scaled=scaled),
            X_even=psd_init(bk.psd_mask_even, omega_primal),
            X_odd=psd_init(bk.psd_mask_odd, omega_primal),
            Y_even=psd_init(bk.psd_mask_even, omega_dual),
            Y_odd=psd_init(bk.psd_mask_odd, omega_dual)))
    return SolverState(y=mp.zeros((sdp.dual_dim,), K, device, scaled=scaled),
                       buckets=buckets)
