"""Problem and state carried across from the JAX package.

The inputs are the JAX package's `DeviceSDP` / `SolverState` with numpy
leaves (e.g. `jax.tree.map(np.asarray, x)` on the JAX side), read here by
attribute only, so this module never imports JAX yet both packages can
iterate from the same problem and state.  Classic values carry float64
limbs; scaled values (limbs, exp) carry float32 limbs and int32 exponents,
masks then float32.  The wide representation (`MPW`, a tuple of words) is
refused.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.sdp import Bucket, BucketShape, DeviceSDP, RealSize
from .ops.mpfloat import MP
from .solver.state import BucketState, SolverState


def _t(x, device) -> torch.Tensor:
    """A host array as a tensor (a copy) in its own float type."""
    x = np.asarray(x)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    return torch.tensor(x, device=device)


def _mp(x, device) -> MP:
    if hasattr(x, "words"):
        raise TypeError("wide (MPW) values do not carry across: the wide "
                        "representation is not ported")
    if getattr(x, "exp", None) is not None:
        return MP(torch.tensor(np.asarray(x.limbs, dtype=np.float32), device=device),
                  torch.tensor(np.asarray(x.exp, dtype=np.int32), device=device))
    return MP(torch.tensor(np.asarray(x.limbs, dtype=np.float64), device=device))


def device_sdp_from_numpy(sdp, device) -> DeviceSDP:
    """The JAX package's DeviceSDP (numpy leaves) as the port's."""
    device = torch.device(device)
    buckets = []
    for bk in sdp.buckets:
        sh = bk.shape
        buckets.append(Bucket(
            bases_even=_mp(bk.bases_even, device), bases_odd=_mp(bk.bases_odd, device),
            emb_even=_mp(bk.emb_even, device), emb_odd=_mp(bk.emb_odd, device),
            Bmat=_mp(bk.Bmat, device), c=_mp(bk.c, device),
            mask=_t(bk.mask, device), row_mask=_t(bk.row_mask, device),
            psd_mask_even=_t(bk.psd_mask_even, device),
            psd_mask_odd=_t(bk.psd_mask_odd, device),
            real_sizes=tuple(RealSize(rs.block_index, rs.num_points, rs.h_even,
                                      rs.h_odd) for rs in bk.real_sizes),
            shape=BucketShape(sh.dim, sh.num_points, sh.h_even, sh.h_odd)))
    return DeviceSDP(objective_const=_mp(sdp.objective_const, device),
                     b=_mp(sdp.b, device), buckets=buckets)


def state_from_numpy(state, device) -> SolverState:
    """The JAX package's SolverState (numpy leaves) as the port's."""
    device = torch.device(device)
    return SolverState(
        y=_mp(state.y, device),
        buckets=[BucketState(x=_mp(bs.x, device), X_even=_mp(bs.X_even, device),
                             X_odd=_mp(bs.X_odd, device), Y_even=_mp(bs.Y_even, device),
                             Y_odd=_mp(bs.Y_odd, device)) for bs in state.buckets])

