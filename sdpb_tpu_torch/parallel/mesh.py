"""Block sharding over the ranks of a run (the port's counterpart of the
shard_map path of sdpb_tpu/parallel/mesh.py).

The J blocks of a problem lie on the batch axis of its shape buckets.
Built with build_device_sdp(pad_to=world size), every bucket's batch is a
multiple of the world size, its blocks placed by the LPT slot plan
(parallel/planner.py), and rank r holds the r-th of its equal contiguous
slices: `shard_sdp`, `shard_state`.  The problem's objective and b and the
state's y are whole on every rank.  The iteration's reductions over the
blocks become collectives (solver/step.py):

  * Q contributions, B^T x, the dy assembly, Tr(XY), the objectives -> MP sum
    (every rank's value gathered, added in rank order)
  * error norms and the KKT residual                                  -> max
  * the step lengths' least eigenvalues                               -> min
    (every rank's value gathered, so that a NaN on one reaches all)

`gather_state` puts a sharded state back together on rank 0 (on the CPU,
through host copies over the gloo group) for checkpoints and the solution;
it is the counterpart of replicate_tree.

Sharding the rows of one block too large for a card (the JAX package's
GSPMD path under --maxBlockMemory) is not ported (ROADMAP A25): a run of
several processes with such a block stops.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..models.sdp import Bucket, DeviceSDP
from ..ops.mpfloat import MP
from ..ops.mpwide import MPW
from ..solver.state import BucketState, SolverState
from .distributed import Group

_MP_FIELDS = ("bases_even", "bases_odd", "emb_even", "emb_odd", "Bmat", "c")
_MASKS = ("mask", "row_mask", "psd_mask_even", "psd_mask_odd")
_STATE_FIELDS = ("x", "X_even", "X_odd", "Y_even", "Y_odd")


def _map_batch(v, limbs_fn, exp_fn):
    """An MP or MPW with its limbs [K, B, ...] and exponents [B, ...] (the
    batch axis) mapped."""
    if isinstance(v, MPW):
        return MPW(_map_batch(w, limbs_fn, exp_fn) for w in v.words)
    return MP(limbs_fn(v.limbs), None if v.exp is None else exp_fn(v.exp))


def _to(v, device):
    return _map_batch(v, lambda t: t.to(device), lambda t: t.to(device))


def _span(batch: int, rank: int, world_size: int) -> slice:
    if batch % world_size:
        raise ValueError(f"bucket batch {batch} is not a multiple of the world size "
                         f"{world_size}; build the DeviceSDP with pad_to={world_size}")
    n = batch // world_size
    return slice(rank * n, (rank + 1) * n)


def _sliced(v, s: slice, device):
    return _map_batch(v, lambda t: t[:, s].contiguous().to(device),
                      lambda t: t[s].contiguous().to(device))


def shard_sdp(sdp: DeviceSDP, rank: int, world_size: int, device) -> DeviceSDP:
    """Rank `rank`'s contiguous slice of every bucket's batch, on `device`."""
    buckets = []
    for bk in sdp.buckets:
        s = _span(bk.batch, rank, world_size)
        buckets.append(Bucket(**{f: _sliced(getattr(bk, f), s, device) for f in _MP_FIELDS},
                              **{f: getattr(bk, f)[s].contiguous().to(device) for f in _MASKS},
                              real_sizes=bk.real_sizes[s], shape=bk.shape))
    return DeviceSDP(objective_const=_to(sdp.objective_const, device),
                     b=_to(sdp.b, device), buckets=buckets)


def shard_state(state: SolverState, rank: int, world_size: int, device) -> SolverState:
    """Rank `rank`'s slice of every bucket state's batch, on `device`."""
    buckets = []
    for bs in state.buckets:
        s = _span(bs.x.shape[0], rank, world_size)
        buckets.append(BucketState(**{f: _sliced(getattr(bs, f), s, device)
                                      for f in _STATE_FIELDS}))
    return SolverState(y=_to(state.y, device), buckets=buckets)


def _gather(t: torch.Tensor, axis: int, group: Group) -> Optional[torch.Tensor]:
    host = t.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(group.world_size)] \
        if group.is_coordinator else None
    dist.gather(host, parts, dst=0)
    return torch.cat(parts, axis) if group.is_coordinator else None


def gather_state(state: SolverState, group: Group) -> Optional[SolverState]:
    """The whole state on rank 0, on the CPU (None on the other ranks):
    every rank's slices gathered through host copies, since gloo gathers
    no CUDA tensor; y is rank 0's own.  Every rank must call it."""
    buckets = [BucketState(**{f: _map_batch(getattr(bs, f),
                                            lambda t: _gather(t, 1, group),
                                            lambda t: _gather(t, 0, group))
                              for f in _STATE_FIELDS}) for bs in state.buckets]
    if not group.is_coordinator:
        return None
    return SolverState(y=_to(state.y, "cpu"), buckets=buckets)


def _bucket_bytes(bk: Bucket) -> int:
    """Approximate device footprint of one block of a bucket: the limbs of
    the four PSD matrices, S and the B band (the RAM model of
    read_block_costs.cxx:69-87, as the JAX package counts it)."""
    itemsize = 4 if bk.Bmat.scaled else 8
    sh = bk.shape
    psd, psd_o, P = sh.dim * sh.h_even, sh.dim * sh.h_odd, sh.schur_size
    words = 5 * (psd * psd + psd_o * psd_o) + 3 * P * P + 2 * P * bk.Bmat.shape[-1]
    return bk.Bmat.K * words * itemsize


def check_block_memory(sdp: DeviceSDP, max_block_memory: int) -> None:
    """Stop a run of several processes whose blocks exceed
    --maxBlockMemory: sharding a block's rows over the ranks is not ported
    (ROADMAP A25), and the batch split would leave each such block whole on
    one card."""
    big = [(bk.shape, _bucket_bytes(bk)) for bk in sdp.buckets
           if _bucket_bytes(bk) > max_block_memory]
    if big:
        raise SystemExit(
            f"blocks of {big[0][1]} bytes (bucket {big[0][0]}) exceed --maxBlockMemory "
            f"{max_block_memory}: sharding a block's rows over the ranks is not ported to "
            f"PyTorch (ROADMAP A25); raise --maxBlockMemory to keep each block on one card")
