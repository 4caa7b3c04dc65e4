"""Device-side SDP problem: shape-bucketed, batched blocks (port of
sdpb_tpu/models/sdp.py, one device), staged as classic float64 limbs, in
the scaled representation (float32 limbs and int32 exponents) or, beyond 9
scaled limbs, in the wide one (ops/mpwide.py: two scaled words).

Blocks with equal dim and num_points in the same `quant` band (QUANT = 8
points, the default "quantized" policy) or of one exact shape ("exact")
share a bucket; each is zero-padded to the bucket's
(num_points, h_even, h_odd) and carries element masks:
  row_mask [B, P]              1 for real constraint rows (pair, point)
  psd_mask_even/odd [B, m*h]   1 for real PSD dimensions
Constraint rows are (pair, point) with points contiguous per pair, pairs
ordered (s, r), r <= s.  The layout and masks equal the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..io.sdp_zip import SDPData
from ..ops import mpfloat as mp, mpwide
from ..ops.mpfloat import MP
from ..parallel.planner import block_cost_heuristic, plan_block_slots

QUANT = 8


@dataclass(frozen=True)
class BucketShape:
    dim: int          # m_j
    num_points: int   # padded sample-point count
    h_even: int       # padded rows of the even bilinear basis
    h_odd: int        # padded rows of the odd bilinear basis (may be 0)

    @property
    def schur_size(self) -> int:
        return self.num_points * self.dim * (self.dim + 1) // 2

    @property
    def n_pairs(self) -> int:
        return self.dim * (self.dim + 1) // 2


@dataclass(frozen=True)
class RealSize:
    """Per-block real (unpadded) dims."""
    block_index: int
    num_points: int
    h_even: int
    h_odd: int


@dataclass
class Bucket:
    """A batch of same-(padded-)shape blocks on the device."""
    bases_even: MP              # [B, h_e, np]
    bases_odd: MP               # [B, h_o, np]
    emb_even: MP                # [B, m*h_e, m*np] block-diagonal embedding
    emb_odd: MP                 # [B, m*h_o, m*np]
    Bmat: MP                    # [B, P, N]
    c: MP                       # [B, P]
    mask: torch.Tensor          # [B] 1.0 per real block (masks in the limb dtype)
    row_mask: torch.Tensor      # [B, P]
    psd_mask_even: torch.Tensor  # [B, m*h_e]
    psd_mask_odd: torch.Tensor   # [B, m*h_o]
    real_sizes: tuple           # tuple[RealSize]
    shape: BucketShape

    @property
    def batch(self) -> int:
        return self.mask.shape[0]


@dataclass
class DeviceSDP:
    """The problem on one device: objectives and bucketed blocks."""
    objective_const: MP  # scalar
    b: MP                # [N]
    buckets: List[Bucket]

    @property
    def dual_dim(self) -> int:
        return self.b.shape[0]

    @property
    def device(self) -> torch.device:
        return self.b.device

    @property
    def total_psd_rows(self) -> int:
        """Sum of the real PSD block sizes (the denominator of mu)."""
        return sum(bk.shape.dim * (rs.h_even + rs.h_odd)
                   for bk in self.buckets for rs in bk.real_sizes
                   if rs.block_index >= 0)


def _embed_blockdiag(basis_limbs: np.ndarray, dim: int) -> np.ndarray:
    """Replicate basis [K, h, np] into block-diagonal [K, dim*h, dim*np]."""
    K, h, n = basis_limbs.shape
    out = np.zeros((K, dim * h, dim * n), dtype=basis_limbs.dtype)
    for d in range(dim):
        out[:, d * h:(d + 1) * h, d * n:(d + 1) * n] = basis_limbs
    return out


def bucket_key(dim: int, num_points: int, policy: str = "quantized",
               quant: int = QUANT) -> tuple:
    """The bucket of a block (sdpb_tpu/models/sdp.py:154-157): under
    "quantized" blocks of one dim whose point counts round up to the same
    multiple of `quant` share a bucket; under "exact" each exact shape has
    its own."""
    if policy == "exact":
        return (dim, num_points, "exact")
    return (dim, -(-num_points // quant) * quant)


def build_device_sdp(sdp: SDPData, device, scaled_limbs: int = 0,
                     quant: int = QUANT, shape_policy: str = "quantized",
                     pad_to: int = 1, block_costs: Optional[dict] = None) -> DeviceSDP:
    """Bucket the host blocks by shape, zero-pad each block to its
    bucket's shape, and stage everything to `device`.  The host SDPData
    must hold float64 limbs.  scaled_limbs = 0 stages them as classic
    float64 MP tensors; scaled_limbs = K32 > 0 converts them exactly into
    the scaled representation with K32 float32 limbs (the host then needs
    at least ceil(24 K32 / 53) + 1 limbs), as sdpb_tpu's
    build_device_sdp(..., scaled_limbs=K32); K32 > 9 stages wide values
    (mpwide.f64_limbs_to_wide_parts, word by word).  `shape_policy` and
    `quant` are bucket_key's (the timing run, parallel/timing.py, picks
    them).

    pad_to > 1 (the world size of a run of several processes) pads each
    bucket's batch to a multiple of pad_to with padding blocks (mask 0,
    block index -1, zero data) and places the blocks by plan_block_slots,
    so that the contiguous equal split of the batch over the ranks
    (parallel/mesh.py) balances their cost: the costs are the timing run's
    measured block_costs ({str(block index): seconds}) when it has any,
    else the reference's RAM heuristic."""
    device = torch.device(device)
    if np.asarray(sdp.b).dtype != np.float64:
        raise TypeError("the port stages float64 host limbs")
    K = sdp.b.shape[0]
    N = sdp.dual_dim
    if scaled_limbs:
        need = -(-(24 * scaled_limbs) // 53) + 1
        if K < need:
            raise ValueError(f"{K} float64 host limbs carry {53 * K} bits, fewer "
                             f"than the {need} limbs scaled K={scaled_limbs} needs")
    mask_dtype = mp.SCALED_DTYPE if scaled_limbs else torch.float64

    def stage(arr: np.ndarray) -> MP:
        if scaled_limbs > mp.MAX_SCALED_K:
            return mpwide.wide_parts_to_mp(
                mpwide.f64_limbs_to_wide_parts(arr, scaled_limbs), device)
        if scaled_limbs:
            return mp.from_parts(*mp.f64_limbs_to_scaled_parts(arr, scaled_limbs),
                                 device)
        return MP(torch.as_tensor(np.ascontiguousarray(arr), dtype=torch.float64,
                                  device=device))

    def stage_mask(arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=mask_dtype, device=device)

    groups: Dict[tuple, List] = {}
    for blk in sdp.blocks:
        groups.setdefault(bucket_key(blk.dim, blk.num_points, shape_policy, quant),
                          []).append(blk)

    buckets = []
    for _, blks in sorted(groups.items(), key=lambda kv: str(kv[0])):
        dim = blks[0].dim
        np_pad = max(b.num_points for b in blks)
        he_pad = max(b.bases_even.shape[1] for b in blks)
        ho_pad = max(b.bases_odd.shape[1] for b in blks)
        shape = BucketShape(dim=dim, num_points=np_pad, h_even=he_pad,
                            h_odd=ho_pad)
        if pad_to > 1:
            costs = [float(block_costs.get(str(b.index), 0.0)) for b in blks] \
                if block_costs else []
            if not any(costs):
                costs = [block_cost_heuristic(b.dim, b.num_points, b.bases_even.shape[1],
                                              b.bases_odd.shape[1], N) for b in blks]
            blks = [None if i is None else blks[i] for i in plan_block_slots(costs, pad_to)]
        B = len(blks)
        n_pairs = shape.n_pairs
        P = shape.schur_size

        bases_even = np.zeros((K, B, he_pad, np_pad))
        bases_odd = np.zeros((K, B, ho_pad, np_pad))
        c = np.zeros((K, B, P))
        Bmat = np.zeros((K, B, P, N))
        mask = np.zeros(B)
        row_mask = np.zeros((B, P))
        pm_even = np.zeros((B, dim * he_pad))
        pm_odd = np.zeros((B, dim * ho_pad))
        real_sizes = []
        for i, blk in enumerate(blks):
            if blk is None:
                real_sizes.append(RealSize(-1, np_pad, he_pad, ho_pad))
                continue
            mask[i] = 1.0
            npr = blk.num_points
            he = blk.bases_even.shape[1]
            ho = blk.bases_odd.shape[1]
            real_sizes.append(RealSize(blk.index, npr, he, ho))
            bases_even[:, i, :he, :npr] = blk.bases_even
            bases_odd[:, i, :ho, :npr] = blk.bases_odd
            c[:, i].reshape(K, n_pairs, np_pad)[:, :, :npr] = \
                blk.c.reshape(K, n_pairs, npr)
            Bmat[:, i].reshape(K, n_pairs, np_pad, N)[:, :, :npr] = \
                blk.B.reshape(K, n_pairs, npr, N)
            row_mask[i].reshape(n_pairs, np_pad)[:, :npr] = 1.0
            pm_even[i].reshape(dim, he_pad)[:, :he] = 1.0
            pm_odd[i].reshape(dim, ho_pad)[:, :ho] = 1.0

        emb_even = np.stack([_embed_blockdiag(bases_even[:, i], dim)
                             for i in range(B)], axis=1)
        emb_odd = np.stack([_embed_blockdiag(bases_odd[:, i], dim)
                            for i in range(B)], axis=1)
        buckets.append(Bucket(
            bases_even=stage(bases_even), bases_odd=stage(bases_odd),
            emb_even=stage(emb_even), emb_odd=stage(emb_odd),
            Bmat=stage(Bmat), c=stage(c),
            mask=stage_mask(mask), row_mask=stage_mask(row_mask),
            psd_mask_even=stage_mask(pm_even), psd_mask_odd=stage_mask(pm_odd),
            real_sizes=tuple(real_sizes), shape=shape))

    return DeviceSDP(objective_const=stage(np.asarray(sdp.objective_const)),
                     b=stage(np.asarray(sdp.b)), buckets=buckets)
