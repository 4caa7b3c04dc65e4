"""PVM -> SDP block sampling, the core of the pvm2sdp and sdp2input
conversions (the port's copy of sdpb_tpu/convert/dual_constraint_group.py,
after the reference's Dual_Constraint_Group.cxx:33-93):

  (1, y) . M(x) >= 0  at points x_k with scalings s_k becomes

    c_p          =  s_k * P^{rc}_0(x_k)
    B[p, n-1]    = -s_k * P^{rc}_n(x_k)          (n = 1..N)
    bases_even   = sqrt(s_k)       q_i(x_k)      (i <= deg/2)
    bases_odd    = sqrt(x_k s_k)   q_i(x_k)      (i <= (deg+1)/2 - 1)

  with p = (c, r <= c, k) flattened points-innermost (the tuple ordering
  of SDP.hxx:52-58).
"""
from __future__ import annotations

from typing import List

import mpmath
import numpy as np

from ..io.sdp_zip import BlockData, SDPData
from .poly import PolynomialVectorMatrix


def _to_limbs(values, K, np_dtype, shape) -> np.ndarray:
    out = np.zeros((K, len(values)), dtype=np_dtype)
    for i, v in enumerate(values):
        x = v
        for k in range(K):
            hi = np_dtype(float(x))
            out[k, i] = hi
            x = x - mpmath.mpf(float(hi))
    return out.reshape((K,) + shape)


def dual_constraint_group(block_index: int, m: PolynomialVectorMatrix,
                          K: int, np_dtype=np.float64) -> BlockData:
    """Sample one PVM into a BlockData (host limb arrays)."""
    assert m.rows == m.cols, (m.rows, m.cols)
    dim = m.rows
    num_points = m.num_points
    degree = num_points - 1
    vector_dim = len(m.elt(0, 0))
    N = vector_dim - 1
    P = num_points * dim * (dim + 1) // 2

    xs = [mpmath.mpf(x) for x in m.sample_points]
    ss = [mpmath.mpf(s) for s in m.sample_scalings]

    c_vals: List = []
    B_vals: List = []
    for cc in range(dim):
        for rr in range(cc + 1):
            pv = m.elt(rr, cc)
            for k in range(num_points):
                x, scale = xs[k], ss[k]
                c_vals.append(scale * pv[0](x))
                for n in range(1, vector_dim):
                    B_vals.append(-scale * pv[n](x))

    delta1 = degree // 2
    delta2 = (degree + 1) // 2 - 1   # may be -1 for degree 0 -> empty odd

    def sample_basis(max_degree, scalings):
        # sample_bilinear_basis.cxx:22-38
        rows = []
        for i in range(max_degree + 1):
            q = m.bilinear_basis[i]
            for k in range(num_points):
                rows.append(mpmath.sqrt(scalings[k]) * q(xs[k]))
        return rows, max_degree + 1

    even_vals, h_even = sample_basis(delta1, ss)
    if delta2 >= 0:
        odd_scalings = [xs[k] * ss[k] for k in range(num_points)]
        odd_vals, h_odd = sample_basis(delta2, odd_scalings)
    else:
        odd_vals, h_odd = [], 0

    return BlockData(
        index=block_index, dim=dim, num_points=num_points,
        bases_even=_to_limbs(even_vals, K, np_dtype, (h_even, num_points)),
        bases_odd=_to_limbs(odd_vals, K, np_dtype, (h_odd, num_points))
        if h_odd else np.zeros((K, 0, num_points), dtype=np_dtype),
        c=_to_limbs(c_vals, K, np_dtype, (P,)),
        B=_to_limbs(B_vals, K, np_dtype, (P, N)),
    )


def _dcg_worker(args):
    i, m, K, np_dtype_name, prec = args
    with mpmath.workprec(prec):
        return dual_constraint_group(i, m, K, np.dtype(np_dtype_name).type)


def assemble_sdp(objective_const, dual_objective_b, pvms: List[PolynomialVectorMatrix],
                 K: int, np_dtype=np.float64, procs: int = 1) -> SDPData:
    """Build a full SDPData from per-block PVMs + objective data (mpmath).

    procs > 1 samples blocks in a process pool, as the reference deals
    blocks round-robin to its MPI ranks (sdp2input write_output.cxx:44-45).
    The pool's workers are spawned, never forked: a caller that has
    imported torch, or holds a CUDA context, must not fork (and a worker
    that dies raises here, where a multiprocessing.Pool would start
    another forever).  Each block is
    sampled alone at the caller's precision, so the result is the same
    whatever `procs` is."""
    if procs > 1 and len(pvms) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        prec = mpmath.mp.prec
        jobs = [(i, m, K, np.dtype(np_dtype).name, prec)
                for i, m in enumerate(pvms)]
        with ProcessPoolExecutor(min(procs, len(pvms)),
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            blocks = list(pool.map(_dcg_worker, jobs))
    else:
        blocks = [dual_constraint_group(i, m, K, np_dtype)
                  for i, m in enumerate(pvms)]
    return SDPData(
        objective_const=_to_limbs([objective_const], K, np_dtype, (1,))[:, 0],
        b=_to_limbs(list(dual_objective_b), K, np_dtype, (len(dual_objective_b),)),
        blocks=blocks,
    )
