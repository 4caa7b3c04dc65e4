"""approx_objective: the objective of a perturbed SDP family from one solved
SDP (the port of sdpb_tpu/tools/approx_objective.py; the reference's
approx_objective/).

Linear:    dObj = dconst + db.y + dc.x - x.dB.y
           (Approx_Objective.cxx:10-52)
Quadratic: adds (db.dy + dc.dx - dx.dB.y - x.dB.dy)/2 where (dx, dy) solve
           the frozen Schur system with RHS (dB.y - dc, db - dB^T x)
           (Approx_Objective.cxx:55-130, compute_dx_dy.cxx).

The frozen Schur solver (S-Cholesky, S^{-1}B, Q) is rebuilt from the saved
(X, Y) solution state with the machinery of the solver's iteration
(setup_solver.cxx analog): every product, factorization and triangular
solve goes through the kernels' wrappers (ops/kernels.py).  The functions
here are plain functions on tensors, in the JAX package's order of
operations.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..models.sdp import DeviceSDP
from ..ops import linalg, mpfloat as mp, mpwide
from ..ops.mpfloat import MP
from ..ops.mpwide import MPW
from ..solver.state import SolverState
from ..solver.step import _compute_pairings, _psd_pair, _row_mask_mp, _schur_complement


class FrozenSchur(NamedTuple):
    """The frozen Schur solver of a solved SDP: everything the quadratic
    approximation's (dx, dy) solve needs, serializable for reuse across
    invocations (the --writeSolverState state of setup_solver.cxx:40-52 /
    write_solver_state.cxx)."""
    Ss: List[MP]        # per-bucket S [B, P, P] (refinement residuals)
    S_Ls: List[MP]      # per-bucket S-Cholesky factors (factor precision)
    S_dinvs: List[MP]   # per-bucket factor diagonal reciprocals
    SinvBs: List[MP]    # per-bucket S^{-1} B [B, P, N]
    Q: MP               # [N, N]
    Q_L: MP
    Q_dinv: MP


def _dinv(L: MP) -> MP:
    """The reciprocals of a factor's diagonal, as the JAX package keeps them
    beside the factor (sdpb_tpu/ops/linalg.py:276).  The port's triangular
    solves make their own, so they are only written to a solver state."""
    return mp.reciprocal(mp.diagonal(L))


def setup_frozen_schur(sdp: DeviceSDP, state: SolverState, factor_limbs: int,
                       n_refine: int) -> FrozenSchur:
    """(sdp, state) -> FrozenSchur: the expensive part of the quadratic
    approximation, computed once and reusable across many --newSdp
    invocations (make_setup_fn of the JAX package)."""
    K = sdp.b.K
    dev = sdp.device
    X_solvers = [[linalg.PosdefSolver(X, factor_limbs)
                  for X in _psd_pair(bs, "X_even", "X_odd", bk.shape)]
                 for bk, bs in zip(sdp.buckets, state.buckets)]
    Ss, S_Ls, S_dinvs, SinvBs = [], [], [], []
    Q = mp.zeros((sdp.dual_dim, sdp.dual_dim), K, dev, scaled=sdp.b.scaled)
    for bk, bs, xsols in zip(sdp.buckets, state.buckets, X_solvers):
        Ys = _psd_pair(bs, "Y_even", "Y_odd", bk.shape)
        TXs, TYs = _compute_pairings(bk, xsols, Ys, n_refine)
        S = _schur_complement(bk, TXs, TYs)
        ssol = linalg.PosdefSolver(S, factor_limbs)
        V = ssol.solve(bk.Bmat, n_refine)
        Ss.append(S)
        S_Ls.append(ssol.L)
        S_dinvs.append(_dinv(ssol.L))
        SinvBs.append(V)
        Q = mp.add(Q, mp.sum_(linalg.matmul(bk.Bmat.mT, V), axis=0))
    Q = linalg.symmetrize(Q)
    qsol = linalg.PosdefSolver(Q, factor_limbs)
    return FrozenSchur(Ss=Ss, S_Ls=S_Ls, S_dinvs=S_dinvs, SinvBs=SinvBs,
                       Q=Q, Q_L=qsol.L, Q_dinv=_dinv(qsol.L))


# The scaled product keeps about 188 bits however many float32 limbs its
# word holds: it drops a limb ~190 bits below the first (ROADMAP section C).
SCALED_WORD_BITS = 188


def working_bits(sdp: DeviceSDP) -> int:
    """The bits the MP values of `sdp` carry: 53 a float64 limb (classic);
    24 a float32 limb (scaled and wide), at most SCALED_WORD_BITS on one
    scaled word."""
    K = sdp.b.K
    if not sdp.b.scaled:
        return 53 * K
    return 24 * K if K > mp.MAX_SCALED_K else min(24 * K, SCALED_WORD_BITS)


def duality_gap(sdp: DeviceSDP, state: SolverState) -> MP:
    """The state's duality gap |P - D| / max(|P| + |D|, 1), as the
    iteration computes it (solver/step.py)."""
    K, dev, scaled = sdp.b.K, sdp.device, sdp.b.scaled
    p_obj = sdp.objective_const
    for bk, bs in zip(sdp.buckets, state.buckets):
        cx = mp.sum_(_row_mask_mp(mp.mul(bk.c, bs.x), bk.row_mask), axis=None)
        p_obj = mp.add(p_obj, cx)
    d_obj = mp.add(sdp.objective_const, mp.dot(sdp.b, state.y))
    return mp.div(mp.abs_(mp.sub(p_obj, d_obj)),
                  mp.maximum(mp.add(mp.abs_(p_obj), mp.abs_(d_obj)),
                             mp.const(1.0, K, dev, scaled)))


# How many bits under 3 log2(1/gap) a representation may fall before the
# warning: the dim-2 certificate at gap 7.7e-17 keeps its quadratic term
# with 159 bits (2 under), the ising ladder at gap 7.9e-21 loses it with the
# scaled 188 (12 under)
QUADRATIC_BITS_SLACK = 8


def quadratic_precision_warning(bits: int, gap: float) -> Optional[str]:
    """A warning when `bits` fall short of what the quadratic term needs
    at duality gap `gap`, else None.  cond(S) grows as 1/gap^2 towards the
    optimum and dx = S^-1 (...) cancels terms 1/gap times its size, so the
    frozen Schur solve needs about 3 log2(1/gap) bits; short of them
    dd_objective is noise (the linear terms involve no solve and keep)."""
    need = 3 * np.log2(1 / gap) if gap > 0 else np.inf
    if bits >= need - QUADRATIC_BITS_SLACK:
        return None
    return (f"the solution's duality gap {gap:.3g} needs about {need:.0f} bits in the "
            f"frozen Schur solve and this representation carries {bits}: dd_objective "
            f"(and objective, which adds it) may be wrong in every digit; d_objective "
            f"is not affected.  Use --arithmetic classic or a higher --precision.")


def approx_objective(sdp: DeviceSDP, state: SolverState, frozen: Optional[FrozenSchur],
                     d_const: MP, d_b: MP, d_cs: List[MP], d_Bs: List[MP],
                     factor_limbs: int, n_refine: int, quadratic: bool = True):
    """-> (objective, d_objective, dd_objective) MP scalars of the new SDP
    (make_approx_fn of the JAX package).  `frozen` is setup_frozen_schur's
    result; None with quadratic=False (--linear)."""
    K = sdp.b.K
    dev = sdp.device
    scaled = sdp.b.scaled

    # objective = b.y + const
    objective = mp.add(mp.dot(sdp.b, state.y), sdp.objective_const)

    # linear terms
    d_obj = mp.add(d_const, mp.dot(d_b, state.y))
    for bk, bs, dc, dB in zip(sdp.buckets, state.buckets, d_cs, d_Bs):
        xm = _row_mask_mp(bs.x, bk.row_mask)
        d_obj = mp.add(d_obj, mp.sum_(mp.mul(dc, xm), axis=None))
        dBy = linalg.matvec(dB, state.y)            # [B, P]
        d_obj = mp.sub(d_obj, mp.sum_(mp.mul(dBy, xm), axis=None))

    dd_obj = mp.zeros((), K, dev, scaled=scaled)
    if quadratic:
        S_solvers = [linalg.PosdefSolver.from_parts(S, L, factor_limbs)
                     for S, L in zip(frozen.Ss, frozen.S_Ls)]
        Q_solver = linalg.PosdefSolver.from_parts(frozen.Q, frozen.Q_L, factor_limbs)

        # RHS: dx_rhs = dB.y - dc ; dy_rhs = db - sum dB^T x
        dx_rhss = []
        dy_rhs = d_b
        for bk, bs, dc, dB in zip(sdp.buckets, state.buckets, d_cs, d_Bs):
            rhs = mp.sub(linalg.matvec(dB, state.y), dc)
            dx_rhss.append(_row_mask_mp(rhs, bk.row_mask))
            xm = _row_mask_mp(bs.x, bk.row_mask)
            t = linalg.matmul(dB.mT, linalg.col(xm))[..., 0]
            dy_rhs = mp.sub(dy_rhs, mp.sum_(t, axis=0))

        # solve {{S,-B},{B^T,0}}
        us = []
        t_sum = mp.zeros((sdp.dual_dim,), K, dev, scaled=scaled)
        for i, bk in enumerate(sdp.buckets):
            u = S_solvers[i].solve(linalg.col(dx_rhss[i]), n_refine)
            us.append(u)
            t_sum = mp.add(t_sum, mp.sum_(
                linalg.matmul(bk.Bmat.mT, u)[..., 0], axis=0))
        dy = Q_solver.solve(linalg.col(mp.sub(dy_rhs, t_sum)), n_refine)[..., 0]
        dxs = []
        for i, bk in enumerate(sdp.buckets):
            dx = mp.add(us[i], linalg.matmul(frozen.SinvBs[i], linalg.col(dy)))[..., 0]
            dxs.append(_row_mask_mp(dx, bk.row_mask))

        # quadratic terms
        half = mp.const(0.5, K, dev, scaled)
        dd_obj = mp.mul(mp.dot(d_b, dy), half)
        for bk, bs, dc, dB, dx in zip(sdp.buckets, state.buckets, d_cs, d_Bs, dxs):
            xm = _row_mask_mp(bs.x, bk.row_mask)
            dd_obj = mp.add(dd_obj, mp.mul(mp.sum_(mp.mul(dc, dx), axis=None), half))
            dBy = linalg.matvec(dB, state.y)
            dd_obj = mp.sub(dd_obj, mp.mul(mp.sum_(mp.mul(dBy, dx), axis=None), half))
            dBdy = linalg.matvec(dB, dy)
            dd_obj = mp.sub(dd_obj, mp.mul(mp.sum_(mp.mul(dBdy, xm), axis=None), half))

    total = mp.add(mp.add(objective, d_obj), dd_obj)
    return total, d_obj, dd_obj


# ---------------------------------------------------------------------------
# The solver state file


def save_solver_state(path, frozen: FrozenSchur, factor_limbs: int) -> None:
    """A FrozenSchur as one .npz, under the JAX package's keys and in its
    order, so that either package reads the other's file (the
    --writeSolverState analog; write_solver_state.cxx writes text blocks per
    rank)."""
    arrays = {"__factor_limbs": np.asarray(factor_limbs)}

    def put(name, a):
        if isinstance(a, MPW):      # wide: one plane per word
            for g, w in enumerate(a.words):
                arrays[f"{name}.w{g}"] = w.limbs.cpu().numpy()
                arrays[f"{name}.w{g}.exp"] = w.exp.cpu().numpy()
            return
        arrays[name] = a.limbs.cpu().numpy()
        if a.scaled:
            arrays[name + ".exp"] = a.exp.cpu().numpy()

    for i in range(len(frozen.Ss)):
        put(f"S_{i}", frozen.Ss[i])
        put(f"S_L_{i}", frozen.S_Ls[i])
        put(f"S_dinv_{i}", frozen.S_dinvs[i])
        put(f"SinvB_{i}", frozen.SinvBs[i])
    put("Q", frozen.Q)
    put("Q_L", frozen.Q_L)
    put("Q_dinv", frozen.Q_dinv)
    np.savez(path, **arrays)


def load_solver_state(path, device) -> Optional[tuple]:
    """(FrozenSchur, factor_limbs) from save_solver_state's npz (or the JAX
    package's) on `device`, or None when there is no file."""
    if not os.path.exists(path):
        return None
    data = np.load(path)

    def tensor(name):
        return torch.as_tensor(data[name], device=device)

    def get(name):
        if f"{name}.w0" in data.files:
            words = []
            g = 0
            while f"{name}.w{g}" in data.files:
                words.append(MP(tensor(f"{name}.w{g}"), tensor(f"{name}.w{g}.exp")))
                g += 1
            return MPW(words)
        e = name + ".exp"
        return MP(tensor(name), tensor(e) if e in data.files else None)

    nb = sum(1 for k in data.files if k.startswith("S_L_"))
    frozen = FrozenSchur(
        Ss=[get(f"S_{i}") for i in range(nb)],
        S_Ls=[get(f"S_L_{i}") for i in range(nb)],
        S_dinvs=[get(f"S_dinv_{i}") for i in range(nb)],
        SinvBs=[get(f"SinvB_{i}") for i in range(nb)],
        Q=get("Q"), Q_L=get("Q_L"), Q_dinv=get("Q_dinv"))
    return frozen, int(data["__factor_limbs"])


def load_reference_solver_state(solution_dir, sdp: DeviceSDP, factor_limbs: int,
                                n_refine: int) -> Optional[FrozenSchur]:
    """FrozenSchur from the reference's --writeSolverState text blocks
    (schur_complement_cholesky_<j>.txt + Q_cholesky.txt; setup_solver.cxx:
    40-52 / write_solver_state.cxx).  S and Q are reconstructed as L L^T
    from the full-precision factors; S^{-1}B comes from a refined solve
    against the reconstructed S (the schur_off_diagonal_* files carry only
    L^{-1}B, which the mixed-precision scheme re-derives anyway).  Returns
    None when the directory has no Q_cholesky.txt."""
    from ..io.text_blocks import read_text_matrix

    solution_dir = Path(solution_dir)
    if not (solution_dir / "Q_cholesky.txt").exists():
        return None
    K = sdp.b.K
    scaled = sdp.b.scaled
    dev = sdp.device
    K64 = -(-((24 if scaled else 53) * K) // 53) + 1

    def lower_of(arr64):
        """Text factors may be stored upper (the reference factors Q in the
        upper triangle): transpose to lower by content."""
        strict_upper = np.triu(np.abs(arr64).sum(axis=0), 1).sum()
        strict_lower = np.tril(np.abs(arr64).sum(axis=0), -1).sum()
        return arr64 if strict_lower >= strict_upper else np.swapaxes(arr64, -1, -2)

    Ss, S_Ls, S_dinvs, SinvBs = [], [], [], []
    for bk in sdp.buckets:
        sh = bk.shape
        P = sh.schur_size
        out = np.zeros((K64, bk.batch, P, P), np.float64)
        for i, rs in enumerate(bk.real_sizes):
            P_real = sh.n_pairs * rs.num_points
            arr = lower_of(read_text_matrix(
                solution_dir / f"schur_complement_cholesky_{rs.block_index}.txt",
                K64, np.float64, expect_shape=(P_real, P_real)))
            if P_real == P:
                out[:, i] = arr
            else:
                # padded constraint rows carry identity (the
                # _schur_complement padding convention)
                o4 = out[:, i].reshape(K64, sh.n_pairs, sh.num_points,
                                       sh.n_pairs, sh.num_points)
                a4 = arr.reshape(K64, sh.n_pairs, rs.num_points,
                                 sh.n_pairs, rs.num_points)
                o4[:, :, :rs.num_points, :, :rs.num_points] = a4
                pad = np.arange(P).reshape(sh.n_pairs, sh.num_points)[
                    :, rs.num_points:].ravel()
                out[0, i, pad, pad] = 1.0
        L = stage_host_mp(out, K if scaled else 0, dev, K)
        S = linalg.matmul(L, L.mT)
        ssol = linalg.PosdefSolver(S, factor_limbs)
        Ss.append(S)
        S_Ls.append(ssol.L)
        S_dinvs.append(_dinv(ssol.L))
        SinvBs.append(ssol.solve(bk.Bmat, n_refine))
    N = sdp.dual_dim
    q64 = lower_of(read_text_matrix(solution_dir / "Q_cholesky.txt", K64, np.float64,
                                    expect_shape=(N, N)))
    QL = stage_host_mp(q64, K if scaled else 0, dev, K)
    Q = linalg.matmul(QL, QL.mT)
    qsol = linalg.PosdefSolver(Q, factor_limbs)
    return FrozenSchur(Ss=Ss, S_Ls=S_Ls, S_dinvs=S_dinvs, SinvBs=SinvBs,
                       Q=Q, Q_L=qsol.L, Q_dinv=_dinv(qsol.L))


# ---------------------------------------------------------------------------
# The perturbation


def stage_host_mp(arr: np.ndarray, scaled_limbs: int, device, K: int = 0):
    """Host float64 limb stack [K64, ...] -> MP on `device`: classic limbs
    (the first K limbs re-distilled when K is given) when scaled_limbs == 0,
    else the scaled representation of scaled_limbs float32 limbs, wide
    beyond 9 (models/sdp.py's staging)."""
    arr = np.asarray(arr, np.float64)
    if scaled_limbs > mp.MAX_SCALED_K:
        return mpwide.wide_parts_to_mp(mpwide.f64_limbs_to_wide_parts(arr, scaled_limbs),
                                       device)
    if scaled_limbs:
        return mp.from_parts(*mp.f64_limbs_to_scaled_parts(arr, scaled_limbs), device)
    if K:
        arr = mp.f64_limbs_to_classic(arr, K)
    return MP(torch.as_tensor(np.ascontiguousarray(arr), dtype=torch.float64, device=device))


def sdp_delta_buckets(sdp_dev: DeviceSDP, host_old, host_new, scaled_limbs: int = 0):
    """d_c/d_B bucketed like sdp_dev (the Axpy(-1, old, new) analog,
    approx_objective/Axpy.cxx).  The two problems must have the same block
    structure; a block whose B differs in shape raises."""
    old_by_index = {b.index: b for b in host_old.blocks}
    new_by_index = {b.index: b for b in host_new.blocks}
    if old_by_index.keys() != new_by_index.keys():
        raise ValueError(f"sdp and newSdp have different blocks "
                         f"({len(old_by_index)} vs {len(new_by_index)})")
    K = host_old.b.shape[0]
    N = sdp_dev.dual_dim
    d_cs, d_Bs = [], []
    for bk in sdp_dev.buckets:
        sh = bk.shape
        dc = np.zeros((K, bk.batch, sh.schur_size))
        dB = np.zeros((K, bk.batch, sh.schur_size, N))
        for i, rs in enumerate(bk.real_sizes):
            ob = old_by_index[rs.block_index]
            nb = new_by_index[rs.block_index]
            if ob.B.shape != nb.B.shape:
                raise ValueError(
                    f"block {rs.block_index}: shapes differ between sdp "
                    f"and newSdp ({ob.B.shape} vs {nb.B.shape})")
            n_pairs = sh.n_pairs
            dc[:, i].reshape(K, n_pairs, sh.num_points)[:, :, :rs.num_points] = \
                (nb.c - ob.c).reshape(K, n_pairs, rs.num_points)
            dB[:, i].reshape(K, n_pairs, sh.num_points, N)[:, :, :rs.num_points] = \
                (nb.B - ob.B).reshape(K, n_pairs, rs.num_points, N)
        d_cs.append(stage_host_mp(dc, scaled_limbs, sdp_dev.device))
        d_Bs.append(stage_host_mp(dB, scaled_limbs, sdp_dev.device))
    return d_cs, d_Bs
