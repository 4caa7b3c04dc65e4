"""One interior-point iteration: residues, Schur complement, predictor and
corrector, step lengths and the update (port of
sdpb_tpu/solver/step.py::make_iteration, one device).

The statistics describe the INPUT state (objectives and residues are
computed before stepping), so on termination the caller keeps the input
state as the solution.  The JAX package runs the predictor and corrector
as a 2-step lax.scan; here they are a loop of two passes with the same
form: in the predictor pass the -dX dY correction is multiplied by 0.0.
Classic and scaled states run the same code.  The scaled one keeps its
error norms and corrector beta in float32, as the JAX package does on the
TPU, but its step lengths in float64 (linalg.min_eigenvalue_estimate), so
that it takes the classic run's steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple

import numpy as np
import torch

from ..models.sdp import Bucket, DeviceSDP
from ..ops import linalg, mpfloat as mp
from ..ops.mpfloat import MP
from .state import BucketState, SolverState


def _pairs(dim):
    """(s, r) with r <= s in offset order s(s+1)/2 + r (SDP.hxx:52-58)."""
    return [(s, r) for s in range(dim) for r in range(s + 1)]


def _row_mask_mp(x: MP, row_mask: torch.Tensor) -> MP:
    """Mask constraint rows: x [B, P, ...] by row_mask [B, P]."""
    return mp.mask_value(x, row_mask.reshape(row_mask.shape + (1,) * (x.ndim - 2)))


def _psd_outer_masks(bucket: Bucket):
    """Per-parity elementwise PSD masks [B, n, n] (1 where both dims real)."""
    out = []
    for h, m in ((bucket.shape.h_even, bucket.psd_mask_even),
                 (bucket.shape.h_odd, bucket.psd_mask_odd)):
        if h > 0:
            out.append(m[:, :, None] * m[:, None, :])
    return out


def _scalar_mp(x: float, K: int, device, scaled: bool) -> MP:
    return mp.from_double(np.float64(x), K, device, scaled=scaled)


def _host_mp(parts, device) -> MP:
    """Device MP from host parts: float64 limbs [K] (classic) or a
    (float32 limbs [K], int32 exp) pair (scaled)."""
    if isinstance(parts, tuple):
        return mp.from_parts(*parts, device)
    return MP(torch.as_tensor(np.asarray(parts, dtype=np.float64), device=device))


def _bases(bucket: Bucket):
    """Per-parity (basis [B,h,np], embedded basis [B,m*h,m*np]) with h > 0."""
    out = []
    if bucket.shape.h_even > 0:
        out.append((bucket.bases_even, bucket.emb_even))
    if bucket.shape.h_odd > 0:
        out.append((bucket.bases_odd, bucket.emb_odd))
    return out


def _psd_pair(bs: BucketState, attr_even: str, attr_odd: str, shape):
    out = []
    if shape.h_even > 0:
        out.append(getattr(bs, attr_even))
    if shape.h_odd > 0:
        out.append(getattr(bs, attr_odd))
    return out


class IterationStats(NamedTuple):
    primal_objective: MP           # scalar MP
    dual_objective: MP
    duality_gap: MP
    primal_error_P: torch.Tensor   # scalar in the limb dtype
    primal_error_p: torch.Tensor
    dual_error: torch.Tensor
    mu: MP                         # scalar MP
    primal_step: torch.Tensor      # float64 scalar
    dual_step: torch.Tensor
    beta_corrector: torch.Tensor   # scalar in the limb dtype
    is_pd_feasible: torch.Tensor   # bool
    max_complementarity_exceeded: torch.Tensor  # bool
    # relative Schur solve residual max ||S u - rhs|| / ||rhs|| (full
    # precision, worst of predictor and corrector)
    kkt_residual: torch.Tensor     # scalar in the limb dtype


def _compute_pairings(bucket: Bucket, X_solvers, Ys: List[MP], n_refine: int):
    """A_X_inv = V^T X V with V = X^{-1} emb (exactly PSD Gram form) and
    A_Y = emb^T Y emb, reshaped to pairing tensors T[B, m, np, m, np]."""
    sh = bucket.shape
    TXs, TYs = [], []
    for (_, emb), xsol, Y in zip(_bases(bucket), X_solvers, Ys):
        V = xsol.solve(emb, n_refine)
        A_X = linalg.symmetrize(linalg.matmul(V.mT, linalg.matmul(xsol.A, V)))
        A_Y = linalg.matmul(emb.mT, linalg.matmul(Y, emb))
        m, n = sh.dim, sh.num_points
        TXs.append(A_X.reshape((A_X.shape[0], m, n, m, n)))
        TYs.append(A_Y.reshape((A_Y.shape[0], m, n, m, n)))
    return TXs, TYs


def _gather_pairs(T: MP, idx1, idx2) -> MP:
    """G[p1,k1,p2,k2] = T[idx1[p1],k1,idx2[p2],k2] (batch axis first)."""
    return mp.take(mp.take(T, idx1, axis=1), idx2, axis=3)


def _schur_complement(bucket: Bucket, TXs, TYs) -> MP:
    """S = 1/4 sum_parity (A_X_inv A_Y + 3 swaps) as gathers and Hadamard
    MP products; padded constraint rows get a unit diagonal."""
    sh = bucket.shape
    B = bucket.batch
    P = sh.schur_size
    S = None
    if sh.dim == 1:
        for TX, TY in zip(TXs, TYs):
            t = mp.mul(TX.reshape((B, sh.num_points, sh.num_points)),
                       TY.reshape((B, sh.num_points, sh.num_points)))
            S = t if S is None else mp.add(S, t)
    else:
        prs = _pairs(sh.dim)
        s_idx = [s for s, _ in prs]
        r_idx = [r for _, r in prs]
        for TX, TY in zip(TXs, TYs):
            t1 = mp.mul(_gather_pairs(TX, s_idx, r_idx), _gather_pairs(TY, r_idx, s_idx))
            t2 = mp.mul(_gather_pairs(TX, r_idx, r_idx), _gather_pairs(TY, s_idx, s_idx))
            t3 = mp.mul(_gather_pairs(TX, s_idx, s_idx), _gather_pairs(TY, r_idx, r_idx))
            t4 = mp.mul(_gather_pairs(TX, r_idx, s_idx), _gather_pairs(TY, s_idx, r_idx))
            t = mp.add(mp.add(t1, t2), mp.add(t3, t4))
            S = t if S is None else mp.add(S, t)
        S = mp.mul_pow2(S, 0.25)
        S = S.reshape((B, P, P))
    S = linalg.symmetrize(S)
    rm = bucket.row_mask
    eye = torch.eye(P, dtype=rm.dtype, device=rm.device)
    S = mp.mask_value(S, rm[:, :, None] * rm[:, None, :])
    pad_diag = (eye[None] * (1.0 - rm)[:, :, None]) > 0
    one = _scalar_mp(1.0, S.K, S.device, S.scaled)
    return mp.where(pad_diag, mp.broadcast_to(one, S.shape), S)


def _constraint_matrix_weighted_sum(bucket: Bucket, a: MP) -> List[MP]:
    """sum_p a_p A_p per parity: for each pair (s, r), basis diag(a_pair)
    basis^T, halved off the diagonal, placed block-symmetrically."""
    sh = bucket.shape
    B = bucket.batch
    a4 = a.reshape((B, sh.n_pairs, sh.num_points))
    results = []
    for basis, _ in _bases(bucket):
        h = basis.shape[-2]
        W = mp.mul(mp.expand_dims(basis, 1), mp.expand_dims(a4, 2))
        Ssub = linalg.matmul(W, mp.expand_dims(basis.mT, 1))   # [B,npairs,h,h]
        out = mp.zeros((B, sh.dim * h, sh.dim * h), a.K, a.device, scaled=a.scaled)
        for p, (s, r) in enumerate(_pairs(sh.dim)):
            blk = Ssub[:, p]
            if s != r:
                blk = mp.mul_pow2(blk, 0.5)
            mp.set_block(out, (slice(None), slice(r * h, (r + 1) * h),
                             slice(s * h, (s + 1) * h)), blk)
            if s != r:
                mp.set_block(out, (slice(None), slice(s * h, (s + 1) * h),
                                 slice(r * h, (r + 1) * h)), blk.mT)
        results.append(out)
    return results


def _trace_Ap(bucket: Bucket, Zs: List[MP]) -> MP:
    """Tr(A_p Z) for all p: diag(basis^T Z[r,s] basis), Z symmetric."""
    sh = bucket.shape
    B = bucket.batch
    total = None
    for (basis, _), Z in zip(_bases(bucket), Zs):
        h = basis.shape[-2]
        per_pair = []
        for (s, r) in _pairs(sh.dim):
            Zsub = Z[:, r * h:(r + 1) * h, s * h:(s + 1) * h]
            t = linalg.matmul(Zsub, basis)                        # [B,h,np]
            per_pair.append(mp.sum_(mp.mul(t, basis), axis=1))    # [B,np]
        contrib = mp.stack(per_pair, axis=1).reshape((B, sh.schur_size))
        total = contrib if total is None else mp.add(total, contrib)
    return total


def _step_length_lambda(solvers, dMs: List[MP], mask: torch.Tensor):
    """min over blocks of lambda_min(L^{-1} dM L^{-T}) at factor precision;
    padded batch entries contribute 0."""
    lam = None
    for sol, dM in zip(solvers, dMs):
        W = linalg.solve_lower(sol.L, mp.round_to(dM, sol.Kf))
        T = linalg.solve_lower(sol.L, W.mT)
        lmin = linalg.min_eigenvalue_estimate(T)
        lmin = torch.where(mask > 0, lmin, torch.zeros_like(lmin))
        bmin = torch.min(lmin)
        lam = bmin if lam is None else torch.minimum(lam, bmin)
    return lam


def _step_from_lambda(lam: torch.Tensor, gamma: float) -> torch.Tensor:
    """min(1, -gamma / lambda_min)."""
    return torch.where(lam > -gamma, torch.ones_like(lam), -gamma / lam)


@dataclass(frozen=True)
class StepConfig:
    total_psd_rows: int
    gamma: float                        # stepLengthReduction
    feasible_beta_limbs: object         # host parts, see _host_mp
    infeasible_beta_limbs: object
    primal_error_threshold: float
    dual_error_threshold: float
    max_complementarity: float
    # mixed-precision solves: factors at factor_limbs, full precision
    # recovered by n_refine refinement passes (linalg.PosdefSolver)
    factor_limbs: int = 2
    n_refine: int = 0
    # KKT solve-residual guard: a relative Schur residual above this value
    # is a conditioning failure (0 disables the measurement); with kkt_heal
    # the host loop bumps the factor precision, at the cap it only warns
    kkt_residual_threshold: float = 0.0
    kkt_heal: bool = True


def make_iteration(cfg: StepConfig):
    """Return iteration(sdp, state) -> (stats, new_state)."""

    def iteration(sdp: DeviceSDP, state: SolverState):
        K = sdp.b.K
        dev = sdp.device
        scaled = sdp.b.scaled
        fdt = sdp.b.dtype                  # float64 classic, float32 scaled
        beta_feas = _host_mp(cfg.feasible_beta_limbs, dev)
        beta_infeas = _host_mp(cfg.infeasible_beta_limbs, dev)
        one = _scalar_mp(1.0, K, dev, scaled)
        Kf, n_refine = cfg.factor_limbs, cfg.n_refine
        zs = list(zip(sdp.buckets, state.buckets))

        # ---- objectives
        p_obj = sdp.objective_const
        for bk, bs in zs:
            cx = mp.sum_(_row_mask_mp(mp.mul(bk.c, bs.x), bk.row_mask), axis=None)
            p_obj = mp.add(p_obj, cx)
        d_obj = mp.add(sdp.objective_const, mp.dot(sdp.b, state.y))
        gap_num = mp.abs_(mp.sub(p_obj, d_obj))
        gap_den = mp.maximum(mp.add(mp.abs_(p_obj), mp.abs_(d_obj)), one)
        duality_gap = mp.div(gap_num, gap_den)

        # ---- factors of X and Y at factor precision
        X_solvers = [[linalg.PosdefSolver(X, Kf) for X in
                      _psd_pair(bs, "X_even", "X_odd", bk.shape)] for bk, bs in zs]
        Y_solvers = [[linalg.PosdefSolver(Y, Kf) for Y in
                      _psd_pair(bs, "Y_even", "Y_odd", bk.shape)] for bk, bs in zs]

        # ---- bilinear pairings
        TXs_all, TYs_all = [], []
        for (bk, bs), xsols in zip(zs, X_solvers):
            TX, TY = _compute_pairings(
                bk, xsols, _psd_pair(bs, "Y_even", "Y_odd", bk.shape), n_refine)
            TXs_all.append(TX)
            TYs_all.append(TY)

        # ---- dual residues c - Tr(A_* Y) - B y
        dual_residues = []
        dual_error = torch.zeros((), dtype=fdt, device=dev)
        for (bk, bs), TYs in zip(zs, TYs_all):
            sh = bk.shape
            diag_sum = None
            for TY in TYs:
                per_pair = [mp.diagonal(TY[:, r, :, s, :]) for s, r in _pairs(sh.dim)]
                contrib = mp.stack(per_pair, axis=1).reshape((bk.batch, sh.schur_size))
                diag_sum = contrib if diag_sum is None else mp.add(diag_sum, contrib)
            By = linalg.matvec(bk.Bmat, state.y)
            res = mp.sub(mp.sub(bk.c, diag_sum), By)
            dual_residues.append(res)
            dual_error = torch.maximum(dual_error,
                                       mp.max_abs(_row_mask_mp(res, bk.row_mask)))

        # ---- primal residues P = sum_p A_p x_p - X
        primal_residues = []
        primal_error_P = torch.zeros((), dtype=fdt, device=dev)
        for bk, bs in zs:
            Ax = _constraint_matrix_weighted_sum(bk, bs.x)
            Xs = _psd_pair(bs, "X_even", "X_odd", bk.shape)
            Ps = [mp.mask_value(mp.sub(a, X), om)
                  for a, X, om in zip(Ax, Xs, _psd_outer_masks(bk))]
            primal_residues.append(Ps)
            for P in Ps:
                primal_error_P = torch.maximum(primal_error_P, mp.max_abs(P))

        # ---- primal residue p = b - B^T x
        Btx = mp.zeros((sdp.dual_dim,), K, dev, scaled=scaled)
        for bk, bs in zs:
            xm = _row_mask_mp(bs.x, bk.row_mask)
            t = linalg.matmul(bk.Bmat.mT, linalg.col(xm))[..., 0]     # [B,N]
            Btx = mp.add(Btx, mp.sum_(t, axis=0))
        primal_residue_p = mp.sub(sdp.b, Btx)
        primal_error_p = mp.max_abs(primal_residue_p)

        is_pd_feasible = torch.logical_and(
            primal_error_P < cfg.primal_error_threshold,
            torch.logical_and(primal_error_p < cfg.primal_error_threshold,
                              dual_error < cfg.dual_error_threshold))

        # ---- Schur complement solvers and Q = sum B^T S^{-1} B
        S_solvers, SinvBs = [], []
        Q = mp.zeros((sdp.dual_dim, sdp.dual_dim), K, dev, scaled=scaled)
        for bk, TXs, TYs in zip(sdp.buckets, TXs_all, TYs_all):
            ssol = linalg.PosdefSolver(_schur_complement(bk, TXs, TYs), Kf)
            V = ssol.solve(bk.Bmat, n_refine)
            S_solvers.append(ssol)
            SinvBs.append(V)
            Q = mp.add(Q, mp.sum_(linalg.matmul(bk.Bmat.mT, V), axis=0))
        Q_solver = linalg.PosdefSolver(linalg.symmetrize(Q), Kf)

        # ---- mu = Tr(XY) / total_psd_rows
        trXY = None
        for bk, bs in zs:
            for X, Y, om in zip(_psd_pair(bs, "X_even", "X_odd", bk.shape),
                                _psd_pair(bs, "Y_even", "Y_odd", bk.shape),
                                _psd_outer_masks(bk)):
                t = mp.sum_(linalg.frobenius(mp.mask_value(X, om), Y), axis=0)
                trXY = t if trXY is None else mp.add(trXY, t)
        total_mp = _scalar_mp(float(cfg.total_psd_rows), K, dev, scaled)
        mu = mp.div(trXY, total_mp)
        # clamp to the limb dtype's range (1e100 overflows float32)
        max_comp = min(cfg.max_complementarity, float(torch.finfo(fdt).max))
        max_comp_exceeded = mp.to_float_array(mu) > max_comp

        # ---- predictor (pass 0) and corrector (pass 1)
        beta_pred = mp.where(is_pd_feasible, mp.zeros((), K, dev, scaled=scaled),
                             beta_infeas)

        def zeros_like_psd(bs, bk):
            return [mp.zeros(X.shape, K, dev, scaled=scaled)
                    for X in _psd_pair(bs, "X_even", "X_odd", bk.shape)]

        dXs = [zeros_like_psd(bs, bk) for bk, bs in zs]
        dYs = [zeros_like_psd(bs, bk) for bk, bs in zs]
        kkt_residual = torch.zeros((), dtype=fdt, device=dev)
        for step_idx in (0, 1):
            if step_idx == 0:
                beta = beta_pred
            else:
                # corrector centering from the predictor direction
                frob = None
                for i, (bk, bs) in enumerate(zs):
                    Xs = _psd_pair(bs, "X_even", "X_odd", bk.shape)
                    Ys = _psd_pair(bs, "Y_even", "Y_odd", bk.shape)
                    for ip, (X, Y, om) in enumerate(zip(Xs, Ys, _psd_outer_masks(bk))):
                        t = linalg.frobenius(mp.mask_value(mp.add(X, dXs[i][ip]), om),
                                             mp.add(Y, dYs[i][ip]))
                        t = mp.sum_(t, axis=0)
                        frob = t if frob is None else mp.add(frob, t)
                r = mp.div(frob, mp.mul(mu, total_mp))
                beta_cand = mp.where(mp.lt(r, one), mp.mul(r, r), r)
                beta_c_feas = mp.minimum(mp.maximum(beta_feas, beta_cand), one)
                beta_c_infeas = mp.maximum(beta_infeas, beta_cand)
                beta = mp.where(is_pd_feasible, beta_c_feas, beta_c_infeas)

            # search direction
            bmu = mp.mul(beta, mu)
            dxs, Rs_all = [], []
            for i, (bk, bs) in enumerate(zs):
                Xs = _psd_pair(bs, "X_even", "X_odd", bk.shape)
                Ys = _psd_pair(bs, "Y_even", "Y_odd", bk.shape)
                Rs, Zs = [], []
                for ip, (X, Y) in enumerate(zip(Xs, Ys)):
                    # R = beta mu I - X Y - [corrector] dX dY
                    R = mp.neg(linalg.matmul(X, Y))
                    corr = linalg.matmul(dXs[i][ip], dYs[i][ip])
                    R = mp.sub(R, mp.mask_value(corr, float(step_idx)))
                    R = mp.add(R, mp.scalar_eye(bmu, R.shape[-1]))
                    # Z = Symmetrize(X^{-1} (P Y - R))
                    Z = mp.sub(linalg.matmul(primal_residues[i][ip], Y), R)
                    Z = linalg.symmetrize(X_solvers[i][ip].solve(Z, n_refine))
                    Rs.append(R)
                    Zs.append(Z)
                Rs_all.append(Rs)
                dxs.append(mp.neg(mp.add(dual_residues[i], _trace_Ap(bk, Zs))))

            # u = S^{-1} rhs; dy = Q^{-1}(p - B^T u); dx = u + (S^{-1} B) dy
            us = []
            dy_local = mp.zeros((sdp.dual_dim,), K, dev, scaled=scaled)
            for i, bk in enumerate(sdp.buckets):
                u = S_solvers[i].solve(linalg.col(dxs[i]), n_refine)
                us.append(u)
                if cfg.kkt_residual_threshold > 0:
                    r = mp.sub(linalg.col(dxs[i]), linalg.matmul(S_solvers[i].A, u))
                    rn = mp.max_abs(_row_mask_mp(r[..., 0], bk.row_mask))
                    bn = mp.max_abs(_row_mask_mp(dxs[i], bk.row_mask))
                    tiny = float(torch.finfo(fdt).tiny)
                    kkt_residual = torch.maximum(
                        kkt_residual, rn / torch.clamp(bn, min=tiny))
                t = linalg.matmul(bk.Bmat.mT, u)[..., 0]
                dy_local = mp.add(dy_local, mp.sum_(t, axis=0))
            dy = mp.sub(primal_residue_p, dy_local)
            dy = Q_solver.solve(linalg.col(dy), n_refine)[..., 0]
            for i, bk in enumerate(sdp.buckets):
                dx = mp.add(us[i], linalg.matmul(SinvBs[i], linalg.col(dy)))[..., 0]
                dxs[i] = _row_mask_mp(dx, bk.row_mask)

            # dX = P + sum_p A_p dx_p ; dY = -Sym(X^{-1}(dX Y - R))
            dXs, dYs = [], []
            for i, (bk, bs) in enumerate(zs):
                Adx = _constraint_matrix_weighted_sum(bk, dxs[i])
                Ys = _psd_pair(bs, "Y_even", "Y_odd", bk.shape)
                bdX, bdY = [], []
                for ip, om in enumerate(_psd_outer_masks(bk)):
                    dX = mp.mask_value(mp.add(Adx[ip], primal_residues[i][ip]), om)
                    dY = mp.sub(linalg.matmul(dX, Ys[ip]), Rs_all[i][ip])
                    dY = X_solvers[i][ip].solve(dY, n_refine)
                    dY = mp.mask_value(mp.neg(linalg.symmetrize(dY)), om)
                    bdX.append(dX)
                    bdY.append(dY)
                dXs.append(bdX)
                dYs.append(bdY)

        # ---- step lengths
        lam_p, lam_d = None, None
        for i, bk in enumerate(sdp.buckets):
            lp = _step_length_lambda(X_solvers[i], dXs[i], bk.mask)
            ld = _step_length_lambda(Y_solvers[i], dYs[i], bk.mask)
            lam_p = lp if lam_p is None else torch.minimum(lam_p, lp)
            lam_d = ld if lam_d is None else torch.minimum(lam_d, ld)
        primal_step = _step_from_lambda(lam_p, cfg.gamma)
        dual_step = _step_from_lambda(lam_d, cfg.gamma)
        both = torch.minimum(primal_step, dual_step)
        primal_step = torch.where(is_pd_feasible, both, primal_step)
        dual_step = torch.where(is_pd_feasible, both, dual_step)

        # ---- update
        ap = mp.from_double(primal_step, K, scaled=scaled)
        ad = mp.from_double(dual_step, K, scaled=scaled)
        new_buckets = []
        for i, (bk, bs) in enumerate(zs):
            sh = bk.shape
            X_new = [mp.add(X, mp.mul(ap, dX)) for X, dX in
                     zip(_psd_pair(bs, "X_even", "X_odd", sh), dXs[i])]
            Y_new = [mp.add(Y, mp.mul(ad, dY)) for Y, dY in
                     zip(_psd_pair(bs, "Y_even", "Y_odd", sh), dYs[i])]
            Xe, Xo, Ye, Yo = bs.X_even, bs.X_odd, bs.Y_even, bs.Y_odd
            k = 0
            if sh.h_even > 0:
                Xe, Ye = X_new[k], Y_new[k]
                k += 1
            if sh.h_odd > 0:
                Xo, Yo = X_new[k], Y_new[k]
            new_buckets.append(BucketState(x=mp.add(bs.x, mp.mul(ap, dxs[i])),
                                           X_even=Xe, X_odd=Xo, Y_even=Ye, Y_odd=Yo))
        new_state = SolverState(y=mp.add(state.y, mp.mul(ad, dy)), buckets=new_buckets)

        stats = IterationStats(
            primal_objective=p_obj, dual_objective=d_obj, duality_gap=duality_gap,
            primal_error_P=primal_error_P, primal_error_p=primal_error_p,
            dual_error=dual_error, mu=mu, primal_step=primal_step,
            dual_step=dual_step, beta_corrector=mp.to_float_array(beta),
            is_pd_feasible=is_pd_feasible,
            max_complementarity_exceeded=max_comp_exceeded,
            kkt_residual=kkt_residual)
        return stats, new_state

    return iteration
