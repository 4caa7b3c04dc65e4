"""One interior-point iteration: residues, Schur complement, predictor and
corrector, step lengths and the update (port of
sdpb_tpu/solver/step.py::make_iteration).

The statistics describe the INPUT state (objectives and residues are
computed before stepping), so on termination the caller keeps the input
state as the solution.  The JAX package runs the predictor and corrector
as a 2-step lax.scan; here they are a loop of two passes with the same
form: in the predictor pass the -dX dY correction is multiplied by 0.0.
Classic, scaled and wide states run the same code.  The scaled one keeps its
error norms and corrector beta in float32, as the JAX package does on the
TPU, but its step lengths in float64 (linalg.eigvalsh_input), so that it
takes the classic run's steps.

The iteration is cut in two at the eigvalsh of the step lengths, the one
call that checks its result on the host: `Iteration.front` runs through
the step lengths' triangular solves, `Iteration.back` from their
eigenvalues through the update.  The chunked run loop (port of
make_chunked_iteration below) captures each half as a CUDA graph
(solver/graphs.py) and decides termination on the device.

In a run of several processes (parallel/distributed.py) each rank iterates
on its shard of the buckets (parallel/mesh.py), and the reductions over
the blocks are collectives at the JAX package's psum/pmax/pmin sites
(its step.py:395-641): the objectives, Tr(XY), B^T x, Q, the corrector's
Frobenius product and dy's B^T u summed (_psum_mp: gathered and added in
MP), the error norms and the KKT residual maximized, the step lengths'
least eigenvalues minimized (_pmax, _pmin: gathered, then torch.amax or
torch.amin, so that a NaN on one rank reaches all).  Every rank then holds the
same statistics, y, dy and steps, so that every decision made from them
is the same on all ranks.  Without a group each helper is the identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple

import numpy as np
import torch

from ..models.sdp import Bucket, DeviceSDP
from ..ops import linalg, mpfloat as mp, mpwide
from ..ops.mpfloat import MP
from ..ops.mpwide import MPW
from .state import BucketState, SolverState


def _psum_mp(x, group):
    """The sum of an MP value over the ranks, to the representation's
    precision: every rank's value gathered (limbs and exponents, word by
    word) and added with the MP sum in rank order, so that every rank
    holds the same bits, and at world size 1 the value itself.  (The JAX
    package sums the float limbs across devices, step.py:41-62, rounding
    once per limb: its sum keeps ~53 bits classic and ~24 scaled; ROADMAP,
    reference defects.)"""
    if group is None:
        return x
    ranks = _per_rank(x, group)
    total = ranks[0]
    for v in ranks[1:]:
        total = mp.add(total, v)
    return total


def _per_rank(x, group) -> list:
    """Every rank's copy of an MP or MPW value, in rank order."""
    if isinstance(x, MPW):
        return [MPW(ws) for ws in zip(*(_per_rank(w, group) for w in x.words))]
    limbs = group.all_gather(x.limbs)
    exp = None if x.exp is None else group.all_gather(x.exp)
    return [MP(limbs[r], None if exp is None else exp[r]) for r in range(group.world_size)]


def _pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The largest of the ranks' x, from every rank's copy gathered: a NaN
    on any rank is passed on, as torch.maximum passes it on in one
    process (a MAX all-reduce compares, and may drop it)."""
    return x if group is None else torch.amax(group.all_gather(x), 0)


def _pmin(x: torch.Tensor, group) -> torch.Tensor:
    """The least of the ranks' x, as _pmax."""
    return x if group is None else torch.amin(group.all_gather(x), 0)


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


def _host_mp(parts, device) -> MP:
    """Device MP from host parts: float64 limbs [K] (classic), a (float32
    limbs [K], int32 exp) pair (scaled) or a list of such pairs, one per
    word (wide)."""
    if isinstance(parts, list):
        return mpwide.wide_parts_to_mp(parts, device)
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
    one = mp.const(1.0, S.K, S.device, S.scaled)
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


def _step_length_inputs(solvers, dMs: List[MP]) -> List[linalg.EigInput]:
    """Per parity, the float64 matrix L^{-1} dM L^{-T} (at factor
    precision) whose least eigenvalue bounds the step: every triangular
    solve of the step length, no eigvalsh."""
    out = []
    for sol, dM in zip(solvers, dMs):
        W = linalg.solve_lower(sol.L, mp.round_to(dM, sol.Kf))
        T = linalg.solve_lower(sol.L, W.mT)
        out.append(linalg.eigvalsh_input(T))
    return out


def eigvalsh_all(inputs: List[linalg.EigInput]) -> List[torch.Tensor]:
    """The eigenvalues of every step-length matrix (eager: eigvalsh checks
    its result on the host)."""
    return [torch.linalg.eigvalsh(x.sym) for x in inputs]


def _lambda_from(inputs: List[linalg.EigInput], eigvals, mask: torch.Tensor):
    """min over blocks of lambda_min; padded batch entries contribute 0."""
    lam = None
    for inp, w in zip(inputs, eigvals):
        lmin = linalg.min_eigenvalue_from(inp, w)
        lmin = torch.where(mask > 0, lmin, torch.zeros_like(lmin))
        bmin = torch.min(lmin)
        lam = bmin if lam is None else torch.minimum(lam, bmin)
    return lam


def _step_length_lambda(solvers, dMs: List[MP], mask: torch.Tensor):
    """min over blocks of lambda_min(L^{-1} dM L^{-T}) at factor precision;
    padded batch entries contribute 0."""
    inputs = _step_length_inputs(solvers, dMs)
    return _lambda_from(inputs, eigvalsh_all(inputs), mask)


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
    # device-side termination (make_chunked_iteration): the duality-gap
    # threshold as host parts (see _host_mp) and the flags and step floors
    # of compute_feasible_and_termination.cxx:20-65; None: the host loop
    # decides termination
    duality_gap_threshold_limbs: object = None
    find_primal_feasible: bool = False
    find_dual_feasible: bool = False
    detect_primal_feasible_jump: bool = False
    detect_dual_feasible_jump: bool = False
    min_primal_step: float = 0.0
    min_dual_step: float = 0.0


class Front(NamedTuple):
    """What the iteration's back half reads of its front half: the
    statistics but the step lengths, the search direction and the step
    lengths' eigvalsh inputs."""
    stats: IterationStats          # primal_step and dual_step None
    dxs: List[MP]                  # per bucket
    dy: MP
    dXs: List[List[MP]]            # per bucket, per parity
    dYs: List[List[MP]]
    eig_inputs: List[linalg.EigInput]   # per bucket: X parities, then Y


class Iteration:
    """iteration(sdp, state) -> (stats, new_state), in two halves: `front`
    through the step lengths' triangular solves, `back` from their
    eigenvalues (eigvalsh_all of front.eig_inputs) through the update.
    The host-made constants of a config are staged once per device.  With
    a `group` (parallel/distributed.py::Group) sdp and state are this
    rank's shards and the reductions over blocks span the ranks."""

    def __init__(self, cfg: StepConfig, group=None):
        self.cfg = cfg
        self.group = group
        self._consts = {}

    def consts(self, sdp: DeviceSDP) -> dict:
        """The config's host parts as MPs on the problem's device."""
        dev = str(sdp.device)
        c = self._consts.get(dev)
        if c is None:
            cfg = self.cfg
            c = self._consts[dev] = dict(
                beta_feas=_host_mp(cfg.feasible_beta_limbs, sdp.device),
                beta_infeas=_host_mp(cfg.infeasible_beta_limbs, sdp.device),
                gap_threshold=None if cfg.duality_gap_threshold_limbs is None else
                _host_mp(cfg.duality_gap_threshold_limbs, sdp.device))
        return c

    def __call__(self, sdp: DeviceSDP, state: SolverState):
        front = self.front(sdp, state)
        return self.back(sdp, state, front, eigvalsh_all(front.eig_inputs))

    def front(self, sdp: DeviceSDP, state: SolverState) -> Front:
        cfg = self.cfg
        K = sdp.b.K
        dev = sdp.device
        scaled = sdp.b.scaled
        fdt = sdp.b.dtype                  # float64 classic, float32 scaled
        c = self.consts(sdp)
        beta_feas, beta_infeas = c["beta_feas"], c["beta_infeas"]
        one = mp.const(1.0, K, dev, scaled)
        Kf, n_refine = cfg.factor_limbs, cfg.n_refine
        zs = list(zip(sdp.buckets, state.buckets))
        group = self.group

        # ---- objectives (the constant counted once: on rank 0)
        p_obj = sdp.objective_const if group is None or group.is_coordinator else \
            mp.zeros((), K, dev, scaled=scaled)
        for bk, bs in zs:
            cx = mp.sum_(_row_mask_mp(mp.mul(bk.c, bs.x), bk.row_mask), axis=None)
            p_obj = mp.add(p_obj, cx)
        p_obj = _psum_mp(p_obj, group)
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
        dual_error = _pmax(dual_error, group)

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
        primal_error_P = _pmax(primal_error_P, group)

        # ---- primal residue p = b - B^T x
        Btx = mp.zeros((sdp.dual_dim,), K, dev, scaled=scaled)
        for bk, bs in zs:
            xm = _row_mask_mp(bs.x, bk.row_mask)
            t = linalg.matmul(bk.Bmat.mT, linalg.col(xm))[..., 0]     # [B,N]
            Btx = mp.add(Btx, mp.sum_(t, axis=0))
        primal_residue_p = mp.sub(sdp.b, _psum_mp(Btx, group))
        primal_error_p = _pmax(mp.max_abs(primal_residue_p), group)

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
        Q = _psum_mp(Q, group)          # the synchronize_Q reduce (cxx:23-186)
        Q_solver = linalg.PosdefSolver(linalg.symmetrize(Q), Kf)

        # ---- mu = Tr(XY) / total_psd_rows
        trXY = None
        for bk, bs in zs:
            for X, Y, om in zip(_psd_pair(bs, "X_even", "X_odd", bk.shape),
                                _psd_pair(bs, "Y_even", "Y_odd", bk.shape),
                                _psd_outer_masks(bk)):
                t = mp.sum_(linalg.frobenius(mp.mask_value(X, om), Y), axis=0)
                trXY = t if trXY is None else mp.add(trXY, t)
        total_mp = mp.const(float(cfg.total_psd_rows), K, dev, scaled)
        mu = mp.div(_psum_mp(trXY, group), total_mp)
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
                r = mp.div(_psum_mp(frob, group), mp.mul(mu, total_mp))
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
            dy = mp.sub(primal_residue_p, _psum_mp(dy_local, group))
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

        kkt_residual = _pmax(kkt_residual, group)

        # ---- the step lengths' triangular solves (their eigvalsh is the
        # back half's input)
        eig_inputs = []
        for i in range(len(sdp.buckets)):
            eig_inputs += _step_length_inputs(X_solvers[i], dXs[i])
            eig_inputs += _step_length_inputs(Y_solvers[i], dYs[i])
        stats = IterationStats(
            primal_objective=p_obj, dual_objective=d_obj, duality_gap=duality_gap,
            primal_error_P=primal_error_P, primal_error_p=primal_error_p,
            dual_error=dual_error, mu=mu, primal_step=None, dual_step=None,
            beta_corrector=mp.to_float_array(beta), is_pd_feasible=is_pd_feasible,
            max_complementarity_exceeded=max_comp_exceeded, kkt_residual=kkt_residual)
        return Front(stats=stats, dxs=dxs, dy=dy, dXs=dXs, dYs=dYs,
                     eig_inputs=eig_inputs)

    def back(self, sdp: DeviceSDP, state: SolverState, f: Front, eigvals):
        cfg = self.cfg
        K = sdp.b.K
        scaled = sdp.b.scaled
        zs = list(zip(sdp.buckets, state.buckets))
        is_pd_feasible = f.stats.is_pd_feasible
        dXs, dYs, dxs, dy = f.dXs, f.dYs, f.dxs, f.dy

        # ---- step lengths
        lam_p, lam_d = None, None
        pos = 0
        for i, bk in enumerate(sdp.buckets):
            nx, ny = len(dXs[i]), len(dYs[i])
            lp = _lambda_from(f.eig_inputs[pos:pos + nx], eigvals[pos:pos + nx], bk.mask)
            pos += nx
            ld = _lambda_from(f.eig_inputs[pos:pos + ny], eigvals[pos:pos + ny], bk.mask)
            pos += ny
            lam_p = lp if lam_p is None else torch.minimum(lam_p, lp)
            lam_d = ld if lam_d is None else torch.minimum(lam_d, ld)
        lam_p, lam_d = _pmin(lam_p, self.group), _pmin(lam_d, self.group)
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

        return f.stats._replace(primal_step=primal_step, dual_step=dual_step), new_state


def make_iteration(cfg: StepConfig, group=None) -> Iteration:
    """Return iteration(sdp, state) -> (stats, new_state); with a group,
    on this rank's shards (see Iteration)."""
    return Iteration(cfg, group)


# ---------------------------------------------------------------------------
# Statistics as one float64 row


MP_FIELDS = ("primal_objective", "dual_objective", "duality_gap", "mu")


def _words(v) -> tuple:
    return v.words if isinstance(v, MPW) else (v,)


class StatsLayout(NamedTuple):
    """How pack_stats lays out the MP fields: G words of K limbs, each
    followed by its exponent when scaled; `wide` for an MPW."""
    G: int
    K: int
    scaled: bool
    wide: bool

    @property
    def width(self) -> int:
        return len(MP_FIELDS) * self.G * (self.K + self.scaled) + \
            len(IterationStats._fields) - len(MP_FIELDS)


def stats_layout(like) -> StatsLayout:
    """The layout of the statistics of a problem whose values are like
    `like` (an MP or MPW, e.g. sdp.b)."""
    ws = _words(like)
    return StatsLayout(len(ws), ws[0].K, like.scaled, isinstance(like, MPW))


def pack_stats(stats: IterationStats) -> torch.Tensor:
    """Every field as one float64 row (float32 limbs and int32 exponents
    are exact in float64), in IterationStats order."""
    parts = []
    for name in IterationStats._fields:
        v = getattr(stats, name)
        if name in MP_FIELDS:
            for w in _words(v):
                parts.append(w.limbs.to(torch.float64))
                if w.exp is not None:
                    parts.append(w.exp.to(torch.float64).reshape(1))
        else:
            parts.append(v.to(torch.float64).reshape(1))
    return torch.cat(parts)


def state_tensors(state: SolverState) -> List[torch.Tensor]:
    """Every tensor of a state (limbs and exponents, word by word), in a
    fixed order."""
    out = []
    for v in [state.y] + [getattr(b, f) for b in state.buckets
                          for f in ("x", "X_even", "X_odd", "Y_even", "Y_odd")]:
        for w in _words(v):
            out.append(w.limbs)
            if w.exp is not None:
                out.append(w.exp)
    return out


# ---------------------------------------------------------------------------
# Device-resident chunked iteration (sdpb_tpu/solver/step.py:694-851)
#
# The chunked run loop runs up to `chunk` iterations between two host reads:
# each iteration is the IPM iteration plus the ordered termination checks of
# compute_feasible_and_termination.cxx:20-65 computed on the device.  Stop
# semantics match the host loop: whatever stops the run (termination,
# max-complementarity, or a failed iteration that needs a factor-precision
# bump), the state freezes at the INPUT state of the stopping iteration
# (the statistics describe the input state).  Iterations after a stop still
# run on the frozen state; their rows are marked not executed.

REASON_NONE = 0
REASON_PD_OPTIMAL = 1
REASON_DUAL_FEASIBLE = 2
REASON_PRIMAL_FEASIBLE = 3
REASON_DUAL_JUMP = 4
REASON_PRIMAL_JUMP = 5
REASON_MAX_ITER = 6
REASON_PRIMAL_STEP_SMALL = 8
REASON_DUAL_STEP_SMALL = 9
REASON_MAX_COMPLEMENTARITY = 10
REASON_RETRY = 11       # non-finite stats, exploding corrector beta or a
                        # tripped KKT guard: the host bumps factor_limbs and
                        # replays the chunk


class ChunkCarry(NamedTuple):
    """The carry of the chunked loop, as the float64 vector [5] it is
    stored in (the last row of the chunk's stats buffer)."""
    it: float            # 1-based index of the next iteration
    prev_p_step: float   # the previous iteration's step lengths
    prev_d_step: float
    done: float          # 0 or 1
    reason: float        # REASON_* code


CARRY_START = ChunkCarry(1.0, 0.0, 0.0, 0.0, float(REASON_NONE))


def _stats_finite(stats: IterationStats) -> torch.Tensor:
    """All of the solve-critical statistics finite and the corrector beta
    at most 1e4 (the host loop's heal trigger; scaled float32 saturates
    where classic arithmetic gives NaN, so an exploding beta is the sign
    there)."""
    ok = None
    for name in ("primal_objective", "dual_objective", "duality_gap", "mu",
                 "primal_error_P", "primal_error_p", "dual_error", "primal_step",
                 "dual_step"):
        v = getattr(stats, name)
        for t in ([w.limbs for w in _words(v)] if name in MP_FIELDS else [v]):
            f = torch.all(torch.isfinite(t))
            ok = f if ok is None else torch.logical_and(ok, f)
    return torch.logical_and(ok, stats.beta_corrector <= 1e4)


class ChunkedIteration:
    """One iteration of the chunked loop (make_chunked_iteration's scan
    body) on buffers it updates in place: `front` as Iteration.front,
    `back` as Iteration.back followed by the termination checks, the
    masked state update, the stats row and the carry.  On a CUDA device
    each half is captured as a CUDA graph (solver/graphs.py), so neither
    reads anything back to the host.  cfg.duality_gap_threshold_limbs must
    be set.  Its decisions come from the iteration's statistics, which a
    group's ranks share, so the ranks stop together."""

    def __init__(self, cfg: StepConfig, group=None):
        if cfg.duality_gap_threshold_limbs is None:
            raise ValueError("the chunked iteration needs duality_gap_threshold_limbs")
        self.cfg = cfg
        self.iteration = Iteration(cfg, group)

    def front(self, sdp: DeviceSDP, state: SolverState) -> Front:
        return self.iteration.front(sdp, state)

    def back(self, sdp: DeviceSDP, state: SolverState, front: Front, eigvals,
             rows: torch.Tensor, slot: torch.Tensor,
             max_iterations: torch.Tensor) -> None:
        """rows [chunk + 1, width + 1] float64: row slot[0] gets this
        iteration's packed stats and its executed flag (1 unless the loop
        had stopped before it), and slot advances; rows[-1, :5] is the
        ChunkCarry.  `state` takes the new state where the iteration
        advances.  max_iterations: a float64 scalar."""
        cfg = self.cfg
        stats, new_state = self.iteration.back(sdp, state, front, eigvals)
        carry = rows[-1, :5]
        it, prev_p, prev_d, done, reason = (carry[i] for i in range(5))

        primal_error = torch.maximum(stats.primal_error_P, stats.primal_error_p)
        is_pf = primal_error < cfg.primal_error_threshold
        is_df = stats.dual_error < cfg.dual_error_threshold
        is_opt = mp.lt(stats.duality_gap,
                       self.iteration.consts(sdp)["gap_threshold"])
        # the ordered checks, first match wins (folded back to front); the
        # flags that are off never match
        checks = [(torch.logical_and(torch.logical_and(is_pf, is_df), is_opt),
                   REASON_PD_OPTIMAL)]
        if cfg.find_dual_feasible:
            checks.append((is_df, REASON_DUAL_FEASIBLE))
        if cfg.find_primal_feasible:
            checks.append((is_pf, REASON_PRIMAL_FEASIBLE))
        if cfg.detect_dual_feasible_jump:
            checks.append((prev_d == 1.0, REASON_DUAL_JUMP))
        if cfg.detect_primal_feasible_jump:
            checks.append((prev_p == 1.0, REASON_PRIMAL_JUMP))
        checks += [
            (it > max_iterations, REASON_MAX_ITER),
            (torch.logical_and(it > 1, prev_p < cfg.min_primal_step),
             REASON_PRIMAL_STEP_SMALL),
            (torch.logical_and(it > 1, prev_d < cfg.min_dual_step),
             REASON_DUAL_STEP_SMALL),
            # after the ordered chain (the host loop checks it after)
            (stats.max_complementarity_exceeded, REASON_MAX_COMPLEMENTARITY),
        ]
        reason_now = torch.zeros_like(it)
        for cond, code in reversed(checks):
            reason_now = torch.where(cond, float(code), reason_now)
        # a failed iteration preempts everything, as the host loop checks
        # it first; a tripped KKT guard has the same cure below the cap
        healthy = _stats_finite(stats)
        if cfg.kkt_residual_threshold > 0 and cfg.kkt_heal:
            healthy = torch.logical_and(
                healthy, stats.kkt_residual <= cfg.kkt_residual_threshold)
        reason_now = torch.where(healthy, reason_now, float(REASON_RETRY))

        active = done == 0
        stop_now = torch.logical_and(active, reason_now != REASON_NONE)
        advance = torch.logical_and(active, reason_now == REASON_NONE)

        # the stopping iteration runs but does not advance
        for old, new in zip(state_tensors(state), state_tensors(new_state)):
            old.copy_(torch.where(advance, new, old))
        row = torch.cat([pack_stats(stats), active.to(torch.float64).reshape(1)])
        rows.index_copy_(0, slot, row[None])
        slot.add_(1)
        carry.copy_(torch.stack([
            it + advance.to(torch.float64),
            torch.where(advance, stats.primal_step, prev_p),
            torch.where(advance, stats.dual_step, prev_d),
            torch.logical_or(done != 0, stop_now).to(torch.float64),
            torch.where(stop_now, reason_now, reason)]))


def make_chunked_iteration(cfg: StepConfig, group=None) -> ChunkedIteration:
    return ChunkedIteration(cfg, group)
