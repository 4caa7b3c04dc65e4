"""outer_limits: cutting-plane optimizer over function blocks (the port of
sdpb_tpu/tools/outer_limits.py; the reference's outer_limits/compute_optimal/).

Solve a sequence of SDPs on a growing point set, adding points where the
y-weighted functional dips negative, while tightening the duality-gap
threshold by --dualityGapReduction each time no new points appear.

Per constraint (block b, point x): the PSD condition on the dim x dim
matrix of functionals becomes one SDP block with num_points = 1 and
bilinear basis [[1]] and an empty odd parity (the in-memory SDP ctor,
sdp_solve/SDP/SDP.cxx:23-157); rows are rescaled by their max element
(setup_constraints.cxx:58-90).  The y-space is optionally SVD-rotated for
conditioning (compute_y_transform.cxx) and the primal objective scaled by
1/max|c|.  The host work (constraints, transform, the mesh search for new
points) is mpmath, as in the JAX package; each round's SDP is staged with
models/sdp.py::build_device_sdp on the solver's device and solved by
solver/solve.py::run_solver, warm-started from the previous round's y'.
The JAX package pads every bucket's batch to a multiple of 8
(build_device_sdp(host, pad_to=8)); the port pads none, as its sdpb CLI.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import List, Optional

import mpmath
import numpy as np

from ..convert.pmp import max_normalization_index
from ..io.sdp_zip import BlockData, SDPData
from .functions import Function
from .mesh import Mesh
from .spectrum import fill_weights


def _eval_summed_min_eig(summed: List[List[Function]], epsilon, infinity, x):
    dim = len(summed)
    if dim == 1:
        return summed[0][0].eval(epsilon, infinity, x)
    M = mpmath.matrix(dim, dim)
    for r in range(dim):
        for c in range(r + 1):
            v = summed[r][c].eval(epsilon, infinity, x)
            M[r, c] = v
            M[c, r] = v
    E, _ = mpmath.eigsy(M)
    return min(E[i] for i in range(dim))


def _get_new_points(mesh: Mesh, block_epsilon) -> List:
    """Quadratic-fit minima that dip meaningfully below the local spread
    (get_new_points.cxx:9-24; differs from spectrum's zero finder)."""
    out: List = []

    def leaf(x_m, x_b, x_p, f_m, f_b, f_p):
        dx = x_p - x_m
        a, b = f_b, (f_p - f_m) / dx
        c = (f_p - 2 * f_b + f_m) / (dx * dx / 4)
        if c > 0:
            x_min = -b / c + x_b
            f_min = a - b * b / (2 * c)
            f_bar = (f_p + f_m) / 2
            if (x_m <= x_min <= x_p and f_min < abs(f_b - f_bar)
                    and abs(f_min) > block_epsilon):
                out.append(x_min)

    def walk(m: Mesh):
        if m.lower is not None:
            walk(m.lower)
        else:
            leaf(m.x[0], m.x[1], m.x[2], m.f[0], m.f[1], m.f[2])
        if m.upper is not None:
            walk(m.upper)
        else:
            leaf(m.x[2], m.x[3], m.x[4], m.f[2], m.f[3], m.f[4])

    walk(mesh)
    return out


def setup_constraints(max_index, function_blocks, normalization, points,
                      epsilon, infinity):
    """-> (c_list, free_var_list) per constraint, row-max rescaled
    (setup_constraints.cxx:17-90)."""
    c_list, fv_list = [], []
    N = len(normalization) - 1
    for block, fns in enumerate(function_blocks):
        dim = len(fns)
        for x in sorted(points[block]):
            c_vec = []
            fv = [[mpmath.mpf(0)] * N for _ in range(dim * (dim + 1) // 2)]
            row = 0
            for mr in range(dim):
                for mc in range(mr + 1):
                    primal = (fns[mr][mc][max_index].eval(epsilon, infinity, x)
                              / normalization[max_index])
                    c_vec.append(primal)
                    for col in range(N):
                        idx = col + (0 if col < max_index else 1)
                        fv[row][col] = (primal * normalization[idx]
                                        - fns[mr][mc][idx].eval(epsilon, infinity, x))
                    row += 1
            max_val = max(max(abs(v) for v in c_vec),
                          max(abs(v) for r in fv for v in r))
            scale = 1 / max_val
            c_list.append([v * scale for v in c_vec])
            fv_list.append([[v * scale for v in r] for r in fv])
    return c_list, fv_list


def compute_y_transform(c_list, fv_list, dual_objective_b, use_svd: bool):
    """-> (yp_to_y [N x N], b_star [N], primal_c_scale)
    (compute_y_transform.cxx)."""
    N = len(dual_objective_b)
    max_c = max((abs(v) for c in c_list for v in c), default=mpmath.mpf(0))
    primal_c_scale = mpmath.mpf(1) if max_c == 0 else 1 / max_c

    if not use_svd:
        yp_to_y = mpmath.eye(N)
        return yp_to_y, list(dual_objective_b), primal_c_scale

    rows = sum(len(c) for c in c_list)
    B = mpmath.matrix(rows, N)
    r0 = 0
    for fv in fv_list:
        for i, r in enumerate(fv):
            for j in range(N):
                B[r0 + i, j] = primal_c_scale * r[j]
        r0 += len(fv)
    U, S, V = mpmath.svd_r(B)   # B = U diag(S) V  (mpmath: V is V^T)
    # El: B = U s V^H, yp_to_y = V / s (columns scaled).  mpmath's third
    # output is V^T, so El's V = (mpmath V)^T.
    yp_to_y = mpmath.matrix(N, N)
    for i in range(N):
        for j in range(N):
            yp_to_y[i, j] = V[j, i] / S[j]
    # b_star = yp_to_y^T b, normalized to max 1
    b_star = [sum(yp_to_y[i, j] * dual_objective_b[i] for i in range(N))
              for j in range(N)]
    max_b = max(abs(v) for v in b_star)
    if max_b != 0:
        b_star = [v / max_b for v in b_star]
    return yp_to_y, b_star, primal_c_scale


def _limbs_of(vals, K: int) -> np.ndarray:
    """mpmath values -> float64 limbs [K, n] (exact peel-off)."""
    out = np.zeros((K, len(vals)))
    for i, v in enumerate(vals):
        x = v
        for k in range(K):
            hi = float(x)
            out[k, i] = hi
            x = x - mpmath.mpf(hi)
    return out


def _build_sdp_data(objective_const, b_star, c_list, fv_list, dims,
                    yp_to_y, primal_c_scale, K) -> SDPData:
    """Per-constraint SDP blocks with bilinear basis [[1]], float64 limbs
    (SDP.cxx:23-157)."""
    N = len(b_star)

    def limbs(vals, shape):
        return _limbs_of(vals, K).reshape((K,) + shape)

    blocks = []
    for idx, (c_vec, fv, dim) in enumerate(zip(c_list, fv_list, dims)):
        P = len(c_vec)
        Bt = []
        for r in fv:
            # B row in yp frame: primal_c_scale * (row . yp_to_y)
            Bt.extend(primal_c_scale
                      * sum(r[i] * yp_to_y[i, j] for i in range(N))
                      for j in range(N))
        blocks.append(BlockData(
            index=idx, dim=dim, num_points=1,
            bases_even=limbs([mpmath.mpf(1)], (1, 1)),
            bases_odd=np.zeros((K, 0, 1)),
            c=limbs([primal_c_scale * v for v in c_vec], (P,)),
            B=limbs(Bt, (P, N)),
        ))
    return SDPData(
        objective_const=limbs([objective_const], (1,))[:, 0],
        b=limbs(b_star, (N,)), blocks=blocks)


def save_outer_checkpoint(directory, generation, threshold, c_scale, yp,
                          points, infinity, yp_to_y, b_star, verbosity=1) -> int:
    """checkpoint_<gen>.json.gz of the outer state (save_checkpoint.cxx:
    18-130): generation/threshold/c_scale/yp/points (with 'inf' sentinel)/
    y_transform/b.  Keeps current + one backup generation."""
    import gzip

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    gens = sorted(int(p.name[len("checkpoint_"):-len(".json.gz")])
                  for p in directory.glob("checkpoint_*.json.gz"))
    new_gen = (gens[-1] + 1) if gens else generation
    N = len(yp)

    def s(v):
        return mpmath.nstr(v, int(mpmath.mp.prec * 0.30103) + 1,
                           strip_zeros=False, min_fixed=1, max_fixed=0)

    doc = {
        "generation": str(new_gen),
        "threshold": s(threshold),
        "c_scale": s(c_scale),
        "yp": [s(v) for v in yp],
        "points": [[("inf" if p == infinity else s(p)) for p in sorted(blk)]
                   for blk in points],
        "y_transform": [[s(yp_to_y[i, j]) for j in range(N)] for i in range(N)],
        "b": [s(v) for v in b_star],
    }
    path = directory / f"checkpoint_{new_gen}.json.gz"
    if verbosity >= 1:
        print(f"Saving checkpoint to    : {directory}")
    with gzip.open(path, "wt", compresslevel=0) as f:
        json.dump(doc, f, indent=1)
    # keep current + backup only
    for g in gens[:-1]:
        (directory / f"checkpoint_{g}.json.gz").unlink(missing_ok=True)
    return new_gen


def load_outer_checkpoint(directory, infinity, verbosity=1):
    """Newest checkpoint_<gen>.json.gz -> dict or None
    (load_checkpoint.cxx)."""
    import gzip

    directory = Path(directory)
    if not directory.is_dir():
        return None
    gens = sorted(int(p.name[len("checkpoint_"):-len(".json.gz")])
                  for p in directory.glob("checkpoint_*.json.gz"))
    if not gens:
        return None
    path = directory / f"checkpoint_{gens[-1]}.json.gz"
    if verbosity >= 1:
        print(f"Loading checkpoint from : {path}")
    with gzip.open(path, "rt") as f:
        doc = json.load(f)
    N = len(doc["yp"])
    yp_to_y = mpmath.matrix(N, N)
    for i in range(N):
        for j in range(N):
            yp_to_y[i, j] = mpmath.mpf(doc["y_transform"][i][j])
    return {
        "generation": int(doc["generation"]),
        "threshold": mpmath.mpf(doc["threshold"]),
        "c_scale": mpmath.mpf(doc["c_scale"]),
        "yp": [mpmath.mpf(v) for v in doc["yp"]],
        "points": [set(infinity if v == "inf" else mpmath.mpf(v)
                       for v in blk) for blk in doc["points"]],
        "yp_to_y": yp_to_y,
        "b_star": [mpmath.mpf(v) for v in doc["b"]],
    }


def compute_optimal(function_blocks, initial_points, objectives,
                    normalization, solver_params, duality_gap_reduction,
                    mesh_threshold, use_svd: bool = True, verbosity: int = 1,
                    checkpoint_dir=None, device="cuda", rounds: Optional[list] = None):
    """-> (weights, y) optimal functional weights
    (compute_optimal.cxx:58-345), each round's SDP solved on `device` in
    classic float64 limbs.  `rounds`, when given, receives one dict per
    solve: constraints, threshold, iterations, the host seconds before it
    (constraints, the SDP's host data and its staging, and the previous
    solve's search for new points), its solve seconds and its CUDA-graph
    capture seconds (warm-up, capture and instantiate)."""
    import torch

    from ..cli.sdpb import limbs_for_precision
    from ..models.sdp import build_device_sdp
    from ..ops.mpfloat import MP
    from ..solver.solve import TerminateReason, run_solver
    from ..solver.state import initial_state
    from ..utils.strings import str_to_limbs

    device = torch.device(device)
    num_blocks = len(function_blocks)
    infinity = mpmath.mpf(np.finfo(np.float64).max)
    epsilon = mpmath.mpf(2) ** (1 - mpmath.mp.prec)
    max_index = max_normalization_index(normalization)
    objective_const = objectives[max_index] / normalization[max_index]
    dual_objective_b = [objectives[i] - normalization[i] * objective_const
                        for i in range(len(normalization)) if i != max_index]
    N = len(dual_objective_b)

    K = limbs_for_precision(solver_params.precision)

    points = [set([epsilon, infinity]) | set(initial_points[b])
              for b in range(num_blocks)]
    new_points = [[] for _ in range(num_blocks)]

    target_gap = mpmath.mpf(solver_params.duality_gap_threshold)
    current_gap = mpmath.mpf("1.1")
    yp_saved = [mpmath.mpf(0)] * N

    ck = (load_outer_checkpoint(checkpoint_dir, infinity, verbosity)
          if checkpoint_dir else None)
    if ck is not None:
        yp_to_y = ck["yp_to_y"]
        b_star = ck["b_star"]
        primal_c_scale = ck["c_scale"]
        yp_saved = ck["yp"]
        points = ck["points"]
        current_gap = ck["threshold"]
    else:
        # y transform from the initial point set
        c_list, fv_list = setup_constraints(max_index, function_blocks,
                                            normalization, points, epsilon, infinity)
        yp_to_y, b_star, primal_c_scale = compute_y_transform(
            c_list, fv_list, dual_objective_b, use_svd)

    weights = None
    y = None

    if ck is not None and current_gap < target_gap:
        # the checkpoint is converged already: reconstruct and return
        y = [sum(yp_to_y[i, j] * yp_saved[j] for j in range(N)) for i in range(N)]
        return fill_weights(y, max_index, normalization), y

    while current_gap >= target_gap:
        t_host = time.time()
        for b in range(num_blocks):
            for p in new_points[b]:
                points[b].add(p)
        num_constraints = sum(len(p) for p in points)
        if verbosity >= 1:
            print(f"num_constraints: {num_constraints}  "
                  f"threshold: {mpmath.nstr(current_gap, 3)}")

        c_list, fv_list = setup_constraints(
            max_index, function_blocks, normalization, points, epsilon, infinity)
        dims = []
        for b in range(num_blocks):
            dims.extend([len(function_blocks[b])] * len(points[b]))
        host = _build_sdp_data(objective_const, b_star, c_list, fv_list,
                               dims, yp_to_y, primal_c_scale, K)
        sdp = build_device_sdp(host, device)

        omega_p = str_to_limbs(solver_params.initial_matrix_scale_primal, K)
        omega_d = str_to_limbs(solver_params.initial_matrix_scale_dual, K)
        state = initial_state(sdp, omega_p, omega_d)
        # warm-start y' from the previous round (compute_optimal.cxx:193-200)
        state = dataclasses.replace(state, y=MP(torch.as_tensor(
            _limbs_of(yp_saved, K), dtype=torch.float64, device=device)))
        host_s = time.time() - t_host

        has_new_points = False
        while not has_new_points and current_gap >= target_gap:
            params = dataclasses.replace(
                solver_params, duality_gap_threshold=mpmath.nstr(
                    current_gap, 40, min_fixed=1, max_fixed=0))
            t_solve = time.time()
            result = run_solver(sdp, params, verbosity=max(0, verbosity - 1),
                                initial=state)
            solve_s = time.time() - t_solve
            if result.terminate_reason not in (
                    TerminateReason.PrimalDualOptimal,
                    TerminateReason.PrimalFeasible,
                    TerminateReason.DualFeasible,
                    TerminateReason.PrimalFeasibleJumpDetected,
                    TerminateReason.DualFeasibleJumpDetected):
                raise RuntimeError(
                    f"Can not find solution: {result.terminate_reason}")
            state = result.state

            t_host = time.time()
            yp = _y_host(result.state)
            y = [sum(yp_to_y[i, j] * yp[j] for j in range(N)) for i in range(N)]
            weights = fill_weights(y, max_index, normalization)
            if verbosity >= 1:
                optimal = mpmath.fsum(o * w for o, w in zip(objectives, weights))
                print(f"optimal: {mpmath.nstr(optimal, 30)}")

            if rounds is not None:
                rounds.append({
                    "constraints": num_constraints,
                    "threshold": mpmath.nstr(current_gap, 3),
                    "iterations": result.iterations,
                    "reason": str(result.terminate_reason),
                    "host_s": host_s, "solve_s": solve_s,
                    "capture_s": sum(g.get("warmup_s", 0.0) + g.get("capture_s", 0.0)
                                     + g.get("instantiate_s", 0.0)
                                     for g in result.graphs.values())})

            has_new_points = False
            for b in range(num_blocks):
                new_points[b] = _find_block_new_points(
                    function_blocks[b], weights, points[b], epsilon, infinity,
                    mesh_threshold)
                if new_points[b]:
                    has_new_points = True
            if not has_new_points:
                if current_gap == target_gap:
                    current_gap = mpmath.mpf(0)  # exit
                else:
                    current_gap = max(current_gap / duality_gap_reduction,
                                      target_gap)
            host_s = time.time() - t_host
        yp_saved = _y_host(result.state)
        if checkpoint_dir:
            save_outer_checkpoint(checkpoint_dir, 0, current_gap,
                                  primal_c_scale, yp_saved, points, infinity,
                                  yp_to_y, b_star, verbosity)
    return weights, y


def _y_host(state) -> List:
    from ..utils.strings import limbs_to_mpf

    yl = state.y.limbs.cpu().numpy()
    return [limbs_to_mpf(yl[:, i]) for i in range(yl.shape[1])]


def _find_block_new_points(fns, weights, points, epsilon, infinity,
                           mesh_threshold) -> List:
    """find_new_points.cxx:14-99 for one block."""
    dim = len(fns)
    max_delta = infinity
    max_degree = 0
    block_scale = mpmath.mpf(0)
    for row in fns:
        for col in row:
            for fi, f in enumerate(col):
                max_delta = min(max_delta, f.max_delta)
                max_degree = max(max_degree, len(f.chebyshev_coeffs))
                for cf in f.chebyshev_coeffs:
                    block_scale = max(block_scale, abs(cf * weights[fi]))
    eps_mach = mpmath.mpf(2) ** (1 - mpmath.mp.prec)
    block_epsilon = block_scale * eps_mach

    summed = []
    for row in fns:
        srow = []
        for col in row:
            coeffs = [mpmath.mpf(0)] * max_degree
            eps_v = mpmath.mpf(0)
            inf_v = mpmath.mpf(0)
            for fi, f in enumerate(col):
                for ci, cf in enumerate(f.chebyshev_coeffs):
                    coeffs[ci] += weights[fi] * cf
                eps_v += weights[fi] * f.epsilon_value
                inf_v += weights[fi] * f.infinity_value
            srow.append(Function(max_delta=max_delta, epsilon_value=eps_v,
                                 infinity_value=inf_v, chebyshev_coeffs=coeffs))
        summed.append(srow)

    x0 = min(points)
    mesh = Mesh.create(
        x0, max_delta,
        lambda x: _eval_summed_min_eig(summed, epsilon, infinity, x),
        mesh_threshold, block_epsilon)
    return [p for p in _get_new_points(mesh, block_epsilon)
            if p not in points]
