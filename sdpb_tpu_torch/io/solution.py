"""Solution output: out.txt, y.txt, x_<i>.txt and X/Y_matrix_<i>.txt in the
format of sdpb_tpu/io/solution.py (and of the reference's save_solution).

Values are written from classic float64 limbs (mpfloat.host_f64_limbs:
classic limbs re-distilled to K + 1, scaled and wide parts converted
exactly to ceil(24K/53) + 1, K the total of the words' limbs) through the port's copies of limbs_to_str and
write_text_matrix, so both packages print the same digits for the same
values.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import mpmath
import numpy as np

from ..models.sdp import DeviceSDP
from ..ops import mpfloat as mp
from ..solver.state import SolverState
from .text_blocks import write_text_matrix


@dataclass(frozen=True)
class WriteSolution:
    """Parsed --writeSolution flags."""
    vector_x: bool = True
    vector_y: bool = True
    matrix_X: bool = False
    matrix_Y: bool = False

    @classmethod
    def parse(cls, spec: str) -> "WriteSolution":
        names = {"x": "vector_x", "y": "vector_y", "X": "matrix_X", "Y": "matrix_Y"}
        flags = dict.fromkeys(names.values(), False)
        for token in spec.split(","):
            token = token.strip()
            if not token:
                continue
            if token not in names:
                raise ValueError(f"Invalid argument to --writeSolution: '{token}'")
            flags[names[token]] = True
        return cls(**flags)


def psd_real_indices(dim: int, h_pad: int, h_real: int) -> np.ndarray:
    """Row indices of the real PSD dims inside a dim*h_pad padded matrix."""
    if dim <= 0 or h_real <= 0:
        return np.zeros(0, dtype=int)
    return np.concatenate([np.arange(d * h_pad, d * h_pad + h_real)
                           for d in range(dim)])


def host_blocks(sdp: DeviceSDP, state: SolverState) -> Dict[int, dict]:
    """Un-bucket the state into per-block host limb arrays without the
    shape padding: {block_index: {x: [K,P], X_even: [K,pe,pe], X_odd,
    Y_even, Y_odd}}."""
    out: Dict[int, dict] = {}
    for bk, bs in zip(sdp.buckets, state.buckets):
        sh = bk.shape
        x = mp.host_f64_limbs(bs.x)
        mats = {name: mp.host_f64_limbs(getattr(bs, name))
                for name in ("X_even", "X_odd", "Y_even", "Y_odd")}
        K = x.shape[0]
        for i, rs in enumerate(bk.real_sizes):
            if rs.block_index < 0:
                continue
            xi = x[:, i].reshape(K, sh.n_pairs, sh.num_points)[:, :, :rs.num_points]
            entry = {"x": xi.reshape(K, -1)}
            for name, m in mats.items():
                even = name.endswith("even")
                h_pad = sh.h_even if even else sh.h_odd
                h_real = rs.h_even if even else rs.h_odd
                m = m[:, i]
                if h_real != h_pad:
                    ridx = psd_real_indices(sh.dim, h_pad, h_real)
                    m = m[:, ridx[:, None], ridx[None, :]]
                entry[name] = m
            out[rs.block_index] = entry
    return out


def mp_str(v, ndigits: int) -> str:
    """Decimal string of an mpmath value or float (out.txt style)."""
    if isinstance(v, float):
        v = mpmath.mpf(v)
    return mpmath.nstr(v, ndigits, strip_zeros=False, min_fixed=1, max_fixed=0)


def save_solution(out_dir, result, sdp: DeviceSDP,
                  write_solution: WriteSolution = WriteSolution(),
                  verbosity: int = 1) -> None:
    """Write out.txt (+ y.txt, x_<i>.txt, X/Y_matrix_<i>.txt per flags)."""
    out_dir = Path(out_dir)
    if verbosity >= 1:
        print(f"Saving solution to      : {out_dir}")
    out_dir.mkdir(parents=True, exist_ok=True)
    state = result.state
    ndigits = int((24 if state.y.scaled else 53) * state.y.K * 0.30103) + 1
    (out_dir / "out.txt").write_text(
        f'terminateReason = "{result.terminate_reason}";\n'
        f"primalObjective = {mp_str(result.primal_objective, ndigits)};\n"
        f"dualObjective   = {mp_str(result.dual_objective, ndigits)};\n"
        f"dualityGap      = {mp_str(result.duality_gap, ndigits)};\n"
        f"primalError     = {mp_str(result.primal_error, ndigits)};\n"
        f"dualError       = {mp_str(result.dual_error, ndigits)};\n"
        f"Solver runtime  = {int(result.runtime)};\n")

    if write_solution.vector_y:
        write_text_matrix(out_dir / "y.txt", mp.host_f64_limbs(state.y)[:, :, None])
    if write_solution.vector_x or write_solution.matrix_X or write_solution.matrix_Y:
        for idx, data in sorted(host_blocks(sdp, state).items()):
            if write_solution.vector_x:
                write_text_matrix(out_dir / f"x_{idx}.txt", data["x"][:, :, None])
            for parity, name in ((0, "even"), (1, "odd")):
                suffix = f"{2 * idx + parity}.txt"
                if write_solution.matrix_X and data[f"X_{name}"].shape[-1] > 0:
                    write_text_matrix(out_dir / f"X_matrix_{suffix}", data[f"X_{name}"])
                if write_solution.matrix_Y and data[f"Y_{name}"].shape[-1] > 0:
                    write_text_matrix(out_dir / f"Y_matrix_{suffix}", data[f"Y_{name}"])
