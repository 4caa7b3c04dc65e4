"""Synthetic SDP problems for benchmarks and tests (the port's copy of
sdpb_tpu/models/synthetic.py; host numpy, no torch).

They have the data layout of SDPs that sdp2input converts (bilinear bases
per parity, B bands, c vectors: Dual_Constraint_Group.hxx:35-57) and need
no input file.  The solver's initial state X = Y = Omega*I is
strictly feasible-interior for any data, so a single IPM iteration is
always well-defined on these problems.
"""
from __future__ import annotations

import numpy as np

from ..io.sdp_zip import BlockData, SDPData


def random_sdp(
    num_blocks: int = 4,
    dim: int = 1,
    num_points: int = 4,
    dual_dim: int = 3,
    K: int = 2,
    np_dtype=np.float64,
    seed: int = 0,
    scale: float = 1.0,
) -> SDPData:
    """A random SDP with `num_blocks` identical-shape blocks.

    Data is O(scale) and exactly representable in one limb (top limb only),
    so host/device round-trips are exact for testing.
    """
    rng = np.random.default_rng(seed)
    h_even = (num_points + 1) // 2
    h_odd = num_points // 2
    P = num_points * dim * (dim + 1) // 2

    def limbify(a):
        out = np.zeros((K,) + a.shape, dtype=np_dtype)
        out[0] = a.astype(np_dtype)
        return out

    blocks = []
    for j in range(num_blocks):
        bases_even = limbify(rng.standard_normal((h_even, num_points)) * scale)
        bases_odd = limbify(rng.standard_normal((h_odd, num_points)) * scale)
        c = limbify(rng.standard_normal(P) * scale)
        B = limbify(rng.standard_normal((P, dual_dim)) * scale)
        blocks.append(BlockData(
            index=j, dim=dim, num_points=num_points,
            bases_even=bases_even, bases_odd=bases_odd, c=c, B=B))

    return SDPData(
        objective_const=limbify(np.asarray(0.0)),
        b=limbify(rng.standard_normal(dual_dim) * scale),
        blocks=blocks,
    )
