"""The port's problem staging (models/sdp.py::build_device_sdp) and
initial state (solver/state.py::initial_state) against the JAX package on
the CPU: classic (random problems and the ladder), scaled (K32 = 3, 7, 9)
and wide (K32 = 10, 17).  Tolerance: none; bucket shapes, masks, limbs and
exponents equal, word for word (test_torch_slice.py's helpers).
"""
import jax
import numpy as np
import pytest
import torch

from sdpb_tpu.io.sdp_zip import read_sdp
from sdpb_tpu.models import sdp as jsdp
from sdpb_tpu.models.synthetic import random_sdp
from sdpb_tpu.solver import state as jstate
from sdpb_tpu_torch import interop
from sdpb_tpu_torch.models import sdp as tsdp
from sdpb_tpu_torch.solver import state as tstate
from sdpb_tpu_torch.utils.strings import str_to_scaled_limbs

from test_torch_slice import (LADDER, _assert_buckets_equal, _assert_scaled_buckets_equal,
                              _assert_wide_buckets_equal)
from torch_parity import same_scaled, same_wide

torch.set_num_threads(1)


@pytest.mark.parametrize("dim", [1, 2])
def test_build_device_sdp_random_matches(dim):
    host = random_sdp(num_blocks=5, dim=dim, num_points=5, dual_dim=3, K=3, seed=dim)
    _assert_buckets_equal(tsdp.build_device_sdp(host, "cpu"),
                          jsdp.build_device_sdp(host))


def test_build_device_sdp_ladder_matches():
    host = read_sdp(LADDER, 2, np.float64)
    port = tsdp.build_device_sdp(host, "cpu")
    _assert_buckets_equal(port, jsdp.build_device_sdp(host))
    bk = port.buckets[0]
    assert bk.batch == 120 and bk.Bmat.shape == (120, 57, 15)
    assert bk.emb_even.shape == (120, 20, 38) and bk.emb_odd.shape == (120, 18, 38)


@pytest.mark.parametrize("source,K32", [("random", 3), ("ladder", 9)])
def test_build_device_sdp_scaled_matches(source, K32):
    K64 = -(-(24 * K32) // 53) + 1
    if source == "random":
        host = random_sdp(num_blocks=5, dim=2, num_points=5, dual_dim=3, K=K64, seed=4)
    else:
        host = read_sdp(LADDER, K64, np.float64)
    port = tsdp.build_device_sdp(host, "cpu", scaled_limbs=K32)
    _assert_scaled_buckets_equal(port, jsdp.build_device_sdp(host, scaled_limbs=K32))
    assert port.b.exp.dtype == torch.int32 and port.b.limbs.dtype == torch.float32
    with pytest.raises(ValueError, match="host limbs"):
        tsdp.build_device_sdp(read_sdp(LADDER, 2, np.float64), "cpu", scaled_limbs=9)


@pytest.mark.parametrize("K32", [3, 7])
def test_initial_state_scaled_matches(K32):
    """X = Omega_p I and Y = Omega_d I with Omega's own exponent; padded
    diagonals at 1.0 on the CENTER(K) ladder; zeros at EXP_ZERO."""
    K64 = -(-(24 * K32) // 53) + 1
    host = random_sdp(num_blocks=5, dim=2, num_points=5, dual_dim=3, K=K64, seed=4)
    jsd = jsdp.build_device_sdp(host, pad_to=8, scaled_limbs=K32)
    tsd = interop.device_sdp_from_numpy(jax.tree.map(np.asarray, jsd), "cpu")
    assert any(float(bk.psd_mask_even.min()) == 0.0 for bk in tsd.buckets)
    om_p, om_d = str_to_scaled_limbs("1e20", K32), str_to_scaled_limbs("3.5e-7", K32)
    ref = jax.tree.map(np.asarray, jstate.initial_state(jsd, om_p, om_d))
    mine = tstate.initial_state(tsd, om_p, om_d)
    assert same_scaled(mine.y, ref.y)
    for mb, rb in zip(mine.buckets, ref.buckets):
        for f in ("x", "X_even", "X_odd", "Y_even", "Y_odd"):
            assert same_scaled(getattr(mb, f), getattr(rb, f)), f


@pytest.mark.parametrize("source,K32", [("random", 10), ("ladder", 17)])
def test_build_device_sdp_wide_matches(source, K32):
    K64 = -(-(24 * K32) // 53) + 1
    if source == "random":
        host = random_sdp(num_blocks=5, dim=2, num_points=5, dual_dim=3, K=K64, seed=4)
    else:
        host = read_sdp(LADDER, K64, np.float64)
    port = tsdp.build_device_sdp(host, "cpu", scaled_limbs=K32)
    _assert_wide_buckets_equal(port, jsdp.build_device_sdp(host, scaled_limbs=K32))
    assert (port.b.Kg, port.b.K) == ((5, 10) if K32 == 10 else (9, 18))


@pytest.mark.parametrize("K32", [10, 17])
def test_initial_state_wide_matches(K32):
    """Word 0: Omega's top word on the real diagonal and 1.0 on the padded
    one; word 1: Omega's remaining mantissa on the real diagonal; zeros at
    EXP_ZERO."""
    K64 = -(-(24 * K32) // 53) + 1
    host = random_sdp(num_blocks=5, dim=2, num_points=5, dual_dim=3, K=K64, seed=4)
    jsd = jsdp.build_device_sdp(host, pad_to=8, scaled_limbs=K32)
    tsd = interop.device_sdp_from_numpy(jax.tree.map(np.asarray, jsd), "cpu")
    assert any(float(bk.psd_mask_even.min()) == 0.0 for bk in tsd.buckets)
    om_p = str_to_scaled_limbs("1e20", K32)
    om_d = str_to_scaled_limbs("0.3333333333333333333333333333333333333333333333333", K32)
    assert isinstance(om_d, list) and om_d[1][0][0] != 0
    ref = jax.tree.map(np.asarray, jstate.initial_state(jsd, om_p, om_d))
    mine = tstate.initial_state(tsd, om_p, om_d)
    assert same_wide(mine.y, ref.y)
    for mb, rb in zip(mine.buckets, ref.buckets):
        for f in ("x", "X_even", "X_odd", "Y_even", "Y_odd"):
            assert same_wide(getattr(mb, f), getattr(rb, f)), f
