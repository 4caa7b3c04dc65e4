"""Three-word rsqrt (sdpb_tpu_torch/ops/mpwide.py's Newton iteration over
the three-word kernels' plain versions) against the JAX package's
generic-G branch and mpmath on the CPU, at three words of Kg = 3 limbs: in
a file (an xdist worker process) of its own, as
tests/test_torch_mpwide3_newton.py explains; its tolerance.
"""
import torch

from test_torch_mpwide3 import three  # noqa: F401 (fixture)
from test_torch_mpwide3_newton import newton_op_against_jax_and_mpmath

torch.set_num_threads(1)


def test_rsqrt_against_jax_and_mpmath(three):
    newton_op_against_jax_and_mpmath("rsqrt")
