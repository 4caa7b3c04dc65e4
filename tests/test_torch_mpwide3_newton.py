"""Three-word division and sqrt (sdpb_tpu_torch/ops/mpwide.py's Newton
iterations over the three-word kernels' plain versions) against the JAX
package's generic-G branches and mpmath on the CPU, at three words of
Kg = 3 limbs (PREC = 216 bits): the companion of
tests/test_torch_mpwide3.py, in a file (an xdist worker process) of its own
since every eager JAX three-word product maps ~1,500 more memory regions
into its process (the kernel allows 65,530), and takes about a second;
tests/test_torch_mpwide3_rsqrt.py holds rsqrt.

Tolerances (tests/test_mpwide.py's bounds): the port within 2^-(PREC-34) of
mpmath, and of the JAX package's result wherever that meets the bound too
(its products miss mpmath on dense words, tests/test_torch_mpwide3.py);
sqrt is 0 at 0 and at a negative value, as in the JAX package (whose
sqrt(x) takes x <= 0 as zero by its top limb).
"""
import mpmath
import numpy as np
import torch

from sdpb_tpu.ops import mpfloat as jmp
from sdpb_tpu_torch.ops import mpfloat as tmp

from test_torch_mpwide3 import PREC, _bits, _held, dense, three  # noqa: F401 (fixture)
from torch_parity import JW, wide_parts_of, wide_to_mpf

torch.set_num_threads(1)

OPS = {
    "div": (lambda x, y: tmp.div(x, y), lambda x, y: jmp.div(x, y), lambda x, y: x / y),
    "rsqrt": (lambda x, y: tmp.rsqrt(y), lambda x, y: jmp.rsqrt(y),
              lambda x, y: 1 / mpmath.sqrt(y)),
}


def newton_op_against_jax_and_mpmath(name):
    port_op, jax_op, exact_op = OPS[name]
    rng = np.random.default_rng({"div": 21, "rsqrt": 22}[name])
    a, b = dense(rng, (8,)), dense(rng, (8,), positive=True)
    mine = port_op(a, b)
    ref = jax_op(JW(wide_parts_of(a)), JW(wide_parts_of(b)))
    ha, hb = wide_to_mpf(a, PREC), wide_to_mpf(b, PREC)
    with mpmath.workprec(PREC + 200):
        exact = [exact_op(x, y) for x, y in zip(ha, hb)]
    _held(mine, ref, exact, [abs(e) for e in exact], PREC, -(PREC - 34))


def test_division_against_jax_and_mpmath(three):
    newton_op_against_jax_and_mpmath("div")


def test_sqrt_against_mpmath(three):
    """The port's sqrt (its rsqrt, held to the JAX package's in
    tests/test_torch_mpwide3_rsqrt.py, then the JAX package's products and
    one refinement) within 2^-(PREC-34) of mpmath; 0 at 0 and at a
    negative value, as the JAX package's sqrt takes x <= 0 by its top limb.
    Not run against the JAX package's sqrt: eagerly it takes 166 s on the
    CPU (its rsqrt and three more products)."""
    rng = np.random.default_rng(23)
    b = dense(rng, (8,), positive=True)
    for w in b.words:
        w.limbs[:, 0] = 0.0
        w.exp[0] = tmp.EXP_ZERO
        w.limbs[:, 1] = -w.limbs[:, 1]
    got = wide_to_mpf(tmp.sqrt(b), PREC)
    assert got[0] == got[1] == 0
    hb = wide_to_mpf(b, PREC)
    with mpmath.workprec(PREC + 200):
        exact = [mpmath.sqrt(y) for y in hb[2:]]
    assert _bits(got[2:], exact, [abs(e) for e in exact], PREC) < -(PREC - 34)
