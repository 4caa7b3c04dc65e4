"""Synthetic 3D-Ising-class PMP generator (the port's copy of
sdpb_tpu/tools/gen_pmp.py; the same seed writes the same JSON).

It writes a PMP JSON of the shape the conformal-bootstrap front ends emit
(mathematica/SDPB.m's WriteBootstrapSDP, the nmax6 problems): many blocks
of m x m matrices whose entries are vectors of N+1 polynomials, each block
with a DampedRational prefactor `c * b^x / prod_i (x - p_i)`, negative
poles and base < 1 (Damped_Rational.hxx:8-16).

Without --solvable it measures the converter, not the solver: sdp2input's
cost is the sampling and the Gram-Hankel orthonormal basis of each block
(bilinear_basis.cxx:46-91), here at bootstrap scale.  Entry count =
blocks * dim^2 * (N+1) * (degree+1) polynomial coefficients.

    python -m sdpb_tpu_torch.tools.gen_pmp --blocks 100 --dim 2 --dual 15 \
        --degree 18 [--solvable] [--seed S] -o pmp.json
"""
import argparse
import json
import random


def generate_pmp(num_blocks: int, dim: int, dual_dim: int, degree: int,
                 num_poles: int = 8, seed: int = 0,
                 solvable: bool = False) -> dict:
    """solvable=True makes the problem primal-dual solvable by
    construction (a solve target of hundreds of blocks): the
    normalization is [1, 0...], so the reduced problem reads
    M_j(x) = P0_j(x) + sum_i y_i Pi_j(x) >= 0 — P0_j is made pointwise
    diagonally dominant with positive diagonals (all diagonal coefficients
    >= 0.3 with constant >= 1; off-diagonals coefficient-wise below
    0.3/(dim-1) by Gershgorin), so y = 0 is strictly feasible; with many
    random perturbation directions the feasible region is a.s. bounded,
    so the IPM terminates primal-dual optimal."""
    rng = random.Random(seed)
    nvec = dual_dim + 1

    def coeffs():
        return [f"{rng.uniform(-2.0, 2.0):.17g}" for _ in range(degree + 1)]

    def diag0_coeffs():
        return ([f"{rng.uniform(1.0, 2.0):.17g}"]
                + [f"{rng.uniform(0.3, 1.3):.17g}" for _ in range(degree)])

    def off0_coeffs():
        s = 0.3 / max(1, dim - 1) / 1.5
        return [f"{rng.uniform(-s, s):.17g}" for _ in range(degree + 1)]

    matrices = []
    for j in range(num_blocks):
        # bootstrap-like prefactor: base = rho^? in (0,1), clustered
        # negative poles (pole clustering is what stresses the reference's
        # expint recursion, precompute.cxx:18-62)
        base = f"{rng.uniform(0.05, 0.2):.17g}"
        poles = sorted(rng.uniform(-12.0, -0.25) for _ in range(num_poles))
        dr = {"constant": "1", "base": base,
              "poles": [f"{p:.17g}" for p in poles]}
        # symmetric dim x dim matrix of N+1-polynomial vectors
        upper = {}
        for r in range(dim):
            for c in range(r, dim):
                vec = [coeffs() for _ in range(nvec)]
                if solvable:
                    vec[0] = diag0_coeffs() if r == c else off0_coeffs()
                upper[(r, c)] = vec
        rows = [[upper[(min(r, c), max(r, c))] for c in range(dim)]
                for r in range(dim)]
        matrices.append({"DampedRational": dr, "polynomials": rows})

    objective = ["1"] + [f"{rng.uniform(-1.0, 1.0):.17g}"
                         for _ in range(dual_dim)]
    normalization = ["1"] + ["0"] * dual_dim
    return {"objective": objective, "normalization": normalization,
            "PositiveMatrixWithPrefactorArray": matrices}


def entry_count(num_blocks: int, dim: int, dual_dim: int,
                degree: int) -> int:
    return num_blocks * dim * dim * (dual_dim + 1) * (degree + 1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--blocks", type=int, default=100)
    p.add_argument("--dim", type=int, default=2)
    p.add_argument("--dual", type=int, default=15)
    p.add_argument("--degree", type=int, default=18)
    p.add_argument("--poles", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--solvable", action="store_true",
                   help="certify primal-dual solvability by construction "
                        "(strictly feasible y=0; see generate_pmp)")
    p.add_argument("--output", "-o", required=True)
    args = p.parse_args(argv)
    data = generate_pmp(args.blocks, args.dim, args.dual, args.degree,
                        args.poles, args.seed, solvable=args.solvable)
    with open(args.output, "w") as f:
        json.dump(data, f)
    n = entry_count(args.blocks, args.dim, args.dual, args.degree)
    print(f"wrote {args.output}: {args.blocks} blocks, "
          f"{n} polynomial-coefficient entries")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
