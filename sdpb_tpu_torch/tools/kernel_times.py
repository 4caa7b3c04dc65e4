"""Device time per ladder iteration of the GEMMs and the triangular solve of a checkout.

    python3 sdpb_tpu_torch/tools/kernel_times.py [--root DIR]

Run it as a file (not with -m), on a CUDA card.  `--root` names the
checkout whose `sdpb_tpu_torch` is imported and timed (default: the one
holding this script); run it for two checkouts in turns (parent, change,
change, parent), each in its own process, to compare their kernels on one
card.  The shapes come from the solver: one CLI run of the 120-block ising
ladder per representation (classic 216 bits, scaled 208 bits, wide 400
bits; two iterations each) with the wrapper calls tallied by shape, as in
chip_smoke.py's phases 6, 9 and 11; each tallied shape is then timed as
those phases time it (chip_smoke.iteration_kernel_ms, from the
chip_smoke.py at the root of the checkout holding this script).  The last
line is one JSON object: the card, and ms per iteration by launch counter
for each representation.
"""
import argparse
import contextlib
import importlib.util
import io
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(HERE))
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times.py needs a CUDA card", file=sys.stderr)
        return 2
    from sdpb_tpu_torch.cli import sdpb as cli
    from sdpb_tpu_torch.ops import kernels, mpfloat as mp
    from sdpb_tpu_torch.tools.profile_phases import card_line
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the context, before the first memory-stats call
    card = card_line()
    print(f"checkout {root}; card {card}", flush=True)
    t0 = time.time()
    # the ladder's limbs: classic K=5 (factor 4), scaled K32=9 (factor 8),
    # wide Kg=9 (factor 9 on word 0)
    kernels.build([4, 5, 8, 9], [False, True], [9], probe=False)
    print(f"build {time.time() - t0:.1f} s", flush=True)
    out = {}
    for label in ("classic", "scaled", "wide"):
        with contextlib.redirect_stdout(io.StringIO()):
            run = cs._ladder_run(torch, kernels, cli, dev, list(cs.LADDER_PREC[label]), 1,
                                 cs.kernel_path(kernels, label))
        print(f"{label}:", flush=True)
        out[label] = cs.iteration_kernel_ms(torch, mp, kernels, dev, run["tally"],
                                            run["iterations"])
    print(json.dumps({"root": str(root), "card": card, "ms_per_iteration": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
