"""Design trial: the three-word product with its pair products spread over a group of lanes, against the kept kernel.

    python3 sdpb_tpu_torch/tools/wide3_mul_lanes.py [--kg 9 7]

On a CUDA card.  Builds tools/wide3_mul_lanes.cu (two and three warps a
group of 32 products; see its header) for each word size with the
kernels' flags, checks both against csrc/mp_wide3_ops.cu's product
(kernels.mp_wide3_mul) bit for bit, and that against its plain version
(wmul_g_c) on the edge shape, at chip_smoke.py's WIDE3_EW_SHAPES; then
times the three in turns, kept, two warps, three warps, twice over, each
with chip_smoke._queued_ms (CUDA events around 10 calls queued behind a
spin).  The last line is one JSON object: the card and, for each word
size and shape, the ms of each design in both turns and the registers and
stack bytes ptxas gave each kernel.
"""
import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().with_name("wide3_mul_lanes.cu")
DESIGNS = ("kept", "lanes, 2 warps", "lanes, 3 warps")


def _build(kernels, Kg):
    """The trial's library at word size Kg and ptxas's lines about it."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = kernels.BUILD_DIR / f"libwide3_lanes_k{Kg}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *kernels._defines(Kg, kernels.WIDE3),
           "-I", str(kernels.CSRC), "-Xptxas", "-v", "-shared", str(SOURCE), "-o", str(so)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.mp_wide3_mul_lanes_launch.argtypes = [ctypes.c_void_p] * 18 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.mp_wide3_mul_lanes_launch.restype = ctypes.c_int
    info = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "stack frame" in ln]
    return lib, info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kg", type=int, nargs="+", default=[9, 7])
    args = p.parse_args(argv)
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("wide3_mul_lanes.py needs a CUDA card", file=sys.stderr)
        return 2
    from sdpb_tpu_torch.ops import kernels, mpfloat as mp, mpwide
    from sdpb_tpu_torch.tools.profile_phases import card_line
    dev = torch.device("cuda", 0)
    out = {"card": card_line()}
    print(f"card {out['card']}", flush=True)
    rng = np.random.default_rng(21)
    on = lambda x: mpwide.MPW(mp.MP(w.limbs.to(dev), w.exp.to(dev)) for w in x.words)
    for Kg in args.kg:
        t0 = time.time()
        kernels.build([], [], [], probe=False, wide3_Ks=[Kg])
        lib, info = _build(kernels, Kg)
        print(f"Kg={Kg}: built in {time.time() - t0:.1f} s; " + "; ".join(info), flush=True)
        out[f"Kg={Kg} ptxas"] = info
        for shape in cs.WIDE3_EW_SHAPES:
            a, b = (on(cs._wide_operand(rng, shape, Kg, 2.0, G=3)) for _ in range(2))
            n = int(np.prod(shape))
            ins = [t.contiguous() for x in (a, b) for w in x.words for t in (w.limbs, w.exp)]

            def lanes(warps):
                res = [kernels._empty(shape, Kg, True, dev) for _ in range(3)]
                ptrs = ins + [t for w in res for t in (w.limbs, w.exp)]
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = lib.mp_wide3_mul_lanes_launch(*(ctypes.c_void_p(t.data_ptr()) for t in ptrs),
                                                    n, warps, ctypes.c_void_p(stream))
                if err != 0:
                    raise RuntimeError(f"mp_wide3_mul_lanes_launch: CUDA error {err}")
                return mpwide.MPW(res)

            calls = {"kept": lambda: kernels.mp_wide3_mul(a, b),
                     "lanes, 2 warps": lambda: lanes(2), "lanes, 3 warps": lambda: lanes(3)}
            kept = calls["kept"]()
            if n < 1000:
                plain = kernels.mp_wide3_mul_plain(a, b)
                same = all(torch.equal(k.limbs, q.limbs) and torch.equal(k.exp, q.exp)
                           for k, q in zip(kept.words, plain.words))
                if not same:
                    raise RuntimeError(f"the kept kernel differs from its plain version at {shape}")
            for name in DESIGNS[1:]:
                got = calls[name]()
                torch.cuda.synchronize()
                same = all(torch.equal(k.limbs, q.limbs) and torch.equal(k.exp, q.exp)
                           for k, q in zip(kept.words, got.words))
                if not same:
                    raise RuntimeError(f"{name} differs from the kept kernel at {shape} Kg={Kg}")
            ms = {name: [] for name in DESIGNS}
            for _ in range(2):
                for name in DESIGNS:
                    ms[name].append(cs._queued_ms(torch, calls[name]))
            key = f"Kg={Kg} {list(shape)}"
            out[key] = ms
            print(f"{key}: bit for bit; " + ", ".join(
                f"{nm} {' / '.join(f'{t:.3f}' for t in v)} ms" for nm, v in ms.items()),
                flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
