#!/usr/bin/env python3
"""Resources, instruction counts and latencies of a checkout's CUDA kernels on one card.

    python3 sdpb_tpu_torch/tools/kernel_report.py [--root DIR] [--out DIR]

Run it as a file (not with -m), on a CUDA card.  `--root` names the
checkout whose `sdpb_tpu_torch` (sources and wrappers) is measured; the
default is the one holding this script.  For classic K = 4, 5 and scaled
K = 8, 9 (the ladder's factor and GEMM limbs), classic K = 12 and 13 (the
GEMM limbs of --precision 577-681), and for the three-word
kernels at Kg = 9 (--precision 640), it reports:
  * ptxas: registers, stack frame, spill stores and loads of every kernel
    of `kernels.SOURCES` and `kernels.WIDE3_SOURCES` (nvcc -Xptxas -v, the
    kernels' own flags), and of the three-word kernels' outlined word
    operations (stack frame and spills);
  * SASS: instructions of each of those kernels and outlined functions, and
    local-memory loads and stores (cuobjdump -sass of the built libraries);
  * the latency of one MP product, add and rsqrt as a single thread runs
    them back to back (tools/mp_chain_probe.cu over the checkout's
    csrc/mp.cuh), in clock cycles and per SASS instruction: inlined, the
    product with its code once and four times a loop step, and through the
    outlined copies (mpo::); rsqrt also with its Newton steps as four
    products a loop step; and each one's rate over the whole card.
The kernels' times and their bits against the plain versions are
chip_smoke.py's (phases 4, 7, 10) and tools/kernel_times.py's.
The scaled K = 8 and classic K = 12, 13 SASS listings go to --out (default
build/kernel_report), gzipped.  `--wide3-only` reports the three-word
kernels alone (no classic or scaled build, no latency probe).  The last line is one JSON object
with all of it and the card's name and power limit.
"""
import argparse
import ctypes
import gzip
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
PROBE = Path(__file__).resolve().parent / "mp_chain_probe.cu"
BUILDS = ((False, 4), (False, 5), (False, 12), (False, 13), (True, 8), (True, 9))
# the builds whose SASS listings are written to --out
LISTED = ((True, 8), (False, 12), (False, 13))
# the three-word libraries reported (ptxas and SASS only)
WIDE3_BUILDS = (9,)
# (op of mp_chain_probe.cu, name, steps a thread, products a step)
CHAINS = ((0, "mul", 256, 1), (1, "add", 1024, 1), (2, "rsqrt", 32, 1), (3, "mul x4", 64, 4),
          (4, "outlined mul", 256, 1), (5, "outlined add", 1024, 1), (6, "outlined rsqrt", 32, 1),
          (7, "rsqrt x4", 32, 1))
# (part of a mangled name, label): the kernels, and the outlined operations
FUNCTIONS = (("chain_kernel", "chain_kernel"), ("mp_matmul_kernel", "mp_matmul_kernel"),
             ("mp_cholesky_kernel", "mp_cholesky_kernel"), ("mp_trsm_kernel", "mp_trsm_kernel"),
             ("3mpo3mul", "mpo::mul"), ("3mpo3add", "mpo::add"),
             ("mp_wide3_term_kernel", "mp_wide3_term_kernel"),
             ("mp_wide3_tree_kernel", "mp_wide3_tree_kernel"),
             ("mp_wide3_acc_kernel", "mp_wide3_acc_kernel"),
             ("mp_wide3_mul_kernel", "mp_wide3_mul_kernel"),
             ("mp_wide3_add_kernel", "mp_wide3_add_kernel"),
             ("mul_full3_o", "mpw3::mul_full3_o"), ("mul_full_o", "mpw3::mul_full_o"),
             ("mul_st_o", "mpw3::mul_st_o"), ("two_sum_o", "mpw3::two_sum_o"),
             ("add_st_o", "mpw3::add_st_o"), ("sweeps_lift_o", "mpw3::sweeps_lift_o"),
             ("finish_o", "mpw3::finish_o"))
INSTR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def _tag(scaled, K):
    if scaled == "wide3":
        return f"three words Kg={K}"
    return f"{'scaled' if scaled else 'classic'} K={K}"


def _function(mangled):
    """The label of a mangled function name, or None."""
    for part, label in FUNCTIONS:
        if part in mangled:
            if label == "chain_kernel":
                label += "<" + re.search(r"chain_kernelILi(\d)E", mangled).group(1) + ">"
            return label
    return None


def _ptxas_info(text):
    """{kernel: {registers, stack, spill_stores, spill_loads}} from ptxas -v."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = _function(m.group(1))
            if name:
                out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def _sass_counts(text):
    """{kernel: {instructions, local_loads, local_stores, top opcodes}}; a
    function compiled into several objects of a library (an outlined
    operation of a header) is counted in its first copy."""
    funcs, name, ops = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _function(m.group(1))
            if name in funcs:
                name = None
            if name:
                ops = funcs.setdefault(name, {})
            continue
        m = INSTR.match(line)
        if m and name:
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    out = {}
    for name, ops in funcs.items():
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        out[name] = {"instructions": sum(ops.values()), "local_loads": ops.get("LDL", 0),
                     "local_stores": ops.get("STL", 0), "top": dict(top)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(HERE))
    p.add_argument("--out", default=str(HERE / "build" / "kernel_report"))
    p.add_argument("--wide3-only", action="store_true")
    args = p.parse_args(argv)
    builds = () if args.wide3_only else BUILDS
    root = Path(args.root).resolve()
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("kernel_report.py needs a CUDA card", file=sys.stderr)
        return 2
    from sdpb_tpu_torch.ops import kernels, mpfloat as mp
    from sdpb_tpu_torch.tools.profile_phases import card_line
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    card = card_line()
    print(f"checkout {root}; card {card}", flush=True)
    nvcc = kernels._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    report = {"root": str(root), "card": card, "ptxas": {}, "sass": {}, "chains": {}}
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def compile_one(job):
            src, scaled, K = job
            cmd = [nvcc, *kernels.NVCC_FLAGS, *kernels._defines(K, scaled), "-Xptxas", "-v"]
            if src == "probe":
                cmd += ["-I", str(kernels.CSRC), "-shared", str(PROBE), "-o",
                        str(tmp / f"probe_k{K}{int(scaled)}.so")]
            else:
                cmd += ["-c", str(kernels.CSRC / src), "-o",
                        str(tmp / f"{src}.{K}{kernels._tag(scaled)}.o")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"{' '.join(cmd)}:\n{proc.stdout}{proc.stderr}")
            return job, _ptxas_info(proc.stdout + proc.stderr)

        jobs = [(src, s, K) for src in (*kernels.SOURCES, "probe") for s, K in builds]
        jobs += [(src, kernels.WIDE3, K) for src in kernels.WIDE3_SOURCES for K in WIDE3_BUILDS]
        with ThreadPoolExecutor(len(jobs)) as pool:
            for (src, s, K), info in pool.map(compile_one, jobs):
                report["ptxas"].setdefault(_tag(s, K), {}).update(info)
        for rep in (False, True):
            kernels.build([K for s, K in builds if s == rep], [rep], [], probe=False,
                          wide3_Ks=WIDE3_BUILDS)
        print(f"compiled in {time.time() - t0:.1f} s", flush=True)
        for K in WIDE3_BUILDS:
            tag = _tag(kernels.WIDE3, K)
            sass = subprocess.run([cuobjdump, "-sass", str(kernels.library_path(K, kernels.WIDE3))],
                                  capture_output=True, text=True, check=True).stdout
            with gzip.open(outdir / f"sass_wide3_k{K}.txt.gz", "wt") as f:
                f.write(sass)
            report["sass"][tag] = _sass_counts(sass)
            for name, info in sorted(report["ptxas"][tag].items()):
                print(f"{tag} {name}: ptxas {info}; SASS {report['sass'][tag].get(name)}",
                      flush=True)
        for s, K in builds:
            tag = _tag(s, K)
            for what, lib in (("kernels", kernels.library_path(K, s)),
                              ("probe", tmp / f"probe_k{K}{int(s)}.so")):
                sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                                      text=True, check=True).stdout
                if (s, K) in LISTED:
                    with gzip.open(outdir / f"sass_{what}_{_tag(s, K)[0]}{K}.txt.gz", "wt") as f:
                        f.write(sass)
                report["sass"].setdefault(tag, {}).update(_sass_counts(sass))
            for name, info in report["ptxas"][tag].items():
                print(f"{tag} {name}: ptxas {info}; SASS {report['sass'][tag].get(name)}")

            lib = ctypes.CDLL(str(tmp / f"probe_k{K}{int(s)}.so"))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.chain_launch.argtypes = [ci, vp, vp, vp, vp, ci, vp, ci, ci]
            x = mp.from_double(torch.tensor([1.0 + 2.0 ** -20, 1.3], dtype=torch.float64,
                                             device=dev), K, scaled=s)
            chains = {}
            for op, name, steps, per in CHAINS:
                res = {}
                for blocks, threads in ((1, 1), (8 * 132, 128)):
                    o = kernels._empty((blocks * threads,), K, s, dev)
                    cyc = torch.zeros(blocks, dtype=torch.int64, device=dev)

                    def launch():
                        err = lib.chain_launch(op, x.limbs.data_ptr(),
                                               None if x.exp is None else x.exp.data_ptr(),
                                               o.limbs.data_ptr(),
                                               None if o.exp is None else o.exp.data_ptr(),
                                               steps, cyc.data_ptr(), blocks, threads)
                        if err:
                            raise RuntimeError(f"chain_launch: CUDA error {err}")
                    ms = cs._queued_ms(torch, launch)
                    ops = steps * per * blocks * threads
                    if blocks == 1:
                        cycles = int(cyc[0]) / (steps * per)
                        fn = f"chain_kernel<{op}>"
                        instr = report["sass"][tag].get(fn, {}).get("instructions", 0) / per
                        res.update(cycles=cycles, us=1e3 * ms / (steps * per),
                                   instructions=instr,
                                   cycles_per_instruction=cycles / instr if instr else None,
                                   clock_ghz=int(cyc[0]) / (ms * 1e6))
                    else:
                        res["card_per_s"] = ops / (ms / 1e3)
                chains[name] = res
                print(f"{tag} {name}: {res}", flush=True)
            report["chains"][tag] = chains

    print(f"card {card}; {time.time() - t0:.1f} s")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
