"""The port's hand-written CUDA kernels, their bindings, and beside each its
plain PyTorch version.

Four kernels carry the numerics of the solve (sdpb_tpu/ops/linalg.py
sends every matmul, Cholesky and triangular solve to them):

  * `mp_matmul`            csrc/mp_matmul.cu    <- pallas_kernels.py::_matmul_kernel
  * `mp_cholesky`          csrc/mp_cholesky.cu  <- pallas_kernels.py::_cholesky_kernel
  * `mp_solve_triangular`  csrc/mp_trsm.cu      <- pallas_kernels.py::_trsm_kernel
  * `mp_matmul_wide`       csrc/mp_wide_matmul.cu <- pallas_kernels.py::_matmul_wide_kernel
                           (two words); csrc/mp_wide3_matmul.cu for three words,
                           which the JAX package computes as an XLA composite
                           (sdpb_tpu/ops/linalg.py:32-74, no Pallas kernel)

and one measures the card: `peak_probe` (csrc/peak_probe.cu <- the inner
kernel of tools/profile_phases.py::vpu_peak_gflops), the CUDA-core rate of
unfused float32 or float64 adds and multiplies that the per-phase profiler
(tools/profile_phases.py) reports against.

The first three are built for both MP representations: the classic build
(float64 limbs, csrc/mp.cuh) replaces the `scaled=False` branch of each
Pallas kernel, the scaled build (float32 limbs and an int32 exponent per
element, csrc/mp_scaled.cuh) its `scaled=True` branch; classic limbs go to
K = 13, scaled ones to 9.  The wide GEMM takes MPW operands (ops/mpwide.py)
of G = 2 or 3 words of Kg limbs, each word count its own kernel over
csrc/mp_wide.cuh; the factorizations never see a wide value.

Dispatch is by the device of the operands and nothing else: CUDA tensors
launch the kernel of their representation (a shape, limb count or dtype
the kernel cannot take raises), CPU tensors run the plain version.  There
is no fallback.  Each wrapper counts its launches in `LAUNCHES`, one
counter per (kernel, representation); a CUDA graph's replays add the
launches its capture recorded (take_launches, add_launches), so the counts
stay the launches the device ran.

The plain versions perform the kernels' exact operation order with the
port's MP ops (`mpfloat.kmul`, the mplist term order; for the wide GEMM
the compact ops of ops/mpwide_kernel.py), so on one device a kernel and
its plain version agree limb for limb.  The three-word GEMM's plain
version follows the JAX composite's order (products, a halving tree over
each chunk of the contraction, the chunks added in order) with the
compact word ops.

Build: the CUDA sources are compiled with nvcc at first use, one shared
library per limb count K and representation (-DMP_K=K, -DMP_SCALED=0|1),
into `build/sdpb_tpu_torch/` of the checkout, named by a hash of the
sources and flags; they are bound with ctypes (plain C entry points
returning `cudaGetLastError()`, exponent pointers NULL for classic).  The
wide GEMM has one library per word size Kg (-DMP_WIDE=1 -DMP_SCALED=1
-DMP_K=Kg), built in the same parallel pass, and so have the three-word
GEMM (WIDE3) and the peak probe (one library, no limb count).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import mpfloat as mp
from . import mpwide_kernel as wk
from .mpfloat import MP
from .mpwide import MPW

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sdpb_tpu_torch"
SOURCES = ("mp_matmul.cu", "mp_cholesky.cu", "mp_trsm.cu")
WIDE_SOURCES = ("mp_wide_matmul.cu",)
WIDE3_SOURCES = ("mp_wide3_matmul.cu", "mp_wide3_ops.cu")
PROBE_SOURCES = ("peak_probe.cu",)
# no contraction (a fused TwoProd or TwoSum loses its error term), and
# IEEE subnormals, division and square root, as the plain versions have
# them on the CPU
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
              "-Xcompiler", "-fPIC")
K_RANGE = range(2, 14)              # classic limb counts (scaled: SCALED_K_RANGE)
SCALED_K_RANGE = range(2, 10)
REPRESENTATIONS = (False, True)     # classic, scaled
WIDE = "wide"                       # the representation key of the wide libraries
WIDE_KG = range(3, 10)              # word sizes of the wide GEMM (Kg = 3 for tests)
WIDE3 = "wide3"                     # the key of the three-word GEMM's libraries
WIDE3_KG = (3, 7, 8, 9)             # its word sizes: 19-27 limbs, and Kg = 3 for tests
PROBE = "probe"                     # the key of the peak probe's library (no limb count)
CHUNK = 8   # contraction chunk of the matmul (pallas_kernels.py:101)

KERNEL_NAMES = ("mp_matmul", "mp_cholesky", "mp_solve_triangular")
LAUNCHES = {name + suffix: 0 for suffix in ("", "_scaled") for name in KERNEL_NAMES}
LAUNCHES["mp_matmul_wide"] = 0
LAUNCHES["mp_matmul_wide3"] = 0
LAUNCHES["mp_wide3_add"] = 0
LAUNCHES["mp_wide3_mul"] = 0
LAUNCHES["peak_probe"] = 0
_LIBS = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def take_launches(before: dict) -> dict:
    """The launches counted since `before` (a copy of LAUNCHES), taken back
    out of LAUNCHES: what a CUDA-graph capture recorded without running."""
    made = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES}
    LAUNCHES.update(before)
    return made


def add_launches(counts: dict) -> None:
    """Count the launches of one replay of a captured graph."""
    for k, v in counts.items():
        LAUNCHES[k] += v


def counter(name: str, scaled: bool) -> str:
    """The LAUNCHES key of a kernel in one representation."""
    return name + ("_scaled" if scaled else "")


# ---------------------------------------------------------------------------
# Build and binding


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _tag(rep) -> str:
    return {WIDE: "w", WIDE3: "t", PROBE: "p"}.get(rep) or ("s" if rep else "c")


def k_range(rep) -> tuple:
    """The limb counts (word sizes) a representation's libraries take."""
    return tuple({WIDE: WIDE_KG, WIDE3: WIDE3_KG}.get(rep)
                 or (SCALED_K_RANGE if rep else K_RANGE))


def library_path(K: int, scaled=False) -> Path:
    """The library of limb count K in a representation: False (classic),
    True (scaled), WIDE or WIDE3 (K = Kg, the two- and three-word GEMMs);
    PROBE (K ignored) is the peak probe's."""
    if scaled == PROBE:
        return BUILD_DIR / f"libpeak_{_source_hash()}.so"
    return BUILD_DIR / f"libmpk_{_source_hash()}_k{K}{_tag(scaled)}.so"


def _sources(rep) -> tuple:
    return {WIDE: WIDE_SOURCES, WIDE3: WIDE3_SOURCES, PROBE: PROBE_SOURCES}.get(rep, SOURCES)


def _defines(K: int, rep) -> list:
    if rep == PROBE:
        return []
    if rep in (WIDE, WIDE3):
        return [f"-DMP_K={K}", "-DMP_SCALED=1", "-DMP_WIDE=1"]
    return [f"-DMP_K={K}", f"-DMP_SCALED={int(rep)}"]


def build(Ks=K_RANGE, representations=REPRESENTATIONS, wide_Ks=WIDE_KG,
          probe: bool = True, wide3_Ks=WIDE3_KG) -> list:
    """Compile the libraries that are missing: (K, classic/scaled) for K in
    Ks that the representation takes, (Kg, WIDE) for Kg in wide_Ks, (Kg,
    WIDE3) for Kg in wide3_Ks, (0, PROBE) with `probe`; the (source, K,
    representation) objects in parallel, one nvcc each, as many at a time
    as there are cores, the largest limb counts first (they compile
    longest).  Returns the (K, representation) pairs built."""
    todo = [(K, s) for s in representations for K in Ks
            if K in k_range(s) and not library_path(K, s).exists()]
    todo += [(K, WIDE) for K in wide_Ks if not library_path(K, WIDE).exists()]
    todo += [(K, WIDE3) for K in wide3_Ks if not library_path(K, WIDE3).exists()]
    if probe and not library_path(0, PROBE).exists():
        todo.append((0, PROBE))
    if not todo:
        return todo
    nvcc = _nvcc()
    t0 = time.time()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        def obj(K, s, src):
            return str(Path(tmp) / f"{src}.k{K}{_tag(s)}.o")

        compiles = [[nvcc, *NVCC_FLAGS, *_defines(K, s), "-c", str(CSRC / src),
                     "-o", obj(K, s, src)]
                    for K, s in sorted(todo, key=lambda t: -t[0]) for src in _sources(s)]
        with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
            seconds = list(pool.map(_run, compiles))
        for K, s in todo:
            so = Path(tmp) / f"k{K}{_tag(s)}.so"
            _run([nvcc, "-shared", "-o", str(so), *(obj(K, s, src) for src in _sources(s))])
            os.replace(so, library_path(K, s))
    slowest = sorted(zip(seconds, compiles), key=lambda t: -t[0])[:3]
    print(f"built CUDA kernels for (K, representation) {todo} in "
          f"{time.time() - t0:.1f} s ({BUILD_DIR}); slowest objects: "
          + ", ".join(f"{Path(c[-1]).name} {t:.1f} s" for t, c in slowest), flush=True)
    return todo


def _run(cmd) -> float:
    """Run a build command; its seconds."""
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return time.time() - t0


def _library(K: int, scaled) -> ctypes.CDLL:
    if K not in k_range(scaled):
        raise ValueError(f"the CUDA kernels take 2 <= K <= 13 classic limbs, 2 <= K <= 9 "
                         f"scaled ones, word sizes {list(WIDE_KG)} (two words) and "
                         f"{list(WIDE3_KG)} (three words); got K={K} ({scaled!r}); "
                         f"classic K >= 14 on a card: ROADMAP A23")
    lib = _LIBS.get((K, scaled))
    if lib is None:
        if scaled in (WIDE, WIDE3):
            build([], [], [K] if scaled == WIDE else [], probe=False,
                  wide3_Ks=[K] if scaled == WIDE3 else [])
        else:
            build([K], [scaled], [], probe=False, wide3_Ks=[])
        lib = ctypes.CDLL(str(library_path(K, scaled)))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if scaled == WIDE:
            lib.mp_wide_matmul_launch.argtypes = [vp] * 16 + [ci] * 5 + [vp]
            lib.mp_wide_matmul_launch.restype = ci
        elif scaled == WIDE3:
            lib.mp_wide3_matmul_launch.argtypes = [vp] * 20 + [ci] * 6 + [vp]
            lib.mp_wide3_ew_launch.argtypes = [vp] * 18 + [ctypes.c_longlong, ci, vp]
            lib.mp_wide3_matmul_launch.restype = lib.mp_wide3_ew_launch.restype = ci
        else:
            lib.mp_matmul_launch.argtypes = [vp] * 6 + [ci] * 4 + [vp]
            lib.mp_cholesky_launch.argtypes = [vp] * 6 + [ci] * 2 + [vp]
            lib.mp_trsm_launch.argtypes = [vp] * 10 + [ci] * 4 + [vp]
            for f in (lib.mp_matmul_launch, lib.mp_cholesky_launch,
                      lib.mp_trsm_launch):
                f.restype = ci
        _LIBS[(K, scaled)] = lib
    return lib


def _on_cpu(*xs: MP) -> bool:
    """True when every operand lies on the CPU; False when every operand
    lies on one CUDA device in the kernels' types (float64 limbs, or
    float32 limbs with int32 exponents); raises on anything else."""
    types = {x.device.type for x in xs}
    if types == {"cpu"}:
        return True
    if types != {"cuda"} or len({x.device for x in xs}) != 1:
        raise ValueError(f"operands must all lie on the CPU or on one CUDA "
                         f"device, got {[str(x.device) for x in xs]}")
    scaled = xs[0].scaled
    for x in xs:
        if x.scaled != scaled:
            raise TypeError("cannot mix scaled and classic MP operands")
        want = mp.SCALED_DTYPE if scaled else torch.float64
        if x.dtype != want:
            raise TypeError(f"the {'scaled' if scaled else 'classic'} CUDA kernels "
                            f"take {want} limbs, got {x.dtype}")
        if scaled and (x.exp.dtype != torch.int32 or x.exp.device != x.device):
            raise TypeError(f"scaled exponents must be int32 on {x.device}")
    return False


def _parts(x: MP):
    """(limbs, exp) device pointers of a contiguous MP (exp NULL when
    classic)."""
    return x.limbs, x.exp


def _launch(name: str, K: int, scaled: bool, device, tensors, ints) -> None:
    lib = _library(K, scaled)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        args = [ctypes.c_void_p(None if t is None else t.data_ptr())
                for t in tensors]
        err = getattr(lib, name)(*args, *ints, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


def _empty(shape, K: int, scaled: bool, device) -> MP:
    """Uninitialized kernel output [K, *shape] in the representation."""
    if not scaled:
        return MP(torch.empty((K,) + tuple(shape), dtype=torch.float64,
                              device=device))
    return MP(torch.empty((K,) + tuple(shape), dtype=mp.SCALED_DTYPE, device=device),
              torch.empty(tuple(shape), dtype=torch.int32, device=device))


def _contiguous(x: MP) -> MP:
    return MP(x.limbs.contiguous(), None if x.exp is None else x.exp.contiguous())


def _clone(x: MP) -> MP:
    return MP(x.limbs.clone(), None if x.exp is None else x.exp.clone())


# ---------------------------------------------------------------------------
# MP GEMM


def _canon_batched_pair(a: MP, b: MP):
    """Broadcast the leading batch axes of [..., M, Kd] x [..., Kd, N] and
    flatten them to one contiguous batch axis (pallas_kernels.py:367-402).
    Returns (a4 [K,B,M,Kd], b4 [K,B,Kd,N], unflatten)."""
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    M, Kd = a.shape[-2], a.shape[-1]
    N = b.shape[-1]
    if b.shape[-2] != Kd:
        raise ValueError(f"matmul shapes {a.shape} @ {b.shape}")
    B = int(np.prod(batch, dtype=np.int64)) if batch else 1

    def canon(x: MP, r: int, c: int) -> MP:
        fill = (1,) * (len(batch) - (x.ndim - 2))
        limbs = x.limbs.reshape((x.K,) + fill + tuple(x.limbs.shape[1:]))
        limbs = limbs.expand((x.K,) + batch + (r, c))
        exp = None
        if x.scaled:
            exp = x.exp.reshape(fill + tuple(x.exp.shape)).expand(batch + (r, c))
            exp = exp.reshape((B, r, c))
        return _contiguous(MP(limbs.reshape((x.K, B, r, c)), exp))

    def unflatten(r: MP) -> MP:
        return MP(r.limbs.reshape((r.K,) + batch + (M, N)),
                  None if r.exp is None else r.exp.reshape(batch + (M, N)))

    return canon(a, M, Kd), canon(b, Kd, N), unflatten


def mp_matmul_plain(a: MP, b: MP) -> MP:
    """Plain version of the matmul kernel on [K,B,M,Kd] x [K,B,Kd,N]: the
    contraction in zero-padded chunks of 8 (scaled zeros at EXP_ZERO), each
    chunk's products summed as a pairwise tree, chunk sums folded into the
    accumulator."""
    K, B, M, Kd = a.limbs.shape
    N = b.limbs.shape[-1]
    pad = (-Kd) % CHUNK
    if pad:
        a = mp.pad_dim(a, 2, pad)
        b = mp.pad_dim(b, 1, pad)
    acc = mp.zeros((B, M, N), K, a.device, scaled=a.scaled)
    for c in range((Kd + pad) // CHUNK):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        x = MP(a.limbs[:, :, :, sl].permute(0, 3, 1, 2)[..., None],       # [K,8,B,M,1]
               None if a.exp is None else a.exp[:, :, sl].permute(2, 0, 1)[..., None])
        y = MP(b.limbs[:, :, sl, :].permute(0, 2, 1, 3)[:, :, :, None],   # [K,8,B,1,N]
               None if b.exp is None else b.exp[:, sl, :].permute(1, 0, 2)[:, :, None])
        terms = mp.kmul(x, y)
        while terms.shape[0] > 1:
            terms = mp.add(terms[0::2], terms[1::2])
        acc = mp.add(acc, terms[0])
    return acc


def mp_matmul(a: MP, b: MP) -> MP:
    """Batched MP matmul a [..., M, Kd] @ b [..., Kd, N] (broadcast batch)."""
    if a.K != b.K:
        raise ValueError(f"limb counts differ: {a.K} vs {b.K}")
    a4, b4, unflatten = _canon_batched_pair(a, b)
    if _on_cpu(a4, b4):
        return unflatten(mp_matmul_plain(a4, b4))
    K, B, M, Kd = a4.limbs.shape
    N = b4.limbs.shape[-1]
    out = _empty((B, M, N), K, a4.scaled, a4.device)
    if out.limbs.numel():
        _launch("mp_matmul_launch", K, a4.scaled, a4.device,
                (*_parts(a4), *_parts(b4), *_parts(out)), (B, M, Kd, N))
        LAUNCHES[counter("mp_matmul", a4.scaled)] += 1
    return unflatten(out)


# ---------------------------------------------------------------------------
# Wide (two-word) MP GEMM


def _canon_wide_pair(a: MPW, b: MPW):
    """_canon_batched_pair word by word (pallas_kernels.py:322-333)."""
    ca, cb, unf = [], [], []
    for wa, wb in zip(a.words, b.words):
        a4, b4, u = _canon_batched_pair(wa, wb)
        ca.append(a4)
        cb.append(b4)
        unf.append(u)
    return MPW(ca), MPW(cb), lambda r: MPW(u(w) for u, w in zip(unf, r.words))


# Terms (b, m, t, n) that the wide GEMM holds at once: it runs over t in
# chunks of at most max(1, budget // (B M N)) values, so the kernel's term
# scratch (2 (4 Kg + 4) bytes a term: at most 168 MB at Kg = 9, or B M N
# terms where that is more) and the plain version's row stacks (~1.4 KB a
# term at Kg = 9: 88 MB a stack, or B M N terms' worth) stay bounded
# whatever Kd is.
WIDE_TERMS = 1 << 21
WIDE_PLAIN_TERMS = 1 << 16


def wide_chunk(B: int, M: int, Kd: int, N: int, budget: int) -> int:
    """Values of t per chunk of the wide GEMM (at least 1)."""
    return max(1, min(Kd, budget // max(1, B * M * N)))


def mp_matmul_wide_plain(a: MPW, b: MPW) -> MPW:
    """Plain version of the wide GEMM on two-word operands [Kg,B,M,Kd] x
    [Kg,B,Kd,N], in the kernel's two passes over chunks of t: the
    accumulator-free part wfma_term_c of every term of a chunk in one
    batched call, then per output the accumulate part wacc_c over the
    chunk's t in order, from a zero accumulator carried across the chunks;
    at the end wnormalize_c.  The same operations on the same operands as
    the one-pass chain of wfma_acc_c (the Pallas kernel's chunk = 1 order),
    so the same bits."""
    Kg = a.Kg
    _, B, M, Kd = a.words[0].limbs.shape
    N = b.words[0].limbs.shape[-1]
    acc = wk.wzeros((B, M, N), Kg, a.device)
    tc = wide_chunk(B, M, Kd, N, WIDE_PLAIN_TERMS)
    for t0 in range(0, Kd, tc):
        s = slice(t0, t0 + tc)
        wa = tuple((w.limbs[..., s, None], w.exp[..., s, None]) for w in a.words)
        wb = tuple((w.limbs[:, :, None, s], w.exp[:, None, s]) for w in b.words)
        (p0l, p0e), (cpl, cpe) = wk.wfma_term_c(wa, wb, Kg)       # [Kg,B,M,tc,N]
        for t in range(p0e.shape[-2]):
            acc = wk.wacc_c(acc, (p0l[..., t, :], p0e[..., t, :]),
                            (cpl[..., t, :], cpe[..., t, :]), Kg)
    return MPW(MP(*w) for w in wk.wnormalize_c(acc, Kg))


def mp_matmul_wide(a: MPW, b: MPW) -> MPW:
    """Batched wide MP matmul a [..., M, Kd] @ b [..., Kd, N] (broadcast
    batch) of two- or three-word operands; CUDA operands launch the GEMM
    kernel of their word count and size, CPU operands run its plain
    version."""
    if not (isinstance(a, MPW) and isinstance(b, MPW)):
        raise TypeError(f"mp_matmul_wide takes two MPW, got {type(a).__name__} "
                        f"and {type(b).__name__}")
    if a.G != b.G or a.G not in (2, 3):
        raise ValueError(f"the wide GEMM takes operands of G = 2 or G = 3 words alike, "
                         f"got G={a.G} and G={b.G}")
    if a.Kg != b.Kg:
        raise ValueError(f"word sizes differ: {a.Kg} vs {b.Kg}")
    a4, b4, unflatten = _canon_wide_pair(a, b)
    if a.G == 3:
        return unflatten(_matmul_wide3(a4, b4))
    if _on_cpu(*a4.words, *b4.words):
        return unflatten(mp_matmul_wide_plain(a4, b4))
    Kg, B, M, Kd = a4.words[0].limbs.shape
    N = b4.words[0].limbs.shape[-1]
    out = [_empty((B, M, N), Kg, True, a4.device) for _ in range(2)]
    if out[0].limbs.numel():
        # the (p0, cp) of one chunk's terms, written by the kernel's first
        # pass and read by its second
        tc = wide_chunk(B, M, Kd, N, WIDE_TERMS)
        scratch = [_empty((B * M * min(tc, Kd) * N,), Kg, True, a4.device)
                   for _ in range(2)]
        ptrs = [p for w in (*a4.words, *b4.words, *out, *scratch) for p in _parts(w)]
        _launch("mp_wide_matmul_launch", Kg, WIDE, a4.device, ptrs, (B, M, Kd, N, tc))
        LAUNCHES["mp_matmul_wide"] += 1
    return unflatten(MPW(out))


# ---------------------------------------------------------------------------
# Three-word MP GEMM


# Terms (b, m, t, n) of the three-word GEMM held at once, by the kernel
# and its plain version alike: the kernel's scratch (3 (4 Kg + 4) bytes a
# term: 126 MB at Kg = 9) and the plain version's row stacks (up to ~2 KB
# a term and stack at Kg = 9) stay bounded whatever Kd is; a pass holds at
# least one chunk of every output.  The passes change no bit.
WIDE3_TERMS = 1 << 20


def wide3_chunk(K: int) -> int:
    """The contraction chunk of the JAX package's composite wide GEMM
    (sdpb_tpu/ops/linalg.py:43-47) at K limbs in all: 128 below K = 6,
    else max(4, 3200 // K^2) (4 at K = 27, 7 at K = 21)."""
    return 128 if K < 6 else max(4, (128 * 25) // (K * K))


def wide3_plan(B: int, M: int, Kd: int, N: int, K: int, budget: int):
    """(c, nch, tc): the chunk c (Kd itself where Kd <= wide3_chunk(K): the
    composite then sums the products unpadded), the chunks nch, and the
    values of t per pass tc, a multiple of c, at least c."""
    chunk = wide3_chunk(K)
    c = Kd if Kd <= chunk else chunk
    nch = -(-Kd // c)
    return c, nch, c * max(1, min(nch, budget // max(1, B * M * N * c)))


def _sv_words(x: MPW, idx) -> tuple:
    return tuple((w.limbs[(slice(None),) + idx], w.exp[idx]) for w in x.words)


def mp_matmul_wide3_plain(a: MPW, b: MPW, tally: Optional[wk.SkipTally] = None) -> MPW:
    """Plain version of the three-word GEMM on [Kg,B,M,Kd] x [Kg,B,Kd,N]:
    the JAX composite's order (sdpb_tpu/ops/linalg.py:32-74) with the
    compact word ops of ops/mpwide_kernel.py.  Per pass of tc values of t,
    the products of every term at once (wmul_g_c), then each chunk's
    halving tree (wadd_g_c on the two halves, an odd last term carried) and
    the chunk sum added into the accumulator, which starts at zero; a
    single chunk is the result.  Kd = 0 gives zeros.  `tally` counts the
    skipped word TwoSums of the work the product needs: the Kd products and
    the sums of two partial sums that each hold a term, not the zero
    padding's products and sums, nor the add into the zero accumulator."""
    Kg = a.Kg
    _, B, M, Kd = a.words[0].limbs.shape
    N = b.words[0].limbs.shape[-1]
    if Kd == 0:
        return _wide_zeros((B, M, N), Kg, 3, a.device)
    c, nch, tc = wide3_plan(B, M, Kd, N, a.K, WIDE3_TERMS)
    if nch * c > Kd:
        a = mp.pad_dim(a, 2, nch * c - Kd)
        b = mp.pad_dim(b, 1, nch * c - Kd)

    def skip(needed):
        return None if tally is None else tally.skip(needed)

    E, S = Ellipsis, slice(None)
    acc = tuple(wk.wzeros((B, M, N), Kg, a.device)[0] for _ in range(3))
    for t0 in range(0, nch * c, tc):
        ts = slice(t0, t0 + tc)
        # the terms of the pass that are not padding, per t: [tc, 1]
        real = (torch.arange(t0, min(t0 + tc, nch * c), device=a.device) < Kd)[:, None]
        terms = wk.wmul_g_c(_sv_words(a, (S, S, ts, None)), _sv_words(b, (S, None, ts, S)),
                            Kg, skip(real))                          # [Kg,B,M,tc,N]
        for q in range(0, terms[0][1].shape[-2], c):
            sub = tuple((l[E, q:q + c, :], e[E, q:q + c, :]) for l, e in terms)
            held = real[q:q + c]
            n = c
            while n > 1:
                half = n // 2
                lo, hi = held[:half], held[half:2 * half]
                s = wk.wadd_g_c(tuple((l[E, :half, :], e[E, :half, :]) for l, e in sub),
                                tuple((l[E, half:2 * half, :], e[E, half:2 * half, :])
                                      for l, e in sub), Kg, skip(lo & hi))
                if n % 2:
                    s = tuple((torch.cat([sl, l[E, n - 1:n, :]], -2),
                               torch.cat([se, e[E, n - 1:n, :]], -2))
                              for (sl, se), (l, e) in zip(s, sub))
                held = torch.cat([lo | hi, held[n - 1:n]] if n % 2 else [lo | hi])
                sub, n = s, half + n % 2
            chunk_sum = tuple((l[E, 0, :], e[E, 0, :]) for l, e in sub)
            acc = chunk_sum if nch == 1 else wk.wadd_g_c(
                acc, chunk_sum, Kg, skip(None) if t0 + q else None)
    return MPW(MP(*w) for w in acc)


def _wide_zeros(shape, Kg: int, G: int, device) -> MPW:
    return MPW(MP(*wk.wzeros(shape, Kg, device)[0]) for _ in range(G))


def _matmul_wide3(a4: MPW, b4: MPW) -> MPW:
    """The three-word GEMM on canonical operands: the kernel for CUDA
    operands, the plain version for CPU ones."""
    if _on_cpu(*a4.words, *b4.words):
        return mp_matmul_wide3_plain(a4, b4)
    Kg, B, M, Kd = a4.words[0].limbs.shape
    N = b4.words[0].limbs.shape[-1]
    if Kd == 0:
        _library(Kg, WIDE3)          # the word size is refused as the kernel would
        return _wide_zeros((B, M, N), Kg, 3, a4.device)
    out = [_empty((B, M, N), Kg, True, a4.device) for _ in range(3)]
    if out[0].limbs.numel():
        c, _, tc = wide3_plan(B, M, Kd, N, a4.K, WIDE3_TERMS)
        # the products of one pass's terms, written by the kernel's first
        # launch, summed in place by its second and read by its third
        terms = B * M * tc * N
        scratch = (torch.empty((3, Kg, terms), dtype=mp.SCALED_DTYPE, device=a4.device),
                   torch.empty((3, terms), dtype=torch.int32, device=a4.device))
        ptrs = [p for w in (*a4.words, *b4.words, *out) for p in _parts(w)] + list(scratch)
        _launch("mp_wide3_matmul_launch", Kg, WIDE3, a4.device, ptrs, (B, M, Kd, N, c, tc))
        LAUNCHES["mp_matmul_wide3"] += 1
    return MPW(out)


# ---------------------------------------------------------------------------
# Three-word elementwise sum and product


def _wide3_words(x: MPW, shape) -> tuple:
    """x's words broadcast to `shape`, as (limbs, exp) pairs."""
    shape = tuple(shape)
    fill = (1,) * (len(shape) - x.ndim)
    return tuple((torch.broadcast_to(w.limbs.reshape((w.K,) + fill + tuple(w.shape)),
                                     (w.K,) + shape),
                  torch.broadcast_to(w.exp, shape)) for w in x.words)


def mp_wide3_add_plain(a: MPW, b: MPW, tally: Optional[wk.SkipTally] = None) -> MPW:
    """Plain version of the three-word sum kernel: wadd_g_c; `tally` counts
    its skipped word TwoSums."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return MPW(MP(*w) for w in wk.wadd_g_c(_wide3_words(a, shape), _wide3_words(b, shape),
                                           a.Kg, None if tally is None else tally.skip()))


def mp_wide3_mul_plain(a: MPW, b: MPW, tally: Optional[wk.SkipTally] = None) -> MPW:
    """Plain version of the three-word product kernel: wmul_g_c; `tally`
    counts its skipped word TwoSums."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return MPW(MP(*w) for w in wk.wmul_g_c(_wide3_words(a, shape), _wide3_words(b, shape),
                                           a.Kg, None if tally is None else tally.skip()))


def _wide3_ew(a: MPW, b: MPW, op: int) -> MPW:
    if a.G != 3 or b.G != 3 or a.Kg != b.Kg:
        raise ValueError(f"the three-word kernels take two values of G = 3 words of one "
                         f"size, got {a!r} and {b!r}")
    if _on_cpu(*a.words, *b.words):
        return (mp_wide3_add_plain if op == 0 else mp_wide3_mul_plain)(a, b)
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
    Kg = a.Kg
    n = int(np.prod(shape, dtype=np.int64))
    out = [_empty(shape, Kg, True, a.device) for _ in range(3)]
    if n:
        ptrs = [t.contiguous() for x in (a, b) for w in _wide3_words(x, shape) for t in w]
        ptrs += [t for w in out for t in _parts(w)]
        _launch("mp_wide3_ew_launch", Kg, WIDE3, a.device, ptrs, (n, op))
        LAUNCHES["mp_wide3_add" if op == 0 else "mp_wide3_mul"] += 1
    return MPW(out)


def mp_wide3_add(a: MPW, b: MPW) -> MPW:
    """a + b of three-word values (broadcast shapes): one kernel launch on
    the card, the plain version (wadd_g_c) on the CPU."""
    return _wide3_ew(a, b, 0)


def mp_wide3_mul(a: MPW, b: MPW) -> MPW:
    """a * b of three-word values (broadcast shapes): one kernel launch on
    the card, the plain version (wmul_g_c) on the CPU."""
    return _wide3_ew(a, b, 1)


# ---------------------------------------------------------------------------
# MP Cholesky


def _as_batched(a: MP):
    """[..., n, m] -> contiguous [K, B, n, m] plus the inverse reshape."""
    batch = a.shape[:-2]
    B = int(np.prod(batch, dtype=np.int64)) if batch else 1
    a4 = _contiguous(a.reshape((B,) + a.shape[-2:]))

    def unflatten(r: MP) -> MP:
        return r.reshape(batch + r.shape[-2:])

    return a4, unflatten


def mp_cholesky_plain(a: MP) -> MP:
    """Plain version of the Cholesky kernel: right-looking, lower triangle
    only, one kernel-order rsqrt chain per pivot."""
    n = a.shape[-1]
    W = _clone(a)
    L = mp.zeros(a.shape, a.K, a.device, scaled=a.scaled)
    E = Ellipsis
    for j in range(n):
        d2 = W[E, j, j]
        r = mp.rsqrt(d2, kernel_order=True)
        mp.set_block(L, (E, j, j), mp.kmul(d2, r))
        if j + 1 == n:
            break
        below = mp.kmul(W[E, j + 1:, j], mp.expand_dims(r, -1))
        mp.set_block(L, (E, slice(j + 1, None), j), below)
        upd = mp.kmul(mp.expand_dims(below, -1), mp.expand_dims(below, -2))
        trail = (E, slice(j + 1, None), slice(j + 1, None))
        mp.set_block(W, trail, mp.sub(W[trail], upd))
    return L


def mp_cholesky(a: MP) -> MP:
    """Lower Cholesky factor of SPD blocks a [..., n, n]."""
    if a.shape[-1] != a.shape[-2]:
        raise ValueError(f"cholesky of non-square {a.shape}")
    a4, unflatten = _as_batched(a)
    if _on_cpu(a4):
        return unflatten(mp_cholesky_plain(a4))
    K, B, n, _ = a4.limbs.shape
    work = _empty((B, n, n), K, a4.scaled, a4.device)
    L = _empty((B, n, n), K, a4.scaled, a4.device)
    if L.limbs.numel():
        _launch("mp_cholesky_launch", K, a4.scaled, a4.device,
                (*_parts(a4), *_parts(work), *_parts(L)), (B, n))
        LAUNCHES[counter("mp_cholesky", a4.scaled)] += 1
    return unflatten(L)


# ---------------------------------------------------------------------------
# MP triangular solve


def mp_solve_triangular_plain(t: MP, b: MP, lower: bool) -> MP:
    """Plain version of the triangular-solve kernel: diagonal reciprocals
    once, then right-looking substitution (forward for lower t, backward
    for upper t)."""
    n = b.shape[-2]
    E = Ellipsis
    dinv = mp.reciprocal(mp.diagonal(t), kernel_order=True)          # [..., n]
    R = _clone(b)
    X = mp.zeros(b.shape, b.K, b.device, scaled=b.scaled)
    for step in range(n):
        i = step if lower else n - 1 - step
        xi = mp.kmul(R[E, i, :], mp.expand_dims(dinv[E, i], -1))
        mp.set_block(X, (E, i, slice(None)), xi)
        if (n - 1 - i if lower else i) == 0:
            continue
        rows = slice(i + 1, n) if lower else slice(0, i)
        upd = mp.kmul(mp.expand_dims(t[E, rows, i], -1), mp.expand_dims(xi, -2))
        mp.set_block(R, (E, rows, slice(None)), mp.sub(R[E, rows, :], upd))
    return X


def mp_solve_triangular(t: MP, b: MP, lower: bool = True) -> MP:
    """X = t^{-1} b for triangular t [..., n, n] and b [..., n, m] with the
    same batch shape; `lower=False` takes an upper t (pass L.mT)."""
    if t.K != b.K:
        raise ValueError(f"limb counts differ: {t.K} vs {b.K}")
    if t.shape[:-2] != b.shape[:-2] or t.shape[-1] != t.shape[-2] \
            or t.shape[-1] != b.shape[-2]:
        raise ValueError(f"triangular solve shapes {t.shape} \\ {b.shape}")
    t4, _ = _as_batched(t)
    b4, unflatten = _as_batched(b)
    if _on_cpu(t4, b4):
        return unflatten(mp_solve_triangular_plain(t4, b4, lower))
    K, B, n, m = b4.limbs.shape
    X = _empty((B, n, m), K, b4.scaled, b4.device)
    if X.limbs.numel():
        # the residual and the reciprocals, where they do not fit in shared
        # memory
        resid = _empty((B, n, m), K, b4.scaled, b4.device)
        dinv = _empty((B, n), K, b4.scaled, b4.device)
        _launch("mp_trsm_launch", K, b4.scaled, b4.device,
                (*_parts(t4), *_parts(b4), *_parts(resid), *_parts(dinv), *_parts(X)),
                (B, n, m, int(lower)))
        LAUNCHES[counter("mp_solve_triangular", b4.scaled)] += 1
    return unflatten(X)


# ---------------------------------------------------------------------------
# Peak probe


PROBE_DTYPES = (torch.float32, torch.float64)


def _probe_library() -> ctypes.CDLL:
    lib = _LIBS.get(PROBE)
    if lib is None:
        build([], [], [], probe=True)
        lib = ctypes.CDLL(str(library_path(0, PROBE)))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.peak_probe_f32.argtypes = [vp, vp, ci, ci, ctypes.c_float, ctypes.c_float, vp]
        lib.peak_probe_f64.argtypes = [vp, vp, ci, ci, ctypes.c_double, ctypes.c_double,
                                       vp]
        lib.peak_probe_f32.restype = lib.peak_probe_f64.restype = ci
        _LIBS[PROBE] = lib
    return lib


def peak_probe_plain(x: torch.Tensor, steps: int, a: float, b: float) -> torch.Tensor:
    """Plain version of the peak probe: `steps` passes of x * a + b, the
    multiply and the add two torch ops (each rounded on its own), with a
    and b as 0-dim tensors of x's dtype."""
    a_t = torch.tensor(a, dtype=x.dtype, device=x.device)
    b_t = torch.tensor(b, dtype=x.dtype, device=x.device)
    for _ in range(steps):
        x = torch.add(torch.mul(x, a_t), b_t)
    return x


def peak_probe(x: torch.Tensor, steps: int, a: float, b: float) -> torch.Tensor:
    """`steps` dependent passes of x <- round(round(x * a) + b) over every
    element of a float32 or float64 tensor; a and b are rounded to x's
    dtype.  A contiguous CUDA tensor launches csrc/peak_probe.cu, a CPU
    tensor runs the plain version, anything else raises."""
    if x.dtype not in PROBE_DTYPES:
        raise TypeError(f"the peak probe takes float32 or float64, got {x.dtype}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if x.device.type == "cpu":
        return peak_probe_plain(x, steps, a, b)
    if x.device.type != "cuda":
        raise ValueError(f"the peak probe runs on the CPU or a CUDA device, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("the peak probe takes a contiguous tensor")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"the peak probe takes fewer than 2^31 elements, got {x.numel()}")
    lib = _probe_library()
    out = torch.empty_like(x)
    f64 = x.dtype == torch.float64
    fn, scalar = (lib.peak_probe_f64, ctypes.c_double) if f64 else \
        (lib.peak_probe_f32, ctypes.c_float)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                 x.numel(), steps, scalar(a), scalar(b), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"peak_probe failed to launch: CUDA error {err}")
    LAUNCHES["peak_probe"] += 1
    return out
