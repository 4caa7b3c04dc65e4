"""The port's hand-written CUDA kernels, their bindings, and beside each its
plain PyTorch version.

Four kernels carry the numerics of the solve (sdpb_tpu/ops/linalg.py
sends every matmul, Cholesky and triangular solve to them):

  * `mp_matmul`            csrc/mp_matmul.cu    <- pallas_kernels.py::_matmul_kernel
  * `mp_cholesky`          csrc/mp_cholesky.cu  <- pallas_kernels.py::_cholesky_kernel
  * `mp_solve_triangular`  csrc/mp_trsm.cu      <- pallas_kernels.py::_trsm_kernel
  * `mp_matmul_wide`       csrc/mp_wide_matmul.cu <- pallas_kernels.py::_matmul_wide_kernel

The first three are built for both MP representations: the classic build
(float64 limbs, csrc/mp.cuh) replaces the `scaled=False` branch of each
Pallas kernel, the scaled build (float32 limbs and an int32 exponent per
element, csrc/mp_scaled.cuh) its `scaled=True` branch.  The wide GEMM
takes two-word MPW operands (ops/mpwide.py, G = 2 words of Kg limbs;
csrc/mp_wide.cuh); the factorizations never see a wide value.

Dispatch is by the device of the operands and nothing else: CUDA tensors
launch the kernel of their representation (a shape, limb count or dtype
the kernel cannot take raises), CPU tensors run the plain version.  There
is no fallback.  Each wrapper counts its launches in `LAUNCHES`, one
counter per (kernel, representation).

The plain versions perform the kernels' exact operation order with the
port's MP ops (`mpfloat.kmul`, the mplist term order; for the wide GEMM
the compact ops of ops/mpwide_kernel.py), so on one device a kernel and
its plain version agree limb for limb.

Build: the CUDA sources are compiled with nvcc at first use, one shared
library per limb count K and representation (-DMP_K=K, -DMP_SCALED=0|1),
into `build/sdpb_tpu_torch/` of the checkout, named by a hash of the
sources and flags; they are bound with ctypes (plain C entry points
returning `cudaGetLastError()`, exponent pointers NULL for classic).  The
wide GEMM has one library per word size Kg (-DMP_WIDE=1 -DMP_SCALED=1
-DMP_K=Kg), built in the same parallel pass.
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
# no contraction (a fused TwoProd or TwoSum loses its error term), and
# IEEE subnormals, division and square root, as the plain versions have
# them on the CPU
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
              "-Xcompiler", "-fPIC")
K_RANGE = range(2, 10)
REPRESENTATIONS = (False, True)     # classic, scaled
WIDE = "wide"                       # the representation key of the wide libraries
WIDE_KG = range(3, 10)              # word sizes of the wide GEMM (Kg = 3 for tests)
CHUNK = 8   # contraction chunk of the matmul (pallas_kernels.py:101)

KERNEL_NAMES = ("mp_matmul", "mp_cholesky", "mp_solve_triangular")
LAUNCHES = {name + suffix: 0 for suffix in ("", "_scaled") for name in KERNEL_NAMES}
LAUNCHES["mp_matmul_wide"] = 0
_LIBS = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    return "w" if rep == WIDE else ("s" if rep else "c")


def library_path(K: int, scaled=False) -> Path:
    """The library of limb count K in a representation: False (classic),
    True (scaled) or WIDE (K = Kg, the wide GEMM)."""
    return BUILD_DIR / f"libmpk_{_source_hash()}_k{K}{_tag(scaled)}.so"


def _defines(K: int, rep) -> list:
    if rep == WIDE:
        return [f"-DMP_K={K}", "-DMP_SCALED=1", "-DMP_WIDE=1"]
    return [f"-DMP_K={K}", f"-DMP_SCALED={int(rep)}"]


def build(Ks=K_RANGE, representations=REPRESENTATIONS, wide_Ks=WIDE_KG) -> list:
    """Compile the libraries that are missing: (K, classic/scaled) for K in
    Ks, (Kg, WIDE) for Kg in wide_Ks; the (source, K, representation)
    objects in parallel, one nvcc each, as many at a time as there are
    cores.  Returns the (K, representation) pairs built."""
    todo = [(K, s) for s in representations for K in Ks
            if not library_path(K, s).exists()]
    todo += [(K, WIDE) for K in wide_Ks if not library_path(K, WIDE).exists()]
    if not todo:
        return todo
    nvcc = _nvcc()
    t0 = time.time()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        def obj(K, s, src):
            return str(Path(tmp) / f"{src}.k{K}{_tag(s)}.o")

        def sources(s):
            return WIDE_SOURCES if s == WIDE else SOURCES

        compiles = [[nvcc, *NVCC_FLAGS, *_defines(K, s), "-c", str(CSRC / src),
                     "-o", obj(K, s, src)] for K, s in todo for src in sources(s)]
        with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
            list(pool.map(_run, compiles))
        for K, s in todo:
            so = Path(tmp) / f"k{K}{_tag(s)}.so"
            _run([nvcc, "-shared", "-o", str(so), *(obj(K, s, src) for src in sources(s))])
            os.replace(so, library_path(K, s))
    print(f"built CUDA kernels for (K, representation) {todo} in "
          f"{time.time() - t0:.1f} s ({BUILD_DIR})", flush=True)
    return todo


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")


def _library(K: int, scaled) -> ctypes.CDLL:
    wide = scaled == WIDE
    if K not in (WIDE_KG if wide else K_RANGE):
        raise ValueError(f"the CUDA kernels take 2 <= K <= 9 limbs (the wide GEMM "
                         f"3 <= Kg <= 9), got K={K}")
    lib = _LIBS.get((K, scaled))
    if lib is None:
        if wide:
            build([], [], [K])
        else:
            build([K], [scaled], [])
        lib = ctypes.CDLL(str(library_path(K, scaled)))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if wide:
            lib.mp_wide_matmul_launch.argtypes = [vp] * 12 + [ci] * 4 + [vp]
            lib.mp_wide_matmul_launch.restype = ci
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


def mp_matmul_wide_plain(a: MPW, b: MPW) -> MPW:
    """Plain version of the wide GEMM on two-word operands [Kg,B,M,Kd] x
    [Kg,B,Kd,N]: the contraction term by term through the cheap-carry
    accumulate wfma_acc_c from a zero accumulator, then wnormalize_c (the
    Pallas kernel's chunk = 1 order)."""
    Kg = a.Kg
    _, B, M, Kd = a.words[0].limbs.shape
    N = b.words[0].limbs.shape[-1]
    acc = wk.wzeros((B, M, N), Kg, a.device)
    for t in range(Kd):
        wa = tuple((w.limbs[..., t:t + 1], w.exp[..., t:t + 1]) for w in a.words)
        wb = tuple((w.limbs[:, :, t:t + 1, :], w.exp[:, t:t + 1, :]) for w in b.words)
        acc = wk.wfma_acc_c(acc, wa, wb, Kg)
    return MPW(MP(*w) for w in wk.wnormalize_c(acc, Kg))


def mp_matmul_wide(a: MPW, b: MPW) -> MPW:
    """Batched two-word MP matmul a [..., M, Kd] @ b [..., Kd, N] (broadcast
    batch); CUDA operands launch the wide GEMM kernel of their word size,
    CPU operands run the plain version."""
    if not (isinstance(a, MPW) and isinstance(b, MPW)):
        raise TypeError(f"mp_matmul_wide takes two MPW, got {type(a).__name__} "
                        f"and {type(b).__name__}")
    if a.G != 2 or b.G != 2:
        raise ValueError(f"the wide GEMM takes two-word operands (G = 2), got G={a.G} "
                         f"and G={b.G}")
    if a.Kg != b.Kg:
        raise ValueError(f"word sizes differ: {a.Kg} vs {b.Kg}")
    a4, b4, unflatten = _canon_wide_pair(a, b)
    if _on_cpu(*a4.words, *b4.words):
        return unflatten(mp_matmul_wide_plain(a4, b4))
    Kg, B, M, Kd = a4.words[0].limbs.shape
    N = b4.words[0].limbs.shape[-1]
    out = [_empty((B, M, N), Kg, True, a4.device) for _ in range(2)]
    if out[0].limbs.numel():
        ptrs = [p for w in (*a4.words, *b4.words, *out) for p in _parts(w)]
        _launch("mp_wide_matmul_launch", Kg, WIDE, a4.device, ptrs, (B, M, Kd, N))
        LAUNCHES["mp_matmul_wide"] += 1
    return unflatten(MPW(out))


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
        resid = _empty((B, n, m), K, b4.scaled, b4.device)
        dinv = _empty((B, n), K, b4.scaled, b4.device)
        _launch("mp_trsm_launch", K, b4.scaled, b4.device,
                (*_parts(t4), *_parts(b4), *_parts(resid), *_parts(dinv), *_parts(X)),
                (B, n, m, int(lower)))
        LAUNCHES[counter("mp_solve_triangular", b4.scaled)] += 1
    return unflatten(X)
