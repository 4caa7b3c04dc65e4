"""Checkpoints of the solver state (the port's copy of
sdpb_tpu/solver/checkpoint.py, one device).

A checkpoint is independent of the device layout: per-block host float64
limb stacks keyed by global block index in one `checkpoint_<gen>.npz`
(`y`, and `x_<i>`, `X_even_<i>`, `X_odd_<i>`, `Y_even_<i>`, `Y_odd_<i>`
per block), beside a `checkpoint.json` naming the current and the backup
generation.  So a run resumes under another bucketing, precision or
representation, and either package reads the other's files value for
value.  Kept from the reference: the generation and backup rotation, the
atomic rename of the metadata and the retried writes
(save_checkpoint.cxx:55-119), and starting from a reference text solution
(load_text_checkpoint.cxx:6-44), the --writeSolution=x,y,X,Y files.  The
reference's rank-local binary checkpoints are not read: a directory
holding them stops the run (ROADMAP A22).
"""
from __future__ import annotations

import json
import os
import re
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..io.solution import host_blocks, psd_real_indices
from ..io.text_blocks import read_text_matrix
from ..models.sdp import DeviceSDP
from ..ops import mpfloat as mp, mpwide
from ..ops.mpfloat import MP
from .state import BucketState, SolverState

METADATA = "checkpoint.json"


def save_checkpoint(checkpoint_dir, sdp: DeviceSDP, state: SolverState,
                    options: Optional[dict] = None, verbosity: int = 1,
                    print_fn=print) -> int:
    """Write checkpoint_<gen>.npz and then, atomically, the metadata that
    makes it current and the previous generation the backup; older
    generations are removed.  Returns the generation."""
    ck = Path(checkpoint_dir)
    ck.mkdir(parents=True, exist_ok=True)
    meta_path = ck / METADATA
    generation, backup = 0, None
    if meta_path.exists():
        old = json.loads(meta_path.read_text())
        generation = int(old.get("current", -1)) + 1
        backup = old.get("current")
    if verbosity >= 1:
        print_fn(f"Saving checkpoint to    : {ck}")

    arrays = {"y": mp.host_f64_limbs(state.y)}
    for idx, data in host_blocks(sdp, state).items():
        for name, arr in data.items():
            arrays[f"{name}_{idx}"] = arr

    # up to 10 attempts against a transient file system fault, as the
    # reference makes them (save_checkpoint.cxx:67-101)
    max_retries = 10
    for attempt in range(max_retries):
        try:
            np.savez(ck / f"checkpoint_{generation}.npz", **arrays)
            meta = {"current": generation, "version": 1, "options": options or {}}
            if backup is not None:
                meta["backup"] = backup
            tmp = ck / (METADATA + ".tmp")
            tmp.write_text(json.dumps(meta, indent=1))
            os.replace(tmp, meta_path)
            break
        except OSError as e:
            if attempt == max_retries - 1:
                raise
            if verbosity >= 1:
                print_fn(f"Error writing checkpoint ({e}); retrying "
                         f"({attempt + 1}/{max_retries})")
            time.sleep(min(2.0 ** attempt * 0.1, 10.0))

    keep = {generation, backup}
    for f in ck.glob("checkpoint_*.npz"):
        try:
            gen = int(f.stem.split("_")[1])
        except (IndexError, ValueError):
            continue
        if gen not in keep:
            f.unlink()
    return generation


def _state_from_block_arrays(sdp: DeviceSDP, y_limbs, block_arrays) -> SolverState:
    """A SolverState on sdp's device from {block_index: {x, X_even, ...}}
    float64 limb stacks, laid out in sdp's buckets (padded PSD dims carry
    the identity, as in initial_state) and converted to sdp's
    representation and precision: classic limbs re-distilled to K, scaled
    parts peeled at each value's exponent, wide values word by word."""
    K, scaled, device = sdp.b.K, sdp.b.scaled, sdp.device
    y_limbs = np.asarray(y_limbs, dtype=np.float64)
    Kst = y_limbs.shape[0]      # stored float64 limbs

    def stage(out64: np.ndarray) -> MP:
        if scaled and K > mp.MAX_SCALED_K:
            return mpwide.wide_parts_to_mp(mpwide.f64_limbs_to_wide_parts(out64, K), device)
        if scaled:
            return mp.from_parts(*mp.f64_limbs_to_scaled_parts(out64, K), device)
        return MP(torch.as_tensor(mp.f64_limbs_to_classic(out64, K), device=device))

    buckets = []
    for bk in sdp.buckets:
        sh, B = bk.shape, bk.batch

        def gather_x() -> MP:
            out = np.zeros((Kst, B, sh.schur_size))
            o4 = out.reshape(Kst, B, sh.n_pairs, sh.num_points)
            for i, rs in enumerate(bk.real_sizes):
                arr = np.asarray(block_arrays[rs.block_index]["x"], np.float64)
                if arr.shape != (Kst, sh.n_pairs * rs.num_points):
                    raise RuntimeError(
                        f"Incompatible checkpoint block {rs.block_index} x: expected "
                        f"{(Kst, sh.n_pairs * rs.num_points)}, found {arr.shape}")
                o4[:, i, :, :rs.num_points] = arr.reshape(Kst, sh.n_pairs, rs.num_points)
            return stage(out)

        def gather_psd(name: str) -> MP:
            even = name.endswith("even")
            h_pad = sh.h_even if even else sh.h_odd
            n = sh.dim * h_pad
            out = np.zeros((Kst, B, n, n))
            for i, rs in enumerate(bk.real_sizes):
                h_real = rs.h_even if even else rs.h_odd
                arr = np.asarray(block_arrays[rs.block_index][name], np.float64)
                nr = sh.dim * h_real
                if arr.shape != (Kst, nr, nr):
                    raise RuntimeError(
                        f"Incompatible checkpoint block {rs.block_index} {name}: "
                        f"expected {(Kst, nr, nr)}, found {arr.shape}")
                if nr == n:
                    out[:, i] = arr
                else:
                    ridx = psd_real_indices(sh.dim, h_pad, h_real)
                    out[:, i][np.ix_(range(Kst), ridx, ridx)] = arr
                    pad = np.setdiff1d(np.arange(n), ridx)
                    out[0, i, pad, pad] = 1.0
            return stage(out)

        buckets.append(BucketState(x=gather_x(), X_even=gather_psd("X_even"),
                                   X_odd=gather_psd("X_odd"), Y_even=gather_psd("Y_even"),
                                   Y_odd=gather_psd("Y_odd")))
    return SolverState(y=stage(y_limbs), buckets=buckets)


def load_checkpoint(checkpoint_dir, sdp: DeviceSDP, verbosity: int = 1,
                    print_fn=print) -> Optional[SolverState]:
    """The newest npz generation, else its backup, else a reference text
    checkpoint; None when the directory holds none of these.  A reference
    binary checkpoint (checkpoint_<n>_<rank> files) raises SystemExit: its
    reader is not ported, and the run must not start afresh in its
    place."""
    ck = Path(checkpoint_dir)
    meta_path = ck / METADATA
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        for gen in (meta.get("current"), meta.get("backup")):
            if gen is None:
                continue
            path = ck / f"checkpoint_{gen}.npz"
            if not path.exists():
                continue
            if verbosity >= 1:
                print_fn(f"Loading binary checkpoint from : {path}")
            with np.load(path) as data:
                blocks: dict = {}
                for key in data.files:
                    if key != "y":
                        name, idx = key.rsplit("_", 1)
                        blocks.setdefault(int(idx), {})[name] = data[key]
                return _state_from_block_arrays(sdp, data["y"], blocks)
    if ck.is_dir() and any(re.fullmatch(r"checkpoint_\d+_\d+", f.name)
                           for f in ck.iterdir() if f.is_file()):
        raise SystemExit(
            f"{ck} holds the reference's rank-local binary checkpoint "
            f"(checkpoint_<n>_<rank>), whose reader is not ported to PyTorch "
            f"(ROADMAP A22); resume from a --writeSolution=x,y,X,Y text "
            f"checkpoint or an npz checkpoint instead")
    if (ck / "x_0.txt").exists():
        return load_text_checkpoint(ck, sdp, verbosity, print_fn)
    return None


def load_text_checkpoint(directory, sdp: DeviceSDP, verbosity: int = 1,
                         print_fn=print) -> SolverState:
    """A reference-format text solution (x_<i>.txt, y.txt,
    X_matrix_<2i+p>.txt, Y_matrix_<2i+p>.txt) as the starting state
    (load_text_checkpoint.cxx:6-44), read as float64 limbs carrying the
    current precision's whole mantissa."""
    directory = Path(directory)
    if verbosity >= 1:
        print_fn(f"Loading text checkpoint from : {directory}")
    p = 24 if sdp.b.scaled else 53
    K = -(-(p * sdp.b.K) // 53) + 1
    blocks: dict = {}
    y = None
    for bk in sdp.buckets:
        sh = bk.shape
        for rs in bk.real_sizes:
            idx = rs.block_index
            entry = {"x": read_text_matrix(directory / f"x_{idx}.txt", K,
                                           expect_shape=(sh.n_pairs * rs.num_points, 1))[:, :, 0]}
            if y is None:
                y = read_text_matrix(directory / "y.txt", K,
                                     expect_shape=(sdp.dual_dim, 1))[:, :, 0]
            for parity, name, size in ((0, "even", sh.dim * rs.h_even),
                                       (1, "odd", sh.dim * rs.h_odd)):
                for mat in ("X", "Y"):
                    entry[f"{mat}_{name}"] = np.zeros((K, 0, 0)) if size == 0 else \
                        read_text_matrix(directory / f"{mat}_matrix_{2 * idx + parity}.txt",
                                         K, expect_shape=(size, size))
            blocks[idx] = entry
    return _state_from_block_arrays(sdp, y, blocks)
