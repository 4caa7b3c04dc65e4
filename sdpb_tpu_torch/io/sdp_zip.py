"""Reader and writer of the SDPB input format, sdp.zip or a plain
directory (the port's copy of sdpb_tpu/io/sdp_zip.py; the reader takes
zip and tar, not 7z).

  control.json        {"num_blocks": J, "command": ...}
  objectives.json     {"constant": str, "b": [str]}
  block_info_<j>.json {"dim": m_j, "num_points": n_j}
  block_data_<j>.json {"bilinear_bases_even": [[str]],
                       "bilinear_bases_odd": [[str]], "c": [str], "B": [[str]]}
  block_data_<j>.bin  the reference's boost binary layout (io/sdpb_bin.py)

All numbers are decimal strings (or binary big floats) at the producer's
precision, parsed exactly into K-limb host arrays.
"""
from __future__ import annotations

import io
import json
import os
import tarfile
import zipfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..utils.strings import strs_to_limbs


@dataclass
class BlockData:
    """One PMP block's data as host limb arrays (limbs-first layout)."""
    index: int
    dim: int
    num_points: int
    bases_even: np.ndarray  # [K, h_e, num_points]
    bases_odd: np.ndarray   # [K, h_o, num_points]  (h_o may be 0)
    c: np.ndarray           # [K, P_j]
    B: np.ndarray           # [K, P_j, N]


@dataclass
class SDPData:
    """A whole SDP problem on the host: objectives and blocks."""
    objective_const: np.ndarray  # [K]
    b: np.ndarray                # [K, N]
    blocks: List[BlockData] = field(default_factory=list)

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def dual_dim(self) -> int:
        return self.b.shape[1]


class _ArchiveSource:
    """Files inside a zip or tar archive, or a directory."""

    def __init__(self, path):
        self.path = Path(path)
        if self.path.is_dir():
            self.kind = "dir"
        elif zipfile.is_zipfile(self.path):
            self.kind = "zip"
            self.zf = zipfile.ZipFile(self.path)
        elif tarfile.is_tarfile(self.path):
            self.kind = "tar"
            self.tf = tarfile.open(self.path)
            self.members = {m.name.lstrip("./"): m
                            for m in self.tf.getmembers() if m.isfile()}
        else:
            raise RuntimeError(f"{self.path}: not a directory, zip or tar archive")

    def read(self, name: str) -> bytes:
        if self.kind == "dir":
            return (self.path / name).read_bytes()
        if self.kind == "zip":
            return self.zf.read(name)
        return self.tf.extractfile(self.members[name]).read()

    def exists(self, name: str) -> bool:
        if self.kind == "dir":
            return (self.path / name).exists()
        if self.kind == "zip":
            return name in self.zf.NameToInfo
        return name in self.members


def read_sdp(path, K: int, np_dtype=np.float64) -> SDPData:
    """Load an SDPB-format problem into K-limb host arrays."""
    src = _ArchiveSource(path)
    num_blocks = int(json.loads(src.read("control.json"))["num_blocks"])
    obj = json.loads(src.read("objectives.json"))
    objective_const = strs_to_limbs([obj["constant"]], K, np_dtype)[:, 0]
    b = strs_to_limbs(list(obj["b"]), K, np_dtype)
    N = b.shape[1]

    blocks = []
    for j in range(num_blocks):
        info = json.loads(src.read(f"block_info_{j}.json"))
        dim, num_points = int(info["dim"]), int(info["num_points"])
        if src.exists(f"block_data_{j}.json"):
            data = json.loads(src.read(f"block_data_{j}.json"))
            blocks.append(_block_from_json(j, dim, num_points, data, N, K, np_dtype))
        elif src.exists(f"block_data_{j}.bin"):
            from .sdpb_bin import parse_block_data_bin

            blocks.append(parse_block_data_bin(
                src.read(f"block_data_{j}.bin"), j, dim, num_points, N, K, np_dtype))
        else:
            raise FileNotFoundError(f"block_data_{j}.(json|bin) not found in {path}")
    return SDPData(objective_const=objective_const, b=b, blocks=blocks)


def _block_from_json(j, dim, num_points, data, N, K, np_dtype) -> BlockData:
    def mat(rows):
        if len(rows) == 0:
            return np.zeros((K, 0, num_points), dtype=np_dtype)
        flat = [x for row in rows for x in row]
        return strs_to_limbs(flat, K, np_dtype).reshape(K, len(rows), len(rows[0]))

    c = strs_to_limbs(list(data["c"]), K, np_dtype)
    Brows = data["B"]
    B = strs_to_limbs([x for row in Brows for x in row], K, np_dtype).reshape(
        K, len(Brows), N)
    P_j = num_points * dim * (dim + 1) // 2
    if c.shape[1] != P_j or B.shape[1] != P_j:
        raise ValueError(f"block {j}: c {c.shape}, B {B.shape}, expected {P_j} rows")
    return BlockData(index=j, dim=dim, num_points=num_points,
                     bases_even=mat(data["bilinear_bases_even"]),
                     bases_odd=mat(data["bilinear_bases_odd"]), c=c, B=B)


# Writing (the sdp2input and pvm2sdp output), after the reference's
# write_sdpb_input_files.cxx: a zip that stores (no compression),
# control and objectives first, then each block's files.


def write_sdp(path, sdp: SDPData, command: str = "", block_format: str = "json",
              precision: Optional[int] = None):
    """Write an sdp.zip (a path ending in .zip) or a directory.
    block_format 'json' or 'bin', the reference's two Block_File_Formats
    (pvm2sdp defaults to bin, pvm2sdp/main.cxx:23)."""
    from ..utils.strings import limbs_to_str as s

    def rows(a):  # [K, h, w] -> h lists of w strings
        return [[s(a[:, r, c]) for c in range(a.shape[2])] for r in range(a.shape[1])]

    path = Path(path)
    files = [("control.json", json.dumps(
        {"num_blocks": sdp.num_blocks, "command": command}, indent=2)),
        ("objectives.json", json.dumps({
            "constant": s(sdp.objective_const),
            "b": [s(sdp.b[:, i]) for i in range(sdp.b.shape[1])],
        }, indent=1))]
    for blk in sdp.blocks:
        files.append((f"block_info_{blk.index}.json", json.dumps(
            {"dim": blk.dim, "num_points": blk.num_points})))
        if block_format == "bin":
            from .sdpb_bin import write_block_data_bin

            mant = 24 if blk.c.dtype == np.float32 else 53
            prec = precision or mant * blk.c.shape[0]
            files.append((f"block_data_{blk.index}.bin",
                            write_block_data_bin(blk, prec)))
        else:
            data = {"bilinear_bases_even": rows(blk.bases_even),
                    "bilinear_bases_odd": rows(blk.bases_odd),
                    "c": [s(blk.c[:, i]) for i in range(blk.c.shape[1])],
                    "B": rows(blk.B)}
            files.append((f"block_data_{blk.index}.json", json.dumps(data)))

    if str(path).endswith(".zip"):
        with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as zf:
            for name, content in files:
                zf.writestr(name, content)
    else:
        os.makedirs(path, exist_ok=True)
        for name, content in files:
            if isinstance(content, bytes):
                (path / name).write_bytes(content)
            else:
                (path / name).write_text(content)


def entries(source) -> dict:
    """{name: bytes} of an sdp.zip (a path or its bytes) or a directory, in
    the zip's order (a directory's sorted), with control.json's `command`
    (which names the program that wrote it) emptied where the file is in
    write_sdp's layout: two inputs that these equal hold the same files."""
    if isinstance(source, (bytes, bytearray)):
        source = io.BytesIO(source)
    elif Path(source).is_dir():
        return {name: _blank_command(name, (Path(source) / name).read_bytes())
                for name in sorted(p.name for p in Path(source).iterdir())}
    with zipfile.ZipFile(source) as zf:
        return {name: _blank_command(name, zf.read(name)) for name in zf.namelist()}


def _blank_command(name: str, data: bytes) -> bytes:
    if name == "control.json":
        doc = json.loads(data)
        if data == json.dumps(doc, indent=2).encode():
            return json.dumps(dict(doc, command=""), indent=2).encode()
    return data
