"""`pvm2sdp`: XML PVM -> sdp.zip (the port of sdpb_tpu/cli/pvm2sdp.py),
with the reference's positional arguments (pvm2sdp/parse_command_line.cxx:
15-19):

    python -m sdpb_tpu_torch.cli.pvm2sdp [bin|json] PRECISION INPUT... OUTPUT

INPUT may be .xml files or .nsv null-separated lists of them (recursive).
The default block format is bin (pvm2sdp/main.cxx:23).
"""
from __future__ import annotations

import sys

import mpmath
import numpy as np


def convert(input_paths, output_path, precision: int,
            block_format: str = "bin", command: str = "") -> int:
    from ..convert.dual_constraint_group import assemble_sdp
    from ..convert.pmp import read_nsv_paths
    from ..convert.xml_input import read_pvm_xml
    from ..io.sdp_zip import write_sdp

    files = []
    for p in input_paths:
        if str(p).endswith(".nsv"):
            files.extend(read_nsv_paths(p))
        else:
            files.append(p)

    with mpmath.workprec(precision):
        objective = None
        pvms = []
        for f in files:
            obj, mats = read_pvm_xml(f)
            if obj:
                objective = obj
            pvms.extend(mats)
        if objective is None:
            raise ValueError("no objective found in any input file")
        K = max(2, -(-precision // 53))
        sdp = assemble_sdp(objective[0], objective[1:], pvms, K, np.float64)
        write_sdp(output_path, sdp, command=command,
                  block_format=block_format, precision=precision)
    return len(pvms)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    block_format = "bin"
    if argv and argv[0] in ("bin", "json"):
        block_format = argv.pop(0)
    if len(argv) < 3:
        print("usage: pvm2sdp [bin|json] PRECISION INPUT... OUTPUT",
              file=sys.stderr)
        return 2
    precision = int(argv[0])
    inputs, output = argv[1:-1], argv[-1]
    n = convert(inputs, output, precision, block_format,
                command="pvm2sdp " + " ".join(argv))
    print(f"wrote {n} blocks to {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
