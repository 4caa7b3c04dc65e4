"""The port's sdpb CLI in three words on the CPU:
`python -m sdpb_tpu_torch.cli.sdpb --arithmetic scaled --precision 440
--device cpu` (19 float32 limbs: three words of 7) for one iteration of a
small random SDP, the factor pinned at 7 limbs (3 refinement passes): the
three-word banner, the iteration, out.txt at the digits of the run's 21
limbs (504 bits: 152 digits), y.txt.  A file of its own: the run takes
about two minutes on one core, since every three-word sum and product is
thousands of torch ops here (on the card each is one kernel).  A factor of
3 limbs takes 7 refinement passes and ~3 minutes; one of 9 limbs the plain
factorizations' minutes.
"""
import os
import subprocess
import sys
from pathlib import Path

from sdpb_tpu.io.sdp_zip import write_sdp
from sdpb_tpu.models.synthetic import random_sdp

from test_torch_slice import _out_values

FACTOR = "7"
REPO = Path(__file__).resolve().parents[1]


def test_three_word_cli_on_cpu(tmp_path):
    write_sdp(tmp_path / "sdp.zip", random_sdp(num_blocks=2, dim=1, num_points=3,
                                                dual_dim=2, K=10, seed=3))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "sdpb_tpu_torch.cli.sdpb", "--device", "cpu",
         "--arithmetic", "scaled", "-s", str(tmp_path / "sdp.zip"),
         "-o", str(tmp_path / "out"), "-c", str(tmp_path / "ck"), "--timingRun", "never",
         "--precision", "440", "--maxIterations", "1",
         "--initialMatrixScalePrimal", "1e2", "--initialMatrixScaleDual", "1e2",
         "--factorLimbs", FACTOR],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=900)
    assert proc.returncode == 0, proc.stderr
    assert "precision       : 440 bits (3 words × 7 scaled float32 limbs)" in proc.stdout
    assert "maxIterations exceeded" in proc.stdout
    out = _out_values(tmp_path / "out")
    assert len(out["primalObjective"].lstrip("-").split("e")[0]) - 1 == 152
    assert (tmp_path / "out" / "y.txt").read_text().splitlines()[0] == "2 1"
