"""On the card: a short run of a one-card cell is correct, and the
bfloat16 control at the cell's own size fails its limits. Run on the chip
with ``python -m pytest benchmarks/tests -m card``."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
def test_short_run_is_correct_on_the_card():
    _need_card()
    out = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload",
                          "cornell_mixed.final", "--seed", str(2**33 + 5), "--seconds",
                          "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["metrics"]["Mrays_per_s"]["value"] > 0


@pytest.mark.card
def test_control_fails_at_the_cells_size(tmp_path):
    _need_card()
    out = tmp_path / "cal.json"
    subprocess.run([sys.executable, "-m", "benchmarks.calibrate", "--workload",
                    "cornell_mixed.final", "--seconds", "3", "--seeds", "11",
                    "--control-seeds", "12", "--out", str(out)], cwd=ROOT, check=True,
                   env=dict(os.environ))
    d = json.loads(out.read_text())
    from benchmarks import manifest
    limits = manifest.check("cornell_mixed.final")["limits"]
    assert all(d["lower"][k] <= limits[k] < d["upper"][k] for k in limits), d
