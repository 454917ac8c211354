"""Nothing the benchmark runs loads ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``tpu_pt``, by whole top-level module names; the reference
loads nothing of the port either."""

import json
import os
import pathlib
import subprocess
import sys
import types

import pytest

from benchmarks import run

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_pt"}


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_name_test(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_pt_torch_lookalike", types.ModuleType("x"))
    assert "tpu_pt" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_pt.render", types.ModuleType("tpu_pt.render"))
    assert run.forbidden_modules() == ["tpu_pt"]


@pytest.mark.parametrize("config,check", [
    ("manifest.config('cornell_mixed')", "manifest.check"),
    ("whitted_cases.alpha_shadow()", "whitted_cases.own_check")])
def test_a_whole_cpu_run_loads_none(config, check):
    loaded = _modules_after(
        "import json\n"
        "from benchmarks import manifest, run\n"
        "from benchmarks.tests import whitted_cases\n"
        f"manifest.check = {check}\n"
        "cell = manifest.cell('cornell_mixed.final')\n"
        "traffic = dict(manifest.traffic('final'), width=8, height=8, spp=2, lanes=4096)\n"
        f"line, err, found = run.run_cell(cell, {config}, traffic,"
        " 7, 0.01, True, device='cpu')\n"
        "assert line['correct'] and not found\n"
        "print(json.dumps(line))\n")
    assert "tpu_pt_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _modules_after("import benchmarks.check, benchmarks.calibrate as _\n"
                            "import benchmarks.reference.pathtracer\n"
                            "import benchmarks.reference.scene\n"
                            "import benchmarks.reference.gltf\n"
                            "import benchmarks.reference.whitted\n"
                            "import benchmarks.scenes.gltf_assets\n"
                            "from benchmarks import manifest\n"
                            "manifest.reference({'renderer': 'whitted'})\n")
    assert not loaded & (FORBIDDEN | {"tpu_pt_torch", "tests"})


def test_no_card_no_result(tmp_path):
    out = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload",
                          "cornell_mixed.final", "--seed", str(2**33), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
