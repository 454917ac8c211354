"""A configuration, a traffic mix, a check and a per-layer metric that a
later change adds are found by name from new files alone."""

import json
import shutil

from benchmarks import manifest


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    here = tmp_path / "benchmarks"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns("cache", "__pycache__"))
    bench = manifest.manifest()
    (here / "configs" / "new_scene.json").write_text(json.dumps(
        dict(manifest.config("cornell_mixed"), name="new_scene")))
    (here / "traffic" / "new_mix.json").write_text(json.dumps(
        dict(manifest.traffic("launch"), name="new_mix", spp=64)))
    (here / "checks" / "new_scene.new_mix.json").write_text(json.dumps(
        {"pixels": 64, "snapshot_frames": 2,
         "limits": {"mismatch_share": 0.5, "median_gap": 0.01}}))
    (here / "metrics" / "new_metric.py").write_text(
        "def read(record):\n    return 2.0 * record['frames']\n")
    bench["workloads"].append({"name": "new_scene.new_mix", "config": "new_scene",
                               "traffic": "new_mix", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "round",
                               "moves": "Mrays_per_s", "workloads": ["new_scene.new_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(manifest, "HERE", here)
    monkeypatch.setattr(manifest, "ROOT", tmp_path)

    bench = manifest.manifest()
    cell = manifest.cell("new_scene.new_mix", bench)
    assert manifest.config(cell["config"])["name"] == "new_scene"
    assert manifest.traffic(cell["traffic"])["spp"] == 64
    assert manifest.check(cell["name"])["pixels"] == 64
    assert manifest.check("cornell_mixed.final")["pixels"] == 2048   # the default
    assert "new_metric" in [m["name"] for m in manifest.per_layer(bench, cell)]
    assert manifest.metric_reader("new_metric")({"frames": 3}) == 6.0
    assert manifest.scene_generator("make_assets").SCENES
