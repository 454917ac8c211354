"""``BENCHMARK.json`` against the contract's shape: keys, names, units and
the files that each entry names; and a configuration's choice of renderer,
which fixes its reference."""

import json
import re

import numpy as np
import pytest
import torch

from benchmarks import check, manifest, run, session
from benchmarks.reference import pathtracer, scene as ref_scene, whitted
from benchmarks.tests import whitted_cases

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = manifest.manifest()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.rstrip("/").endswith("_torch")
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert _line(m["layer"])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        mine = {m["name"] for m in manifest.end_to_end(BENCH, w)}
        assert "setup_s" in mine and len(mine) >= 2
        assert manifest.per_layer(BENCH, w)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        for w in m.get("workloads", cells):
            reported = manifest.end_to_end(BENCH, manifest.cell(w, BENCH))
            assert m["moves"] in {e["name"] for e in reported}, (m["name"], w)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(cells) // 4)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert entry["file"] == f"benchmarks/configs/{entry['name']}.json"
    cfg = manifest.config(entry["name"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    required = {"scene", "camera", "triangles", "assumed"}
    if manifest.renderer(cfg) == "path":
        required |= {"use_importance_sampling", "use_direct_lighting"}
    assert required <= set(cfg)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    traffic = manifest.traffic(cell["traffic"])
    assert traffic["name"] == cell["traffic"]
    mesh = traffic.get("mesh", [1, 1])
    assert mesh[0] * mesh[1] == cell["chips"] or (cell["chips"] == 1 and "mesh" not in traffic)
    # Every call passes all the lanes: the wavefront the program holds
    # (at most a lane per 8 work items of a card) is the traffic's width.
    items = (traffic["width"] * traffic["height"] // mesh[0]) * (traffic["spp"] // mesh[1])
    assert traffic["lanes"] <= items // 8
    chk = manifest.check(cell["name"])
    assert set(chk["limits"]) == {"mismatch_share", "median_gap"}
    for m in manifest.per_layer(BENCH, cell):
        assert callable(manifest.metric_reader(m["name"]))


def _parent_reference_values(obj_path, config, traffic, pixels, frames, device,
                             dtype=torch.float32, snapshot_frames=0):
    """``check.reference_values`` as it stood before a configuration could
    name its reference, frozen here."""
    scene = ref_scene.load(str(obj_path), device, dtype)
    c = config["camera"]
    cam = pathtracer.Camera(c["eye"], c["lookat"], c["up"], c["fov_y"],
                            traffic["width"] / traffic["height"], device, dtype)
    with torch.no_grad():
        acc, snap = pathtracer.render_pixels(
            scene, cam, pixels, frames, width=traffic["width"],
            height=traffic["height"], spp=traffic["spp"],
            max_depth=traffic["max_depth"],
            importance=config["use_importance_sampling"],
            direct=config["use_direct_lighting"], snapshot_frames=snapshot_frames)
    return {"values": acc.float().cpu().numpy(), "snapshot": snap.float().cpu().numpy()}


@pytest.mark.parametrize("config_name,size,spp,depth", [
    ("cornell_mixed", 20, 3, 8), ("big_mesh", 6, 1, 3)])
def test_absent_keys_keep_todays_path_bitwise(config_name, size, spp, depth):
    config = manifest.config(config_name)
    assert "renderer" not in config and manifest.renderer(config) == "path"
    traffic = dict(manifest.traffic("final"), width=size, height=size, spp=spp,
                   max_depth=depth, lanes=4096)
    args = (session.scene_path(config), config, traffic, np.arange(size * size), [5, 6, 7],
            torch.device("cpu"))
    new = check.reference_values(*args, snapshot_frames=2)
    old = _parent_reference_values(*args, snapshot_frames=2)
    for key in ("values", "snapshot"):
        assert new[key].tobytes() == old[key].tobytes()
    # The program's side: the same step as load_scene and render_frame.
    import tpu_pt_torch as tp
    from tpu_pt_torch import render
    step, accum = session.build(config, traffic, torch.device("cpu"))
    scene = tp.load_scene(str(session.scene_path(config)), device="cpu", build_bvh=False)
    cfg = session.render_config(config, traffic)
    plain = render.init_accum(cfg, device="cpu")
    for k in (5, 6):
        accum, _, _ = step(k, accum)
        plain, _, _ = render.render_frame(
            scene, session.camera(config, traffic, "cpu"), cfg, k, plain)
    assert torch.equal(accum, plain)


def test_an_unknown_renderer_exits_naming_the_choices(tiny):
    config = dict(whitted_cases.alpha_shadow(), renderer="raster")
    cell = manifest.cell("cornell_mixed.final")
    traffic = dict(manifest.traffic("final"), **tiny)
    choices = re.escape("'raster' (path, whitted)")
    with pytest.raises(SystemExit, match=choices):
        run.run_cell(cell, config, traffic, 1, 0.01, False, device="cpu")
    with pytest.raises(SystemExit, match=choices):
        session.build(config, traffic, torch.device("cpu"))
    with pytest.raises(SystemExit, match=choices):
        check.reference_values("unused", config, traffic, [0], [1], torch.device("cpu"))


@pytest.mark.parametrize("renderer,module", [(None, pathtracer), ("path", pathtracer),
                                             ("whitted", whitted)])
def test_the_renderer_fixes_the_reference(renderer, module):
    config = {} if renderer is None else {"renderer": renderer}
    assert manifest.reference(config) is module
    assert set(manifest.RENDERERS) == {"path", "whitted"}


def test_a_path_configuration_states_its_lighting(tiny):
    config = dict(manifest.config("cornell_mixed"))
    del config["use_direct_lighting"]
    with pytest.raises(KeyError, match="use_direct_lighting"):
        session.render_config(config, dict(manifest.traffic("final"), **tiny))
