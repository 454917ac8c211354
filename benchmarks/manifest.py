"""Where the benchmark finds its parts, by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a JSON file of its own (``configs/<config>.json``,
``traffic/<traffic>.json``). A per-layer metric is a module of its own
(``metrics/<name>.py``, a ``read(record)`` function). A cell's
correctness check reads ``checks/<cell>.json`` when there is one, else
``checks/default.json``. A later cell, mix, configuration or metric is
added by new files and new entries only.

A configuration names the program's pipeline that draws it by an
optional key, ``renderer``: ``path`` (when absent) or ``whitted``, as the
program's command line picks them for OBJ and glTF scenes. The renderer
fixes the plain reference that checks it (``RENDERERS``). An unknown value
exits with the valid choices. A Whitted configuration's cell needs a
``checks/<cell>.json`` of its own: the default limits do not catch half of
its samples left out.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "cache"          # generated scenes (listed in .gitignore)


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    bench = manifest() if bench is None else bench
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                     f"({', '.join(w['name'] for w in bench['workloads'])})")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def check(cell_name: str, renderer: str = "path") -> dict:
    path = HERE / "checks" / f"{cell_name}.json"
    if path.exists():
        return _json(path)
    if renderer != "path":
        # A Whitted sample differs from another of its pixel only by the
        # camera ray's jitter, so half of the samples left out moves only
        # the pixels that an edge crosses: a few hundredths of them, under
        # the default mismatch_share.
        raise SystemExit(f"cell {cell_name!r}: a {renderer} configuration needs "
                         f"checks/{cell_name}.json of its own")
    return _json(HERE / "checks" / "default.json")


def data(name: str) -> dict:
    """A data file of the yardstick (``kernels.json``, ``peaks.json``)."""
    return _json(HERE / name)


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(record) -> float | None`` of per-layer metric ``name``
    (``metrics/<name>.py``)."""
    return _module(HERE / "metrics" / f"{name}.py", f"benchmarks_metric_{name}").read


def scene_generator(name: str):
    """The scene generator module ``scenes/<name>.py`` (its ``ensure``)."""
    return _module(HERE / "scenes" / f"{name}.py", f"benchmarks_scene_{name}")


# Each renderer of the program, and the module of reference/ that checks it.
RENDERERS = {"path": "pathtracer", "whitted": "whitted"}


def renderer(config: dict) -> str:
    """The pipeline that draws the configuration: ``path`` or ``whitted``."""
    value = config.get("renderer", "path")
    if value not in RENDERERS:
        raise SystemExit(f"configuration {config.get('name')!r}: no renderer {value!r} "
                         f"({', '.join(RENDERERS)})")
    return value


def reference(config: dict):
    """The plain reference module that checks the configuration, whose
    ``values(scene_path, config, traffic, pixels, frames, device, dtype,
    snapshot_frames)`` gives ``{"values", "snapshot"}``."""
    return importlib.import_module(f".reference.{RENDERERS[renderer(config)]}", __package__)


def per_layer(bench: dict, cell_entry: dict) -> list[dict]:
    """The per-layer metrics that this cell reports."""
    return [m for m in bench["per_layer"]
            if cell_entry["name"] in m.get("workloads", [cell_entry["name"]])]


def end_to_end(bench: dict, cell_entry: dict) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if cell_entry["name"] in m.get("workloads", [cell_entry["name"]])]
