"""Whitted configurations that no cell of ``BENCHMARK.json`` names yet: the
small scenes of the CPU tests, the limits that a Whitted cell's own
``checks/<cell>.json`` would set, builds that force ``load_gltf``'s
geometry route, and the provisional foliage window that the card runs
through ``run.run_cell``:

    python3 -c "import sys; from benchmarks.tests import whitted_cases as w; \\
        sys.exit(w.main(sys.argv[1:]))" [--seed <n>] [--seconds <s>] [--trace 0|1] \\
        [--instancing auto|instanced|flatten] [--trees <n>]
"""

from __future__ import annotations

import argparse
import json
import sys

UP = [0.0, 1.0, 0.0]


# The limits that a Whitted cell's own checks/<cell>.json would set, from
# the provisional foliage window's readings on the card (PERF.md §6): sound
# runs read a mismatch_share of 0-0.00098 on 10 seeds, half of the samples
# left out 0.042-0.047 (under the default 0.25), the bfloat16 control
# 0.40-0.42.
CHECK = {"pixels": 2048, "snapshot_frames": 4,
         "limits": {"mismatch_share": 0.01, "median_gap": 0.001}}


def own_check(cell_name: str, renderer: str = "path") -> dict:
    """``manifest.check`` for the cells here, which have no file of their
    own: :data:`CHECK`."""
    return CHECK


def build_instanced(config, traffic, device, mesh=None):
    """``session.build`` with the scene loaded by ``load_gltf(instancing=
    "instanced")``: the two-level route whatever the scene's size."""
    return _forced(config, traffic, device, mesh, "instanced")


def build_flatten(config, traffic, device, mesh=None):
    """``session.build`` with the scene loaded by ``load_gltf(instancing=
    "flatten")``: every instance baked into one triangle table."""
    return _forced(config, traffic, device, mesh, "flatten")


def _forced(config, traffic, device, mesh, instancing):
    from benchmarks import session
    from tpu_pt_torch import whitted
    from tpu_pt_torch.scene.gltf import load_gltf
    scene = load_gltf(str(session.scene_path(config)), instancing=instancing, device=device)
    return session.steps(scene, whitted.render_whitted_frame, config, traffic, device, mesh)


FACTORIES = {"auto": "benchmarks.session:build",
             "instanced": "benchmarks.tests.whitted_cases:build_instanced",
             "flatten": "benchmarks.tests.whitted_cases:build_flatten"}


def config(name: str, scene: dict, eye, lookat, fov_y: float, triangles: int) -> dict:
    return dict(name=name, scene=scene, renderer="whitted", triangles=triangles,
                camera=dict(eye=eye, lookat=lookat, up=UP, fov_y=fov_y))


def foliage_small() -> dict:
    """Twelve trees of the foliage asset; two in view, with their shadows."""
    return config("foliage_12", {"generator": "gltf_assets", "name": "foliage", "n_trees": 12},
                  [64.0, 8.0, 50.0], [76.0, 3.5, 63.0], 40.0, 386)


def forest_small() -> dict:
    """Twelve trees of the forest asset; three in view, with their shadows."""
    return config("forest_12", {"generator": "gltf_assets", "name": "forest", "n_trees": 12},
                  [72.0, 12.0, 28.0], [92.0, 4.0, 55.0], 40.0, 11810)


def alpha_shadow() -> dict:
    """The fractional-shadow scene: textured BLEND, textured MASK and
    untextured BLEND quads and their shadows."""
    return config("alpha_shadow", {"generator": "gltf_assets", "name": "alpha_shadow"},
                  [0.0, 8.0, 6.5], [0.0, 0.3, 0.0], 45.0, 14)


def foliage(n_trees: int = 300) -> dict:
    """The foliage asset (300 trees unless ``n_trees`` says otherwise),
    framed as the program's command line frames the 300-tree asset, which
    has no camera (its world box's centre from (0.7, 0.5, 0.9) box
    diagonals away, 35 degrees; the flattened scene's box, which "auto"
    loads at this size; the ground plane sets it at any tree count)."""
    return config("foliage", {"generator": "gltf_assets", "name": "foliage",
                              "n_trees": n_trees},
                  [185.31470108032227, 138.13174891471863, 239.5907974243164],
                  [-4.299571990966797, 2.6929824352264404, -4.198982238769531], 35.0,
                  2 + 32 * n_trees)


CELL = {"name": "foliage.final", "config": "foliage", "traffic": "foliage_final",
        "chips": 1, "why": "1024^2, 4 spp, depth 8: the Whitted round, alpha-masked shadows"}
TRAFFIC = {"name": "foliage_final", "width": 1024, "height": 1024, "spp": 4, "max_depth": 8,
           "scheduler": "pixelq", "samples_per_item": 1, "lanes": 524288}


def main(argv=None) -> int:
    """One provisional foliage window through ``run.run_cell``, judged by
    :data:`CHECK`; prints its result line. ``--instancing`` other than
    ``auto`` forces the loader's route. A traced window reports every
    per-layer metric of ``BENCHMARK.json`` but the roofline share, whose
    byte count takes each call at the traffic's lanes, which Whitted's
    shadow calls are not."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2**33 + 27)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--instancing", default="auto", choices=list(FACTORIES))
    ap.add_argument("--trees", type=int, default=300)
    args = ap.parse_args(argv)
    from benchmarks import manifest, run
    run._cache_env()
    manifest.check = own_check
    manifest.per_layer = lambda bench, cell: [
        m for m in bench["per_layer"] if m["name"] != "intersect_roofline_pct"]
    line, err, found = run.run_cell(CELL, foliage(args.trees), TRAFFIC, args.seed, args.seconds,
                                    bool(args.trace), factory=FACTORIES[args.instancing])
    print(json.dumps(line), flush=True)
    for e in err:
        print(e, file=sys.stderr)
    return 3 if found else 0
