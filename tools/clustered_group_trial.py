#!/usr/bin/env python3
"""Lanes a ray of the tree walks (``tpu_pt_torch/csrc/walk.cuh``): the
trial that sets ``clustered.walk_group`` (K6, K6f, K8),
``dense.NEE_WALK_GROUP`` (the fused K5) and ``instanced.walk_group``
(K9).

Each walk is built at every group width G of GROUPS (a template
parameter; its entry points take G as ``group``). Three parts, each
timing every width beside its yardstick, the kernel body the walk
replaced, with every result held bitwise against it:

- ``big``: on the big mesh (``tools/make_assets.py --big``), K6, K6f and
  K8 on chip_smoke.py's rays at each width of WIDTHS: camera and bounce
  rays with every eighth lane parked at 32,768 (the big-mesh frame's
  width), 65,536 (pbr_big's Whitted frame: 262,144 pixels, 4 items a
  lane) and 131,072, and 262,144 unparked rays (a caller's own
  ``closest_hit`` / ``occluded_hit``), against the flat scans, and at
  32,768 rays against the plain versions;
- ``fused``: K5 on the sphere box at FUSED_WIDTHS (65,536 parked, the
  sphere-box frame's lanes; 262,144 parked, chip_smoke.py's kernels
  phase), against the dense body ``closest_nee_full_dense`` and, at
  65,536, the plain version; beside them the walk at its shipped width
  over a kd copy cut as ``clustered.pack_tris_clustered`` cuts the table
  (no top rows: the room-wide triangles fall among the sphere's), the
  layout ``dense.kd_tables`` replaced;
- ``inst``: K9 on the forest and on foliage (kept instanced) at
  INST_WIDTHS (16,384 parked, both frames' lanes; 262,144 unparked),
  against the flat loop ``closest_inst_flat`` and, at 16,384, the plain
  version.

Every width, the shipped choice and the yardstick are timed in turns
(CUDA events), twice over. Prints one JSON line per (kernel, scene, ray
count): the ms of each, the width the package picks there, and the
card's name and power limit.

Run on a machine with a CUDA card, from the repository root:
``python3 tools/clustered_group_trial.py [big] [fused] [inst]`` (all
three when none is named; ~2 minutes with the build).
"""

from __future__ import annotations

import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
GROUPS = (4, 8, 16, 32)
# (label, rays, park every eighth lane?)
WIDTHS = (("32768 parked", 32768, True), ("65536 parked", 65536, True),
          ("131072 parked", 131072, True), ("262144", 262144, False))
FUSED_WIDTHS = (("65536 parked", 65536, True),
                ("262144 parked", 262144, True))
INST_WIDTHS = (("16384 parked", 16384, True), ("262144", 262144, False))


def _time(call, smi, what: dict, picked: int, yardstick: str, extra=()):
    """Every width of GROUPS, the yardstick (``call(None)``) and each
    ``(name, argument)`` of ``extra`` in turns, twice over; prints the JSON
    line."""
    import chip_smoke as cs
    names = [f"G{g}" for g in GROUPS] + [yardstick] + [k for k, _ in extra]
    args = (*GROUPS, None, *(a for _, a in extra))
    times = {k: [] for k in names}
    for _ in range(2):
        for k, g in zip(names, args):
            times[k].append(cs.gpu_ms(lambda g=g: call(g), 10))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    print(json.dumps({**what, "equal": True, "ms": ms, "runs": times,
                      "walk_group": picked, "best": min(ms, key=ms.get),
                      "device": smi}), flush=True)


def _same(out, ref, what: str) -> None:
    import torch
    if not all(torch.equal(a, b) for a, b in zip(out, ref)):
        raise AssertionError(f"{what}: differs")


def fused_part(device, smi) -> None:
    """K5 on the sphere box at every width of GROUPS against its dense
    body."""
    import chip_smoke as cs
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import dense
    scene = tp.load_scene(str(cs.ASSETS / "cornell_box_sphere.obj"),
                          device=device)
    tables, light = dense.prepare(scene), dense.light_vector(scene)
    kd, rows = tables.kd, tables.rows
    # The kd copy without top rows: pack_tris_clustered's rows (column 15
    # the dense row, as in kd_tables) and boxes.
    from tpu_pt_torch.intersect import clustered
    rows0, boxes0 = clustered.pack_tris_clustered(scene)
    no_top = dense.KdTables(rows=rows0, top=0, boxes=boxes0,
                            nodes=clustered.cluster_tree(boxes0),
                            scale=clustered.box_scale(boxes0))
    for label, n, park in FUSED_WIDTHS:
        o, d, shadow = cs._phase3_rays(
            scene, device, 12, rows,
            lambda o, d: dense._closest_plain(o, d, rows, 0.01), n)
        if park:
            (o, d), _ = cs._park((o, d), shadow, cs.PARK_EVERY)
        lz1, lz2 = cs._light_samples(n, 12, device)

        def call(g, o=o, d=d, lz1=lz1, lz2=lz2):
            if g is None:
                return dense.closest_nee_full_dense(o, d, lz1, lz2, rows,
                                                    light, 0.01, 1e16)
            tb = no_top if g == "no top" else kd
            return dense.closest_nee_full(
                o, d, lz1, lz2, tb.rows, tb.top, tb.boxes, tb.nodes, tb.scale,
                light, 0.01, 1e16, dense.NEE_WALK_GROUP if g == "no top"
                else g)
        ref = call(None)
        if n == FUSED_WIDTHS[0][1]:
            _same(ref, dense._closest_nee_plain(o, d, lz1, lz2, rows, rows,
                                                light, 0.01, 1e16, full=True),
                  "K5 dense body against the plain version")
        for g in (*GROUPS, "no top"):
            _same(call(g), ref, f"K5 {g} at {label}")
        _time(call, smi, {"kernel": "K5", "scene": "sphere box",
                          "rays": label}, dense.NEE_WALK_GROUP, "dense",
              extra=(("no top rows", "no top"),))


def inst_part(device, smi) -> None:
    """K9 on the forest and foliage at every width of GROUPS against its
    flat loop."""
    import chip_smoke as cs
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import clustered, instanced
    for scene, mode in (("forest.gltf", "auto"),
                        ("foliage.gltf", "instanced")):
        ws = tp.load_gltf(str(cs.ASSETS / scene), instancing=mode,
                          device=device)
        tb = instanced.prepare(ws.geom, ws.inst)
        args = (tb.tris, tb.boxes, tb.scale, tb.table.rows, tb.table.boxes,
                0.01, 1e16)
        for label, n, park in INST_WIDTHS:
            o, d, shadow = cs._inst_rays(ws, tb, device, 5, n)
            if park:
                (o, d), _ = cs._park((o, d), shadow, cs.PARK_EVERY)

            def call(g, o=o, d=d):
                if g is None:
                    return instanced.closest_inst_flat(o, d, *args)
                return instanced.closest_inst(o, d, *args, tb.tree, g)
            ref = call(None)
            if n == INST_WIDTHS[0][1]:
                _same(ref, instanced._closest_inst_plain(
                    o, d, tb.tris, clustered.CLUSTER, tb.table.rows, 0.01),
                    f"K9 flat loop on {scene} against the plain version")
            for g in GROUPS:
                _same(call(g), ref, f"K9 G{g} on {scene} at {label}")
            _time(call, smi, {"kernel": "K9", "scene": scene, "rays": label},
                  instanced.walk_group(n), "flat")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this trial times the card's kernels")
    import chip_smoke as cs
    from tpu_pt_torch import _kernels
    parts = sys.argv[1:] or ["big", "fused", "inst"]
    device, smi = cs.phase_device()
    _kernels.build()
    if "fused" in parts:
        fused_part(device, smi)
    if "inst" in parts:
        inst_part(device, smi)
    if "big" in parts:
        big_part(device, smi)
    return 0


def big_part(device, smi) -> None:
    """K6, K6f and K8 on the big mesh at every width of GROUPS against
    the flat scans."""
    import torch
    import chip_smoke as cs
    from tpu_pt_torch.intersect import clustered
    big = cs.phase_assets(device)
    tb = clustered.prepare(big)
    table = (tb.rows, tb.boxes, tb.scale)
    tmin = 0.01

    def flat6(o, d):
        return clustered.closest_clustered_flat(o, d, *table, tmin)

    # kernel -> (call(rays, shadow, group): the walk at that width, or the
    # flat scan for None; plain(rays, shadow))
    calls = {
        "K6": (lambda r, s, g: (
            clustered.closest_clustered_flat(*r, *table, tmin) if g is None
            else clustered._launch_lean("closest_clustered", *r, *table,
                                        tmin, clustered.T_FAR, tb.nodes, g)),
               lambda r, s: clustered._closest_clustered_plain(
                   *r, tb.rows, tmin)),
        "K6f": (lambda r, s, g: (
            clustered.closest_clustered_full_flat(*r, *table, tmin, 1e16,
                                                  True) if g is None
            else clustered._launch_full("closest_clustered_full", *r, *table,
                                        tmin, 1e16, True, tb.nodes, g)),
                lambda r, s: clustered._closest_clustered_full_plain(
                    *r, tb.rows, tmin, 1e16, True)),
        "K8": (lambda r, s, g: (
            (clustered.occluded_clustered_flat(*s, *table, tmin),) if g is None
            else (clustered._launch_occluded("occluded_clustered", *s,
                                             *table, tmin, tb.nodes, g),)),
               lambda r, s: (clustered._occluded_clustered_plain(
                   *s, tb.rows, tmin),)),
    }
    for label, n, park in WIDTHS:
        rays = cs._phase3_rays(big, device, 3, tb.rows, flat6, n)
        r, s = (cs._park(rays[:2], rays[2], cs.PARK_EVERY) if park
                else (rays[:2], rays[2]))
        picked = clustered.walk_group(n)
        for kname, (call, plain) in calls.items():
            ref = call(r, s, None)
            if n == cs.N_PLAIN_BIG and not all(
                    torch.equal(a, b) for a, b in zip(ref, plain(r, s))):
                raise AssertionError(f"{kname}: the flat scan differs from "
                                     "the plain version")
            for g in GROUPS:
                _same(call(r, s, g), ref, f"{kname} G{g} at {label}")
            _time(lambda g, call=call: call(r, s, g), smi,
                  {"kernel": kname, "scene": "big mesh", "rays": label},
                  picked, "flat")


if __name__ == "__main__":
    sys.exit(main())
