#!/usr/bin/env python3
"""Lanes a ray of the tree walks (``tpu_pt_torch/csrc/walk.cuh``): the
trial that sets ``clustered.walk_group`` (K6, K6f, K8),
``dense.NEE_WALK_GROUP`` (the fused K5), ``dense.full_walk_group`` (K3,
K1 and K4), ``dense.occ_walk_group`` (K2), ``instanced.walk_group`` (K9)
and ``instanced.occluded_walk_group`` (K10).

Each walk is built at every group width G of GROUPS (a template
parameter; its entry points take G as ``group``). Eight parts, each
timing every width, every result held bitwise against the width the
package picks (and that one, at the first ray count of a part, against
the plain version); the parts of K1-K4 also time the dense body, which
stays on the path of the tables without a kd copy:

- ``big``: on the big mesh (``tools/make_assets.py --big``), K6, K6f and
  K8 on chip_smoke.py's rays at each width of WIDTHS: camera and bounce
  rays with every eighth lane parked at 32,768 (the big-mesh frame's
  width), 65,536 (pbr_big's Whitted frame: 262,144 pixels, 4 items a
  lane) and 131,072, and 262,144 unparked rays (a caller's own
  ``closest_hit`` / ``occluded_hit``);
- ``fused``: K5 on the sphere box at FUSED_WIDTHS (65,536 parked, the
  sphere-box frame's lanes; 262,144 parked, chip_smoke.py's kernels
  phase); beside it the walk at its shipped width over a kd copy cut as
  ``clustered.pack_tris_clustered`` cuts the table (no top rows: the
  room-wide triangles fall among the sphere's), the layout
  ``dense.kd_tables`` replaced;
- ``inst``: K9 on the forest and on foliage (kept instanced) at
  INST_WIDTHS (16,384 parked, both frames' lanes; 262,144 unparked);
- ``inst_occ``: K10 on the forest and on foliage's opaque subset (the
  table its shadow rays take) at INST_WIDTHS, shadow rays to the light
  from the points of ``inst`` (on the forest also from above its edge,
  where some reach the light); then every K10 call of one Whitted frame
  of each (frame 0 of chip_smoke.py's run), recorded and replayed: the
  frame's summed device time;
- ``closest_full`` and ``occluded``: K3 (``closest_full_tree``, u and v
  asked for) and K2 (``occluded_tree``, shadow rays from the same points
  to the light) on the sphere box at DENSE_WIDTHS (65,536 parked, the
  sphere-box frame's lanes; 262,144 unparked), beside their dense
  bodies ``closest_full`` / ``occluded``;
- ``lean`` and ``lean_nee``: K1 (``closest_lean_tree``) and K4
  (``closest_nee_lean_tree``, light samples from the counter RNG) on the
  mixed box at LEAN_WIDTHS (65,536 parked; 262,144 parked, the bench
  frame's lanes as chip_smoke.py's kernels phase feeds them; 262,144
  unparked), beside their dense bodies ``closest_lean`` /
  ``closest_nee_lean``; then every call of one bench frame (frame 0 of
  chip_smoke.py's bench.py frame, unfused for K1, ``fused_nee`` for K4),
  recorded and replayed at each width and through the dense body: the
  frame's summed device time.

Every width (and the dense body, where there is one) is timed in turns
(CUDA events), twice over. Prints one JSON line per (kernel, scene, ray
count; or a frame's replayed calls): the ms of each, the width the
package picks there, and the card's name and power limit.

Run on a machine with a CUDA card, from the repository root:
``python3 tools/clustered_group_trial.py [big] [fused] [inst] [inst_occ]
[closest_full] [occluded] [lean] [lean_nee]`` (all eight when none is
named; ~2 minutes with the build).
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
DENSE_WIDTHS = (("65536 parked", 65536, True), ("262144", 262144, False))
LEAN_WIDTHS = (("65536 parked", 65536, True), ("262144 parked", 262144, True),
               ("262144", 262144, False))


def _time(call, smi, what: dict, picked: int, dense: str | None = None,
          extra=()):
    """Every width of GROUPS, the dense body (``call(None)``) when
    ``dense`` names it, and each ``(name, argument)`` of ``extra`` in
    turns, twice over; prints the JSON line."""
    import chip_smoke as cs
    names = [f"G{g}" for g in GROUPS] + ([dense] if dense else []) \
        + [k for k, _ in extra]
    args = (*GROUPS, *([None] if dense else []), *(a for _, a in extra))
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
    """K5 on the sphere box at every width of GROUPS."""
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
            tb = no_top if g == "no top" else kd
            return dense.closest_nee_full(
                o, d, lz1, lz2, tb.rows, tb.top, tb.boxes, tb.nodes, tb.scale,
                light, 0.01, 1e16, dense.NEE_WALK_GROUP if g == "no top"
                else g)
        ref = call(dense.NEE_WALK_GROUP)
        if n == FUSED_WIDTHS[0][1]:
            _same(ref, dense._closest_nee_kd_plain(o, d, lz1, lz2, kd.rows,
                                                   light, 0.01, 1e16),
                  "K5 walk against the plain version")
        for g in (*GROUPS, "no top"):
            _same(call(g), ref, f"K5 {g} at {label}")
        _time(call, smi, {"kernel": "K5", "scene": "sphere box",
                          "rays": label}, dense.NEE_WALK_GROUP,
              extra=(("no top rows", "no top"),))


def inst_part(device, smi) -> None:
    """K9 on the forest and foliage at every width of GROUPS."""
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
                return instanced.closest_inst(o, d, *args, tb.tree, g)
            ref = call(instanced.walk_group(n))
            if n == INST_WIDTHS[0][1]:
                _same(ref, instanced._closest_inst_plain(
                    o, d, tb.tris, clustered.CLUSTER, tb.table.rows, 0.01),
                    f"K9 on {scene} against the plain version")
            for g in GROUPS:
                _same(call(g), ref, f"K9 G{g} on {scene} at {label}")
            _time(call, smi, {"kernel": "K9", "scene": scene, "rays": label},
                  instanced.walk_group(n))


def inst_occ_part(device, smi) -> None:
    """K10 on the forest and on foliage's opaque subset (the table its
    shadow rays take) at every width of GROUPS: at INST_WIDTHS, shadow
    rays to the light from chip_smoke.py's points (from above the forest's
    edge too, where some reach the light), then every K10 call of one
    Whitted frame of each (frame 0 of chip_smoke.py's run), recorded and
    replayed: the frame's summed device time."""
    import chip_smoke as cs
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import clustered, instanced
    for scene, mode in (("forest.gltf", "auto"),
                        ("foliage.gltf", "instanced")):
        ws = tp.load_gltf(str(cs.ASSETS / scene), instancing=mode,
                          device=device)
        tb = instanced.prepare(ws.geom, ws.inst)
        occ = (tb if ws.alpha_occ is None else instanced.prepare(
            ws.alpha_occ.occ_geom, ws.alpha_occ.occ_inst))
        args = (occ.tris, occ.boxes, occ.scale, occ.table.rows,
                occ.table.boxes, 0.01)
        views = [("", cs.WHITTED_VIEW)]
        if scene == "forest.gltf":
            views.append((", from above the edge", cs.FOREST_VIEW))
        for label, n, park in INST_WIDTHS:
            for what, view in views:
                o, d, shadow = cs._inst_rays(ws, tb, device, 5, n, view=view)
                if park:
                    _, shadow = cs._park((o, d), shadow, cs.PARK_EVERY)

                def call(g, shadow=shadow):
                    return (instanced.occluded_inst(*shadow, *args, occ.tree,
                                                    g),)
                ref = call(instanced.occluded_walk_group(n))
                if n == INST_WIDTHS[0][1]:
                    _same(ref, (instanced._occluded_inst_plain(
                        *shadow, occ.tris, clustered.CLUSTER, occ.table.rows,
                        0.01),), f"K10 on {scene} against the plain version")
                for g in GROUPS:
                    _same(call(g), ref, f"K10 G{g} on {scene} at {label}")
                _time(call, smi, {"kernel": "K10", "scene": scene,
                                  "rays": label + what},
                      instanced.occluded_walk_group(n))
        # Every K10 call of one frame, replayed.
        run = next(r for r in cs.WHITTED_RUNS if r[1] == scene)
        calls = _record_calls(instanced, "occluded_inst", lambda: (
            cs._render_whitted(ws, device, cs.WHITTED_VIEW, [0], **run[5])))

        def frame(g):
            return [instanced.occluded_inst(*a[:10], g) for a in calls]
        picked = instanced.occluded_walk_group(calls[0][0].shape[0])
        refs = frame(picked)
        for g in GROUPS:
            for out, ref in zip(frame(g), refs):
                _same((out,), (ref,), f"K10 G{g} on a {scene} frame call")
        _time(frame, smi, {"kernel": "K10", "scene": scene,
                           "rays": f"Whitted frame, {len(calls)} calls"},
              picked)


def dense_walk_part(device, smi, which: str) -> None:
    """K3 (``which`` = "closest_full") or K2 ("occluded") on the sphere box
    at every width of GROUPS against its dense body."""
    import chip_smoke as cs
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import dense
    scene = tp.load_scene(str(cs.ASSETS / "cornell_box_sphere.obj"),
                          device=device)
    tables = dense.prepare(scene)
    rows, occ = tables.rows, tables.occ_rows
    closest = which == "closest_full"
    kd = tables.kd if closest else tables.occ_kd
    walk_args = (kd.rows, kd.top, kd.boxes, kd.nodes, kd.scale, 0.01)
    for label, n, park in DENSE_WIDTHS:
        o, d, shadow = cs._phase3_rays(
            scene, device, 14, rows,
            lambda o, d: dense._closest_plain(o, d, rows, 0.01), n)
        if park:
            (o, d), shadow = cs._park((o, d), shadow, cs.PARK_EVERY)

        def call(g, o=o, d=d, shadow=shadow):
            if closest:
                if g is None:
                    return dense.closest_full(o, d, rows, 0.01, 1e16, True)
                return dense.closest_full_tree(o, d, *walk_args, 1e16, True,
                                               g)
            if g is None:
                return (dense.occluded(*shadow, occ, 0.01),)
            return (dense.occluded_tree(*shadow, *walk_args, g),)
        ref = call(None)
        if n == DENSE_WIDTHS[0][1]:
            plain = (dense._closest_plain(o, d, rows, 0.01, 1e16, True, True)
                     if closest else
                     (dense._occluded_plain(*shadow, occ, 0.01),))
            _same(ref, plain, f"{which} dense body against the plain "
                  "version")
        for g in GROUPS:
            _same(call(g), ref, f"{which} walk G{g} at {label}")
        _time(call, smi, {"kernel": "K3" if closest else "K2",
                          "scene": "sphere box", "rays": label},
              (dense.full_walk_group if closest else dense.occ_walk_group)(n),
              "dense")


def lean_walk_part(device, smi, which: str) -> None:
    """K1 (``which`` = "lean") or K4 ("lean_nee") on the mixed box at every
    width of GROUPS against its dense body."""
    import chip_smoke as cs
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import dense
    scene = tp.load_scene(str(cs.ASSETS / "cornell_box_mixed.obj"),
                          device=device)
    tables, light = dense.prepare(scene), dense.light_vector(scene)
    rows, occ, kd = tables.rows, tables.occ_rows, tables.kd
    walk_args = (kd.rows, kd.top, kd.boxes, kd.nodes, kd.scale)
    subset = (occ, occ.shape[0], None, None, 0.0)
    nee = which == "lean_nee"
    for label, n, park in LEAN_WIDTHS:
        o, d, shadow = cs._phase3_rays(
            scene, device, 16, rows,
            lambda o, d: dense._closest_plain(o, d, rows, 0.01), n)
        if park:
            (o, d), _ = cs._park((o, d), shadow, cs.PARK_EVERY)
        lz1, lz2 = cs._light_samples(n, 16, device)

        def call(g, o=o, d=d, lz1=lz1, lz2=lz2):
            if nee:
                if g is None:
                    return dense.closest_nee_lean(o, d, lz1, lz2, rows, occ,
                                                  light, 0.01)
                return dense.closest_nee_lean_tree(o, d, lz1, lz2, *walk_args,
                                                   *subset, light, 0.01, g)
            if g is None:
                return dense.closest_lean(o, d, rows, 0.01)
            return dense.closest_lean_tree(o, d, *walk_args, 0.01, g)
        ref = call(None)
        if n == LEAN_WIDTHS[0][1]:
            plain = (dense._closest_nee_plain(o, d, lz1, lz2, rows, occ,
                                              light, 0.01) if nee
                     else dense._closest_plain(o, d, rows, 0.01))
            _same(ref, plain, f"{which} dense body against the plain "
                  "version")
        for g in GROUPS:
            _same(call(g), ref, f"{which} walk G{g} at {label}")
        _time(call, smi, {"kernel": "K4" if nee else "K1",
                          "scene": "mixed box", "rays": label},
              dense.full_walk_group(n), "dense")
    # Every call of one bench frame, replayed: the frame's device time.
    name = "closest_nee_lean_tree" if nee else "closest_lean_tree"
    cfg = dict(next(r[4] for r in cs.MAIN_RUNS if r[0] == cs.BENCH_TAG),
               use_direct_lighting=True, use_importance_sampling=True,
               fused_nee=nee)
    calls = _record_calls(dense, name,
                          lambda: cs._render(scene, device, [0], **cfg))
    walk = getattr(dense, name)

    def frame(g):
        return [cs._dense_body_of(name, args, tables) if g is None
                else walk(*args, group=g) for args in calls]
    refs = frame(None)
    for g in GROUPS:
        for out, ref in zip(frame(g), refs):
            _same(out, ref, f"{which} walk G{g} on a bench-frame call")
    _time(frame, smi, {"kernel": "K4" if nee else "K1",
                       "scene": "mixed box",
                       "rays": f"bench frame, {len(calls)} calls"},
          dense.full_walk_group(calls[0][0].shape[0]), "dense")


def _record_calls(mod, name: str, render) -> list:
    """The arguments of every call of wrapper ``name`` of module ``mod``
    while ``render()`` runs, cloned."""
    import torch
    real, calls = getattr(mod, name), []

    def tap(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return real(*args)
    setattr(mod, name, tap)
    try:
        render()
    finally:
        setattr(mod, name, real)
    return calls


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this trial times the card's kernels")
    import chip_smoke as cs
    from tpu_pt_torch import _kernels
    parts = sys.argv[1:] or ["big", "fused", "inst", "inst_occ",
                             "closest_full", "occluded", "lean", "lean_nee"]
    device, smi = cs.phase_device()
    _kernels.build()
    if "fused" in parts:
        fused_part(device, smi)
    if "inst" in parts:
        inst_part(device, smi)
    if "inst_occ" in parts:
        inst_occ_part(device, smi)
    for which in ("closest_full", "occluded"):
        if which in parts:
            dense_walk_part(device, smi, which)
    for which in ("lean", "lean_nee"):
        if which in parts:
            lean_walk_part(device, smi, which)
    if "big" in parts:
        big_part(device, smi)
    return 0


def big_part(device, smi) -> None:
    """K6, K6f and K8 on the big mesh at every width of GROUPS."""
    import torch
    import chip_smoke as cs
    from tpu_pt_torch.intersect import clustered
    big = cs.phase_assets(device)
    tb = clustered.prepare(big)
    table = (tb.rows, tb.boxes, tb.scale)
    tmin = 0.01

    def k6(o, d):
        return clustered._launch_lean("closest_clustered", o, d, *table,
                                      tmin, clustered.T_FAR, tb.nodes)

    # kernel -> (call(rays, shadow, group): the walk at that width;
    # plain(rays, shadow))
    calls = {
        "K6": (lambda r, s, g: clustered._launch_lean(
            "closest_clustered", *r, *table, tmin, clustered.T_FAR,
            tb.nodes, g),
               lambda r, s: clustered._closest_clustered_plain(
                   *r, tb.rows, tmin)),
        "K6f": (lambda r, s, g: clustered._launch_full(
            "closest_clustered_full", *r, *table, tmin, 1e16, True, tb.nodes,
            g),
                lambda r, s: clustered._closest_clustered_full_plain(
                    *r, tb.rows, tmin, 1e16, True)),
        "K8": (lambda r, s, g: (clustered._launch_occluded(
            "occluded_clustered", *s, *table, tmin, tb.nodes, g),),
               lambda r, s: (clustered._occluded_clustered_plain(
                   *s, tb.rows, tmin),)),
    }
    for label, n, park in WIDTHS:
        rays = cs._phase3_rays(big, device, 3, tb.rows, k6, n)
        r, s = (cs._park(rays[:2], rays[2], cs.PARK_EVERY) if park
                else (rays[:2], rays[2]))
        picked = clustered.walk_group(n)
        for kname, (call, plain) in calls.items():
            ref = call(r, s, picked)
            if n == cs.N_PLAIN_BIG and not all(
                    torch.equal(a, b) for a, b in zip(ref, plain(r, s))):
                raise AssertionError(f"{kname}: the walk differs from the "
                                     "plain version")
            for g in GROUPS:
                _same(call(r, s, g), ref, f"{kname} G{g} at {label}")
            _time(lambda g, call=call: call(r, s, g), smi,
                  {"kernel": kname, "scene": "big mesh", "rays": label},
                  picked)


if __name__ == "__main__":
    sys.exit(main())
