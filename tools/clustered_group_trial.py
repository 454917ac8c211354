#!/usr/bin/env python3
"""Lanes a ray of the clustered tree walk (K6, K6f, K8 of
``tpu_pt_torch/csrc/clustered_intersect.cu``): the trial that sets
``clustered.walk_group``.

The walk is built at every group width G of GROUPS (a template parameter;
its entry points take G as ``group``). On the big mesh
(``tools/make_assets.py --big``) each width's K6, K6f and K8 run on
chip_smoke.py's rays at each width of WIDTHS: camera and bounce rays with
every eighth lane parked at 32,768 (the big-mesh frame's width), 65,536
(pbr_big's Whitted frame: 262,144 pixels, 4 items a lane) and 131,072,
and 262,144 unparked rays (a caller's own ``closest_hit`` /
``occluded_hit``). Each result is held bitwise against the flat scan (the
yardstick kernels of the same file) and, at 32,768 rays, against the plain
versions; then every width, the shipped choice and the flat scan are timed
in turns (CUDA events), twice over. Prints one JSON line per (kernel, ray
count): the ms of each, the width ``walk_group`` picks there, and the
card's name and power limit.

Run on a machine with a CUDA card, from the repository root:
``python3 tools/clustered_group_trial.py`` (~1 minute with the build).
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this trial times the card's kernels")
    import chip_smoke as cs
    from tpu_pt_torch import _kernels
    from tpu_pt_torch.intersect import clustered
    device, smi = cs.phase_device()
    _kernels.build()
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
                out = call(r, s, g)
                if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                    raise AssertionError(f"{kname} G{g} at {label}: differs "
                                         "from the flat scan")
            names = [f"G{g}" for g in GROUPS] + ["flat"]
            times = {k: [] for k in names}
            for _ in range(2):
                for k, g in zip(names, (*GROUPS, None)):
                    times[k].append(cs.gpu_ms(lambda g=g: call(r, s, g), 10))
            ms = {k: sum(v) / len(v) for k, v in times.items()}
            print(json.dumps({
                "kernel": kname, "rays": label, "equal": True, "ms": ms,
                "runs": times, "walk_group": picked,
                "best": min(ms, key=ms.get), "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
