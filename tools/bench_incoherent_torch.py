#!/usr/bin/env python3
"""Incoherent-wavefront intersection microbench of the PyTorch + CUDA port
(the counterpart of ``tools/bench_incoherent.py``).

The renderer's own wavefronts are coherent; a batch of rays a user hands
to ``closest_hit`` / ``occluded_hit`` need not be. This bench builds the
worst case, origins uniform in the box of the scene's triangle vertices
with uniform-sphere directions and tmax 1e4, and times every scheduler of
the clustered closest hit and any-hit on it through the entry points
``clustered.closest_hit`` / ``occluded_hit``, each selected by its
variable: K6 / K8 (default, the tree walk), K7 / K8b (``TPT_INKB=1``), K11
(``TPT_SEED=1``, no prediction known), K12 (``TPT_STREAM=1``), K13
(``TPT_CBIN=1``), K14 (``TPT_BINNED=1``, the workload it was written for),
K15 serial (``TPT_GRP=1``) and bundled (``TPT_GRP=2``, "K15b"). The rays
come from ``numpy.random.default_rng(0)``; the
JAX tool draws from ``jax.random.PRNGKey(0)``, which gives other numbers
from the same distributions, so the two tools' rays differ ray by ray.

Times are device times from CUDA events, not the host clock. Each path is
timed in turn with the default one (default, path, path, default), since
the host's speed drifts within a run; the schedule builds of K12-K15
(``stream_candidates``, ``cbin_pairs``, ``_pair_schedule``, the group
lists) and their kernels are also timed apart.
Every path's result must equal the default path's, bit for bit.

Knobs: INC_RAYS (262144), INC_SCENE (assets/big_mesh.obj, written by
``tools/make_assets.py --big``), INC_REPS (3), INC_UV (1; 0 asks for no
u, v). Run on a machine with a CUDA device, from the repository root:
``python3 tools/bench_incoherent_torch.py``. Prints one JSON line per
path, with the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LATE = [("K14", {"TPT_BINNED": "1"}), ("K15", {"TPT_GRP": "1"}),
        ("K15b", {"TPT_GRP": "2"})]
CLOSEST_PATHS = [("K6", {}), ("K7", {"TPT_INKB": "1"}),
                 ("K11", {"TPT_SEED": "1"}), ("K12", {"TPT_STREAM": "1"}),
                 ("K13", {"TPT_CBIN": "1"})] + LATE
OCCLUDED_PATHS = [("K8", {}), ("K8b", {"TPT_INKB": "1"}),
                  ("K12", {"TPT_STREAM": "1"}), ("K13", {"TPT_CBIN": "1"})] \
    + LATE
DISPATCH = ("TPT_INKB", "TPT_SEED", "TPT_STREAM", "TPT_CBIN", "TPT_LEAN_BIG",
            "TPT_LEAN_UV", "TPT_SORT_KEY", "TPT_CBIN_OCC", "TPT_BINNED",
            "TPT_GRP")


@contextlib.contextmanager
def _env(variables):
    """The dispatch variables cleared, then ``variables`` set, for the
    block."""
    saved = {k: os.environ.get(k) for k in DISPATCH}
    for k in DISPATCH:
        os.environ.pop(k, None)
    os.environ.update(variables)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def make_rays(scene, n: int, device, seed: int = 0):
    """(origins [n, 3], dirs [n, 3], tmax [n]) on ``device``: origins
    uniform in the box of the valid triangles' vertices, directions
    uniform on the sphere, tmax 1e4."""
    import numpy as np
    import torch
    valid = scene.tri_valid.cpu().numpy() > 0
    v0, e1, e2 = (getattr(scene, k).cpu().numpy()[valid]
                  for k in ("tri_v0", "tri_e1", "tri_e2"))
    corners = np.concatenate([v0, v0 + e1, v0 + e2])
    lo, hi = corners.min(0), corners.max(0)
    rng = np.random.default_rng(seed)
    p = rng.random((n, 3), dtype=np.float32) * (hi - lo) + lo
    d = rng.normal(size=(n, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    return t(p), t(d), torch.full((n,), 1e4, dtype=torch.float32,
                                  device=device)


def _ms(fn, reps: int) -> float:
    """Mean device time of fn() over ``reps`` calls (CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _parts(tables, o, d, tmax, name: str, occluded: bool, reps: int) -> dict:
    """The schedule build and the kernel of K12-K15, timed apart: the two
    steps the paths themselves run (``ablations.stream_steps`` /
    ``cbin_steps`` / ``binned_steps`` / ``grp_steps``; K15's under the
    variables of the path, which pick the body)."""
    from tpu_pt_torch.intersect import ablations
    table = (tables.rows, tables.boxes, tables.scale)
    bound = tmax if occluded else 1e16
    if name == "K12":
        _, build, kernel = ablations.stream_steps(o, d, bound, *table, 0.01,
                                                  occluded)
        lists = schedule = build()
        extra = dict(listed_boxes_per_tile=float(lists[2].float().mean()),
                     boxes=int(tables.boxes.shape[0]))
    elif name == "K13":
        _, build, kernel = ablations.cbin_steps(o, d, bound, *table, 0.01,
                                                occluded)
        schedule = build()
        _, jtab, _, incomplete, _ = schedule
        extra = dict(jobs=int((jtab >= 0).sum()), job_cap=int(jtab.shape[0]),
                     incomplete_share=float(incomplete.float().mean()))
    elif name == "K14":
        _, build, kernel = ablations.binned_steps(o, d, bound, *table, 0.01,
                                                  occluded)
        schedule = build()
        live = schedule.tile_sid < tables.boxes.shape[0]
        extra = dict(pairs=int((schedule.pair_ray >= 0).sum()),
                     tiles=int(live.sum()), tile_cap=int(live.shape[0]),
                     overflow_share=float(schedule.overflow.float().mean()))
    elif name in ("K15", "K15b"):
        _, build, kernel = ablations.grp_steps(o, d, bound, *table, 0.01,
                                               occluded)
        lists = schedule = build()
        extra = dict(listed_boxes_per_group=float(lists[2].float().mean()),
                     boxes=int(tables.boxes.shape[0]))
    else:
        return {}
    kernel(schedule)
    return dict(build_ms=_ms(build, reps),
                kernel_ms=_ms(lambda: kernel(schedule), reps), **extra)


def run(scene, n: int, reps: int, want_uv: bool, device, say=None,
        smi=None):
    """Time every path on ``n`` incoherent rays; returns one payload dict
    per path. Raises if a path's result differs from the default path's.
    ``smi`` is the card's name and power limit as nvidia-smi gives them
    (asked for here when None)."""
    import torch
    from tpu_pt_torch.intersect import clustered, kernel_module
    if kernel_module(scene) is not clustered:
        raise SystemExit("the scene is too small for the clustered kernels")
    tables = clustered.prepare(scene)
    o, d, tmax = make_rays(scene, n, device)
    unknown = torch.full((n,), clustered.SLAB_UNKNOWN, dtype=torch.int32,
                         device=device)
    if smi is None:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]

    def closest():
        h = clustered.closest_hit(tables, o, d, want_uv=want_uv, pred=unknown)
        return h.t, h.tri, h.mat

    # The clustered table for the shadow rays too, not K2's subset.
    whole = dataclasses.replace(tables, occ_rows=None)

    def occluded():
        return (clustered.occluded_hit(whole, o, d, tmax),)

    out = []
    for what, fn, paths in (("closest", closest, CLOSEST_PATHS),
                            ("occluded", occluded, OCCLUDED_PATHS)):
        with _env({}):
            base = fn()                                 # also warms up
        share = float((base[0] < 1e15).float().mean()) if what == "closest" \
            else float(base[0].float().mean())
        for name, variables in paths:
            with _env(variables):
                got = fn()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, base)):
                    raise AssertionError(
                        f"incoherent {what}: {name} differs from the "
                        f"default path")
                with _env({}):
                    b0 = _ms(fn, reps)
                p0, p1 = _ms(fn, reps), _ms(fn, reps)
                with _env({}):
                    b1 = _ms(fn, reps)
                parts = _parts(tables, o, d, tmax, name, what == "occluded",
                               reps)
            ms = 0.5 * (p0 + p1)
            payload = {
                "metric": f"incoherent {what} {name}, {n} rays, "
                          f"{scene.num_tris_padded} padded tris",
                "value": n / ms / 1e3, "unit": "Mrays/s", "ms": ms,
                "ms_runs": [p0, p1], "default_ms_runs": [b0, b1],
                "variables": variables, "want_uv": want_uv,
                ("hit_share" if what == "closest" else "occluded_share"):
                    share,
                "equal_to_default": True, **parts, "device": smi}
            out.append(payload)
            if say is not None:
                say(payload)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this bench times the card's "
                         "kernels")
    import tpu_pt_torch as tp
    obj = os.environ.get("INC_SCENE",
                         os.path.join(REPO, "assets", "big_mesh.obj"))
    if not os.path.exists(obj):
        subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "make_assets.py"),
                        "--big", "--out", os.path.dirname(obj)], check=True)
    scene = tp.load_scene(obj, device="cuda")
    run(scene, int(os.environ.get("INC_RAYS", 262144)),
        int(os.environ.get("INC_REPS", 3)),
        os.environ.get("INC_UV", "1") == "1", torch.device("cuda"),
        say=lambda payload: print(json.dumps(payload), flush=True))


if __name__ == "__main__":
    main()
