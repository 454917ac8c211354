#!/usr/bin/env python3
"""Drive tpu_pt_torch's main path once on one CUDA card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, ``nvcc`` (the kernels are built from
``tpu_pt_torch/csrc/`` on first use) and nothing of JAX. Phases, one line
each; any failure raises and exits non-zero before the last line:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: compile and load the CUDA kernels (one nvcc per source, in
   parallel);
3. assets: write the 100k-triangle big mesh (``tools/make_assets.py
   --big``) under build/assets and load it onto the card;
4. kernels: each kernel against its plain PyTorch version on the same
   rays on the card (camera rays plus rays leaving the surfaces they hit,
   and shadow rays from those points to the light), with times of both:
   the dense kernels at 262,144 rays; the clustered kernels on the big
   mesh at the big path's width of 32,768 rays with every eighth lane
   parked as the wavefront parks them, bitwise, timed there and at
   262,144 rays; then bitwise on the exact inputs of one K6 and one K8
   call recorded from a bench_big frame;
5. goldens: the five path-trace golden modes (tools/make_goldens.py:
   128^2, 32 spp, one frame) rendered through the kernels, RMSE < 0.01
   against tests/goldens/;
6. main path: the reference app's launch (512^2, 128 spp, depth 4, IS+NEE,
   mixed Cornell box, 3 progressive frames), bench.py's canonical frame
   (1024^2, 16 spp, depth 8, IS+NEE, frame 0 warm-up, frames 1-4 timed),
   a sphere-box frame (2,264 triangles: the full-carry kernel), and
   tools/bench_big.py's big-mesh frame (512^2, 4 spp, depth 8, IS+NEE,
   frame 0 warm-up, frames 1-2 timed: the clustered kernels), each with
   the kernel launch counters zeroed before and read after;
7. cross-check: a 32^2 x 2 spp, depth-4 big-mesh frame rendered on the
   CPU (plain versions) and on the card (kernels) agrees within
   tests/test_torch_render.py's bound.

The last three lines are the kernels' JSON record, the nvidia-smi line,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

# The port must run without JAX: make any import of it fail loudly.
for _name in ("jax", "jaxlib", "flax", "tpu_pt"):
    sys.modules[_name] = None

REPO = pathlib.Path(__file__).resolve().parent
ASSETS = REPO / "assets"
BUILD_ASSETS = REPO / "build" / "assets"    # generated (gitignored)
GOLDENS = REPO / "tests" / "goldens"

N_RAYS = 262144          # the pixelq wavefront width on the main path
N_PLAIN_BIG = 32768      # the big path's width (262,144 items // 8 lanes)
PARK_EVERY = 8           # every eighth big-mesh lane parked
TOL_T = 1e-4             # |t_kernel - t_plain| bound (pallas_bf.py:28-34)
ROW_AGREE = 0.999        # rows may differ only on shared-edge ties
GOLDEN_RMSE = 0.01       # tests/test_goldens.py bound
GOLDEN_MODES = [         # tools/make_goldens.py MODES
    ("no-importance-no-direct", dict(use_importance_sampling=False,
                                     use_direct_lighting=False)),
    ("importance-no-direct", dict(use_importance_sampling=True,
                                  use_direct_lighting=False)),
    ("importance-with-direct", dict(use_importance_sampling=True,
                                    use_direct_lighting=True)),
    ("3-bounce", dict(use_importance_sampling=True,
                      use_direct_lighting=True, max_depth=3)),
    ("16-bounce", dict(use_importance_sampling=True,
                       use_direct_lighting=True, max_depth=16)),
]
_DENSE = "tpu_pt_torch/csrc/dense_intersect.cu"
_CLUSTERED = "tpu_pt_torch/csrc/clustered_intersect.cu"
KERNELS = {   # wrapper name -> (source, TPU kernel it replaces)
    "closest_lean": (_DENSE, "tpu_pt/intersect/pallas_bf.py:976"),
    "occluded": (_DENSE, "tpu_pt/intersect/pallas_bf.py:1299"),
    "closest_full": (_DENSE, "tpu_pt/intersect/pallas_bf.py:938"),
    "closest_clustered": (_CLUSTERED, "tpu_pt/intersect/pallas_bf.py:1042"),
    "occluded_clustered": (_CLUSTERED, "tpu_pt/intersect/pallas_bf.py:1204"),
}
BIG_MESH = "big_mesh.obj"
BENCH_BIG = dict(width=512, height=512, spp=4, max_depth=8)
# Main-path workloads: (tag, scene, frames rendered, last frames timed,
# config, kernels the run must launch). The reference app's per-launch
# workload (PathTracerMain.cpp:42-59), bench.py's canonical frame
# (bench.py:49-57), the sphere box, whose 2,264 triangles take the
# full-carry kernel, and tools/bench_big.py's frame (bench_big.py:38-41)
# on the 99,968-row big mesh, which takes the clustered kernels (its NEE
# occluder subset keeps 99,908 rows, so shadow rays take K8). All with
# IS + NEE.
MAIN_RUNS = [
    ("reference launch 512^2 x 128 spp, depth 4, mixed",
     "cornell_box_mixed.obj", [0, 1, 2], 3,
     dict(width=512, height=512, spp=128, max_depth=4),
     ("closest_lean", "occluded")),
    ("bench.py 1024^2 x 16 spp, depth 8, mixed",
     "cornell_box_mixed.obj", [0, 1, 2, 3, 4], 4,
     dict(width=1024, height=1024, spp=16, max_depth=8),
     ("closest_lean", "occluded")),
    ("sphere box 512^2 x 16 spp, depth 4",
     "cornell_box_sphere.obj", [0], 1,
     dict(width=512, height=512, spp=16, max_depth=4),
     ("closest_full", "occluded")),
    ("bench_big 512^2 x 4 spp, depth 8, big mesh",
     BIG_MESH, [0, 1, 2], 2, BENCH_BIG,
     ("closest_clustered", "occluded_clustered")),
]
# CPU (plain versions) vs card (kernels) big-mesh frame, and its bound
# (tests/test_torch_render.py).
CROSS_CHECK = dict(width=32, height=32, spp=2, max_depth=4)
PIXEL_TOL, PIXEL_SHARE = 1e-4, 0.01


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def gpu_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    say("device", f"{name} (sm_{cap[0]}{cap[1]}), "
        f"{torch.cuda.device_count()} visible; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a, not sm_{cap}")
    return torch.device("cuda:0"), smi


def phase_build():
    from tpu_pt_torch import _kernels
    t0 = time.perf_counter()
    libs = _kernels.build()
    _kernels._entry_points()
    say("build", f"{len(libs)} libraries in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        log = lib.with_suffix(".log")
        usage = [ln.strip() for ln in (log.read_text().splitlines()
                                       if log.exists() else [])
                 if "registers" in ln or "spill" in ln]
        say("build", f"{lib.name}: " + " | ".join(usage))


def phase_assets(device):
    """Write the big mesh under build/assets and load it onto the card
    (load_scene builds the balanced-kd cluster order with
    median_split_order)."""
    import tpu_pt_torch as tp
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(REPO / "tools" / "make_assets.py"),
                    "--big", "--out", str(BUILD_ASSETS)], check=True,
                   capture_output=True, timeout=600)
    t1 = time.perf_counter()
    scene = tp.load_scene(str(BUILD_ASSETS / BIG_MESH), device=device)
    t2 = time.perf_counter()
    say("assets", f"{BIG_MESH}: {scene.num_tris} triangles "
        f"({scene.num_tris_padded} padded, {scene.num_occluders} NEE "
        f"occluders); written in {t1 - t0:.2f} s, load_scene incl. "
        f"median_split_order {t2 - t1:.2f} s")
    return scene


def _phase3_rays(scene, device, seed: int, rows, closest, n_rays: int):
    """n_rays rays on the card: camera rays through jittered pixels of a
    2h x h grid, then as many leaving the surfaces ``closest(o, d) ->
    (t, packed row of rows)`` hits, in random directions; plus shadow rays
    from those points to the light."""
    import numpy as np
    import torch
    from tpu_pt_torch import cornell_default_camera, rng
    from tpu_pt_torch.render import CameraArrays, camera_rays
    half = n_rays // 2
    h = int(round((half // 2) ** 0.5))
    cam = CameraArrays.from_camera(cornell_default_camera(), device=device)
    pix = torch.arange(half, device=device)
    jx, jy = rng.uniform2(pix, 0, seed, rng.STREAM_JITTER)
    o, d = camera_rays(cam, pix, 2 * h, h, jx, jy)
    t, row = closest(o, d)
    hit = (t < 1e15)[:, None]
    nrm = rows[row.long(), 0:3]
    nrm = torch.where((nrm * d).sum(1, keepdim=True) > 0, -nrm, nrm)
    p = torch.where(hit, o + d * t[:, None] + 1e-3 * nrm, o)
    r = np.random.default_rng(seed)
    rd = torch.as_tensor(r.normal(size=(half, 3)).astype(np.float32),
                         device=device)
    rd = torch.where((rd * nrm).sum(1, keepdim=True) < 0, -rd, rd)
    rd = rd / rd.norm(dim=1, keepdim=True)
    lab = torch.as_tensor(r.random((n_rays, 2)).astype(np.float32),
                          device=device)
    light = scene.light
    lp = light.corner + light.v1 * lab[:, :1] + light.v2 * lab[:, 1:]
    sp = torch.cat([p, p])
    to_l = lp - sp
    dist = to_l.norm(dim=1)
    shadow = (sp.contiguous(), (to_l / dist[:, None]).contiguous(),
              (dist - 0.01).contiguous())
    return torch.cat([o, p]).contiguous(), torch.cat([d, rd]).contiguous(), \
        shadow


def _compare_closest(name, kernel_out, plain_out):
    """Kernel vs plain closest hit: equal hit/miss, t within TOL_T, rows
    equal on >= ROW_AGREE of rays (a mismatch must be a tie within TOL_T),
    equal attributes where the rows agree, nothing non-finite. Returns
    (max |dt|, note)."""
    import torch
    t_k, row_k = kernel_out[0], kernel_out[1]
    t_p, row_p = plain_out[0], plain_out[1]
    for x in kernel_out:
        if x.is_floating_point() and not torch.isfinite(x).all():
            raise AssertionError(f"{name}: NaN or Inf in the kernel output")
    hit_k, hit_p = t_k < 1e15, t_p < 1e15
    if not torch.equal(hit_k, hit_p):
        raise AssertionError(f"{name}: hit/miss differs on "
                             f"{int((hit_k != hit_p).sum())} rays")
    max_dt = float((t_k - t_p).abs().max())
    if max_dt > TOL_T:
        raise AssertionError(f"{name}: max |dt| {max_dt} > {TOL_T}")
    same_row = row_k == row_p
    if float(same_row.float().mean()) < ROW_AGREE:
        raise AssertionError(f"{name}: rows agree on only "
                             f"{float(same_row.float().mean()):.6f}")
    for k_out, p_out, what in zip(kernel_out[2:], plain_out[2:],
                                  ("normal", "mat", "u", "v")):
        mask = same_row if k_out.dim() == 1 else same_row[:, None]
        if not bool(((k_out == p_out) | ~mask).all()):
            raise AssertionError(f"{name}: {what} differs on rays with the "
                                 "same winning row")
    return max_dt, f"{int((~same_row).sum())} row ties"


def _compare_exact(name, kernel_out, plain_out):
    """Kernel vs plain, bit for bit on every output: occlusion flags, or
    closest hits (after the checks of _compare_closest)."""
    import torch
    if isinstance(kernel_out, torch.Tensor):
        err = 0.0
        extra = f"{float(kernel_out.float().mean()):.4f} occluded"
        kernel_out, plain_out = (kernel_out,), (plain_out,)
    else:
        err, extra = _compare_closest(name, kernel_out, plain_out)
    for k, p in zip(kernel_out, plain_out):
        if not torch.equal(k, p):
            raise AssertionError(f"{name}: kernel and plain differ on "
                                 f"{int((k != p).sum())} values")
    return err, extra + ", bitwise equal"


def _park(rays, shadow, every: int):
    """Park every ``every``-th lane as the wavefront parks retired lanes
    and ineligible shadow rays (render.py): origin PARK_COORD, direction
    PARK_DIR, shadow tmax 0."""
    import torch
    from tpu_pt_torch.render import PARK_COORD, PARK_DIR
    o, d = rays
    so, sd, st = shadow
    park = (torch.arange(o.shape[0], device=o.device) % every == 0)[:, None]

    def org(x):
        return torch.where(park, PARK_COORD, x).contiguous()

    def dirs(x):
        return torch.where(park, PARK_DIR, x).contiguous()
    return (org(o), dirs(d)), (org(so), dirs(sd),
                               torch.where(park[:, 0], 0.0, st).contiguous())


def _record_big_calls(big, device):
    """The arguments of one K6 and one K8 call of a bench_big frame (frame
    0, IS + NEE): for each wrapper the first call in which at least one
    lane in PARK_EVERY is parked, so the set holds live and parked lanes."""
    import torch
    from tpu_pt_torch.intersect import clustered
    from tpu_pt_torch.render import PARK_COORD
    picked = {}

    def tap(name, wrapper):
        def call(*args):
            parked = float((args[0][:, 0] == PARK_COORD).float().mean())
            if name not in picked and parked >= 1.0 / PARK_EVERY:
                picked[name] = (tuple(a.clone() if torch.is_tensor(a) else a
                                      for a in args), parked)
            return wrapper(*args)
        return call

    saved = clustered.closest_clustered, clustered.occluded_clustered
    clustered.closest_clustered = tap("closest_clustered", saved[0])
    clustered.occluded_clustered = tap("occluded_clustered", saved[1])
    try:
        _render(big, device, [0], use_direct_lighting=True,
                use_importance_sampling=True, **BENCH_BIG)
    finally:
        clustered.closest_clustered, clustered.occluded_clustered = saved
    for name in ("closest_clustered", "occluded_clustered"):
        if name not in picked:
            raise AssertionError(f"no {name} call of the bench_big frame "
                                 "had parked lanes")
    return picked


def phase_kernels(device, big):
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import clustered, dense, kernel_module
    mixed = tp.load_scene(str(ASSETS / "cornell_box_mixed.obj"), device=device)
    sphere = tp.load_scene(str(ASSETS / "cornell_box_sphere.obj"),
                           device=device)
    tm, ts = dense.prepare(mixed), dense.prepare(sphere)
    records = {}

    def run(name, kernel, plain, rows, compare, n=N_RAYS, reps=20,
            plain_reps=3, at_n_rays=None):
        """Compare kernel() with plain() on the same n rays and time both;
        ``at_n_rays``, when given, is the kernel on N_RAYS rays, timed
        too."""
        out_k = kernel()
        out_p = plain()
        torch.cuda.synchronize()
        err, extra = compare(name, out_k, out_p)
        ms = gpu_ms(kernel, reps)
        plain_ms = gpu_ms(plain, plain_reps)
        rec = dict(rows=rows, rays=n, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms)
        wide = ""
        if at_n_rays is not None:
            rec["ms_at_n_rays"] = gpu_ms(at_n_rays, reps)
            wide = f"; kernel at {N_RAYS} rays {rec['ms_at_n_rays']:.4f} ms"
        records.setdefault(name, []).append(rec)
        say("kernels", f"{name} x {rows} rows: max|err| {err} on {n} rays"
            f" ({extra}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms at "
            f"{n} rays{wide}")

    def plain_dense(rows):
        return lambda o, d: dense._closest_plain(o, d, rows, 0.01)

    o, d, (so, sd, stmax) = _phase3_rays(mixed, device, 1, tm.rows,
                                         plain_dense(tm.rows), N_RAYS)
    lean = tm.rows
    run("closest_lean", lambda: dense.closest_lean(o, d, lean, 0.01),
        lambda: dense._closest_plain(o, d, lean, 0.01), lean.shape[0],
        _compare_closest)

    occ = tm.occ_rows

    def compare_occ(name, k, p):
        if not torch.equal(k, p):
            raise AssertionError(f"{name}: flags differ on "
                                 f"{int((k != p).sum())} rays")
        return 0.0, f"{float(k.float().mean()):.4f} occluded"
    run("occluded", lambda: dense.occluded(so, sd, stmax, occ, 0.01),
        lambda: dense._occluded_plain(so, sd, stmax, occ, 0.01),
        occ.shape[0], compare_occ)

    o2, d2, _ = _phase3_rays(sphere, device, 2, ts.rows,
                             plain_dense(ts.rows), N_RAYS)
    full = ts.rows
    run("closest_full",
        lambda: dense.closest_full(o2, d2, full, 0.01, 1e16, True),
        lambda: dense._closest_plain(o2, d2, full, 0.01, 1e16, True, True),
        full.shape[0], _compare_closest)
    full_m = tm.rows
    run("closest_full",
        lambda: dense.closest_full(o, d, full_m, 0.01, 600.0, True),
        lambda: dense._closest_plain(o, d, full_m, 0.01, 600.0, True, True),
        full_m.shape[0], _compare_closest)

    # The big mesh at the big path's width, N_PLAIN_BIG lanes with one in
    # PARK_EVERY parked: K6 / K8 bitwise against their plain versions
    # (bounce origins from the plain version's hits), both timed there,
    # and the kernels timed at N_RAYS (bounce origins from K6's own hits).
    if kernel_module(big) is not clustered:
        raise AssertionError("the big mesh must take the clustered kernels")
    tb = clustered.prepare(big)
    if tb.occ_rows is not None:
        raise AssertionError("the big mesh's shadow rays must take K8")
    rows, boxes, scale = tb.rows, tb.boxes, tb.scale

    def k6(o, d):
        return clustered.closest_clustered(o, d, rows, boxes, scale, 0.01)

    def k6_plain(o, d):
        return clustered._closest_clustered_plain(o, d, rows, 0.01)

    def k8(o, d, tmax):
        return clustered.occluded_clustered(o, d, tmax, rows, boxes, scale,
                                            0.01)

    def k8_plain(o, d, tmax):
        return clustered._occluded_clustered_plain(o, d, tmax, rows, 0.01)

    rays = _phase3_rays(big, device, 3, rows, k6_plain, N_PLAIN_BIG)
    (ob, db), shadow = _park(rays[:2], rays[2], PARK_EVERY)
    oB, dB, shadow_B = _phase3_rays(big, device, 3, rows, k6, N_RAYS)
    torch.cuda.synchronize()
    run("closest_clustered", lambda: k6(ob, db), lambda: k6_plain(ob, db),
        rows.shape[0], _compare_exact, n=N_PLAIN_BIG, reps=10, plain_reps=2,
        at_n_rays=lambda: k6(oB, dB))
    run("occluded_clustered", lambda: k8(*shadow), lambda: k8_plain(*shadow),
        rows.shape[0], _compare_exact, n=N_PLAIN_BIG, reps=10, plain_reps=2,
        at_n_rays=lambda: k8(*shadow_B))

    # The exact inputs of one K6 and one K8 call of a bench_big frame,
    # through each wrapper and its plain version.
    plain_of = {
        "closest_clustered":
            lambda o, d, rows, boxes, scale, tmin, tmax:
                clustered._closest_clustered_plain(o, d, rows, tmin, tmax),
        "occluded_clustered":
            lambda o, d, tmax, rows, boxes, scale, tmin:
                clustered._occluded_clustered_plain(o, d, tmax, rows, tmin),
    }
    for name, (args, parked) in _record_big_calls(big, device).items():
        out_k = getattr(clustered, name)(*args)
        out_p = plain_of[name](*args)
        torch.cuda.synchronize()
        err, extra = _compare_exact(name, out_k, out_p)
        n = args[0].shape[0]
        records[name].append(dict(rows=rows.shape[0], rays=n,
                                  max_abs_err=err))
        say("kernels", f"{name}: a bench_big call's own {n} rays "
            f"({parked:.4f} parked): max|err| {err} ({extra})")
    return records


def _render(scene, device, frames, **cfg_kw):
    """Render ``frames`` progressive frames; returns (accum, u8, per-frame
    [(seconds, rays, stats)])."""
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch.render import CameraArrays, init_accum, render_frame
    cfg = tp.RenderConfig(**cfg_kw)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)
    accum = init_accum(cfg, device=device)
    out = []
    u8 = None
    for f in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accum, u8, stats = render_frame(scene, cam, cfg, f, accum)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0,
                    int(stats.rays_traced) + int(stats.shadow_rays), stats))
    return accum, u8, out


def _check_frame(tag, accum, per_frame):
    import torch
    from tpu_pt_torch.render import NOT_DONE
    if not bool(torch.isfinite(accum).all()):
        raise AssertionError(f"{tag}: non-finite pixels")
    for _, rays, stats in per_frame:
        if int(stats.done_histogram[NOT_DONE]) != 0:
            raise AssertionError(f"{tag}: NOT_DONE paths remain")
        if rays <= 0:
            raise AssertionError(f"{tag}: no rays traced")


def phase_goldens(device):
    import numpy as np
    import tpu_pt_torch as tp
    from tpu_pt_torch import film
    scene = tp.load_scene(str(ASSETS / "cornell_box_mixed.obj"), device=device)
    worst = 0.0
    for name, overrides in GOLDEN_MODES:
        kw = {**dict(width=128, height=128, spp=32, max_depth=4), **overrides}
        accum, u8, per = _render(scene, device, [0], **kw)
        _check_frame(name, accum, per)
        golden = film.read_png(str(GOLDENS / f"{name}.png"))
        err = film.rmse(tp.image_to_host(u8).astype(np.float32) / 255.0,
                        golden.astype(np.float32) / 255.0)
        say("goldens", f"{name}: RMSE {err:.5f} ({per[0][0] * 1e3:.1f} ms)")
        if not err < GOLDEN_RMSE:
            raise AssertionError(f"{name}: RMSE {err} >= {GOLDEN_RMSE}")
        worst = max(worst, err)
    return worst


def _launch_counters():
    from tpu_pt_torch.intersect import clustered, dense
    return dense.LAUNCHES, clustered.LAUNCHES


def phase_main_path(device, smi, big):
    """Each main-path run with the launch counters zeroed just before it
    and read just after; returns the launches summed per kernel."""
    import tpu_pt_torch as tp
    scenes = {BIG_MESH: big}
    launches = dict.fromkeys(KERNELS, 0)
    results = []
    for tag, scene_file, frames, timed, kw, expect in MAIN_RUNS:
        if scene_file not in scenes:
            scenes[scene_file] = tp.load_scene(str(ASSETS / scene_file),
                                               device=device)
        for counter in _launch_counters():
            counter.update(dict.fromkeys(counter, 0))
        accum, _, per = _render(scenes[scene_file], device, frames,
                                use_direct_lighting=True,
                                use_importance_sampling=True, **kw)
        counts = {k: n for c in _launch_counters() for k, n in c.items()}
        _check_frame(tag, accum, per)
        sec = sum(p[0] for p in per[-timed:])
        rays = sum(p[1] for p in per[-timed:])
        iters = [int(p[2].wavefront_iterations) for p in per[-timed:]]
        say("main", f"{tag}: {sec / timed * 1e3:.1f} ms/frame, "
            f"{rays / sec / 1e6:.3f} Mrays/s over {timed} frame(s), "
            f"{rays // timed} rays/frame, rounds {iters}; launches "
            f"{ {k: n for k, n in counts.items() if n} }; {smi}")
        for k in expect:
            if counts[k] <= 0:
                raise AssertionError(f"{tag}: {k} never launched")
        for k, n in counts.items():
            launches[k] += n
        results.append(dict(workload=tag, ms_per_frame=sec / timed * 1e3,
                            mrays_per_s=rays / sec / 1e6))
    say("main", f"kernel launches on the main path: {launches}")
    return launches, results


def phase_cross_check(big):
    """The big mesh at CROSS_CHECK on the CPU (the kernels' plain versions)
    and on the card (the kernels): the frames agree within the bound of
    tests/test_torch_render.py."""
    out = []
    for scene in (big.to("cpu"), big):
        t0 = time.perf_counter()
        accum, _, per = _render(scene, scene.device, [0],
                                intersector="dense",
                                use_direct_lighting=True,
                                use_importance_sampling=True, **CROSS_CHECK)
        _check_frame(f"cross-check on {scene.device}", accum, per)
        out.append((accum.cpu(), time.perf_counter() - t0))
    (cpu_img, cpu_s), (card_img, card_s) = out
    diff = (cpu_img - card_img).abs().amax(dim=-1)
    share = float((diff > PIXEL_TOL).float().mean())
    say("cross-check", f"big mesh {CROSS_CHECK}: CPU {cpu_s:.1f} s, "
        f"card {card_s:.2f} s; mean |diff| {float(diff.mean()):.3e},"
        f" {share:.4f} of pixels beyond {PIXEL_TOL}, max "
        f"{float(diff.max()):.3e}")
    if not (float(diff.mean()) < PIXEL_TOL and share <= PIXEL_SHARE):
        raise AssertionError("the CPU and card big-mesh frames disagree")


def main() -> int:
    sys.path.insert(0, str(REPO))
    t0 = time.perf_counter()
    device, smi = phase_device()
    phase_build()
    big = phase_assets(device)
    records = phase_kernels(device, big)
    phase_goldens(device)
    launches, _ = phase_main_path(device, smi, big)
    phase_cross_check(big)
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")

    import torch
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        first = records[kname][0]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname],
            max_abs_err=max(r["max_abs_err"] for r in records[kname]),
            ms=first["ms"], plain_ms=first["plain_ms"], rays=first["rays"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
