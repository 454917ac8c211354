#!/usr/bin/env python3
"""Drive tpu_pt_torch's main path once on one CUDA card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, ``nvcc`` (the kernels are built from
``tpu_pt_torch/csrc/`` on first use) and nothing of JAX. Phases, one line
each; any failure raises and exits non-zero before the last line:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: compile and load the CUDA kernels;
3. kernels: each kernel against its plain PyTorch version on the same
   rays on the card (262,144 rays: camera rays plus rays leaving the
   surfaces they hit), with times of both;
4. goldens: the five path-trace golden modes (tools/make_goldens.py:
   128^2, 32 spp, one frame) rendered through the kernels, RMSE < 0.01
   against tests/goldens/;
5. main path: the reference app's launch (512^2, 128 spp, depth 4, IS+NEE,
   mixed Cornell box, 3 progressive frames), bench.py's canonical frame
   (1024^2, 16 spp, depth 8, IS+NEE, frame 0 warm-up, frames 1-4 timed),
   and a sphere-box frame (2,264 triangles: the full-carry kernel), with
   the kernel launch counters zeroed before and read after.

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
GOLDENS = REPO / "tests" / "goldens"

N_RAYS = 262144          # the pixelq wavefront width on the main path
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
KERNELS = {   # wrapper name -> (TPU kernel it replaces)
    "closest_lean": "tpu_pt/intersect/pallas_bf.py:976",
    "occluded": "tpu_pt/intersect/pallas_bf.py:1299",
    "closest_full": "tpu_pt/intersect/pallas_bf.py:938",
}
SOURCE = "tpu_pt_torch/csrc/dense_intersect.cu"
# Main-path workloads: (tag, scene, frames rendered, last frames timed,
# config). The reference app's per-launch workload (PathTracerMain.cpp:42-59),
# bench.py's canonical frame (bench.py:49-57), and the sphere box, whose
# 2,264 triangles take the full-carry kernel. All with IS + NEE.
MAIN_RUNS = [
    ("reference launch 512^2 x 128 spp, depth 4, mixed",
     "cornell_box_mixed.obj", [0, 1, 2], 3,
     dict(width=512, height=512, spp=128, max_depth=4)),
    ("bench.py 1024^2 x 16 spp, depth 8, mixed",
     "cornell_box_mixed.obj", [0, 1, 2, 3, 4], 4,
     dict(width=1024, height=1024, spp=16, max_depth=8)),
    ("sphere box 512^2 x 16 spp, depth 4",
     "cornell_box_sphere.obj", [0], 1,
     dict(width=512, height=512, spp=16, max_depth=4)),
]


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
    lib = _kernels.build()
    _kernels._library()
    log = lib.with_suffix(".log")
    usage = [ln.strip() for ln in (log.read_text().splitlines()
                                   if log.exists() else [])
             if "registers" in ln or "spill" in ln]
    say("build", f"{lib.name} in {time.perf_counter() - t0:.2f} s; "
        + " | ".join(usage))


def _phase3_rays(scene, device, seed: int):
    """N_RAYS rays on the card: camera rays through jittered pixels of a
    512 x 256 grid, then as many leaving the surfaces they hit in random
    directions; plus shadow rays from those points to the light."""
    import numpy as np
    import torch
    from tpu_pt_torch import cornell_default_camera, rng
    from tpu_pt_torch.intersect import dense
    from tpu_pt_torch.render import CameraArrays, camera_rays
    half = N_RAYS // 2
    cam = CameraArrays.from_camera(cornell_default_camera(), device=device)
    pix = torch.arange(half, device=device)
    jx, jy = rng.uniform2(pix, 0, seed, rng.STREAM_JITTER)
    o, d = camera_rays(cam, pix, 512, 256, jx, jy)
    tables = dense.prepare(scene)
    t, row = dense._closest_plain(o, d, tables.rows, 0.01)
    hit = (t < 1e15)[:, None]
    nrm = tables.rows[row.long(), 0:3]
    nrm = torch.where((nrm * d).sum(1, keepdim=True) > 0, -nrm, nrm)
    p = torch.where(hit, o + d * t[:, None] + 1e-3 * nrm, o)
    r = np.random.default_rng(seed)
    rd = torch.as_tensor(r.normal(size=(half, 3)).astype(np.float32),
                         device=device)
    rd = torch.where((rd * nrm).sum(1, keepdim=True) < 0, -rd, rd)
    rd = rd / rd.norm(dim=1, keepdim=True)
    lab = torch.as_tensor(r.random((N_RAYS, 2)).astype(np.float32),
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


def phase_kernels(device):
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import dense
    mixed = tp.load_scene(str(ASSETS / "cornell_box_mixed.obj"), device=device)
    sphere = tp.load_scene(str(ASSETS / "cornell_box_sphere.obj"),
                           device=device)
    tm, ts = dense.prepare(mixed), dense.prepare(sphere)
    records = {}

    def run(name, kernel, plain, rows, compare, reps=20, plain_reps=3):
        out_k = kernel()
        out_p = plain()
        torch.cuda.synchronize()
        err, extra = compare(name, out_k, out_p)
        ms = gpu_ms(kernel, reps)
        plain_ms = gpu_ms(plain, plain_reps)
        records.setdefault(name, []).append(
            dict(rows=rows, max_abs_err=err, ms=ms, plain_ms=plain_ms))
        say("kernels", f"{name} {N_RAYS} rays x {rows} rows: max|err| {err}"
            f" ({extra}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    o, d, (so, sd, stmax) = _phase3_rays(mixed, device, seed=1)
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

    o2, d2, _ = _phase3_rays(sphere, device, seed=2)
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


def phase_main_path(device, smi):
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import dense
    scenes = {}
    for k in dense.LAUNCHES:
        dense.LAUNCHES[k] = 0
    results = []
    for tag, scene_file, frames, timed, kw in MAIN_RUNS:
        if scene_file not in scenes:
            scenes[scene_file] = tp.load_scene(str(ASSETS / scene_file),
                                               device=device)
        accum, _, per = _render(scenes[scene_file], device, frames,
                                use_direct_lighting=True,
                                use_importance_sampling=True, **kw)
        _check_frame(tag, accum, per)
        sec = sum(p[0] for p in per[-timed:])
        rays = sum(p[1] for p in per[-timed:])
        iters = [int(p[2].wavefront_iterations) for p in per[-timed:]]
        say("main", f"{tag}: {sec / timed * 1e3:.1f} ms/frame, "
            f"{rays / sec / 1e6:.3f} Mrays/s over {timed} frame(s), "
            f"{rays // timed} rays/frame, rounds {iters}; {smi}")
        results.append(dict(workload=tag, ms_per_frame=sec / timed * 1e3,
                            mrays_per_s=rays / sec / 1e6))
    launches = dict(dense.LAUNCHES)
    say("main", f"kernel launches on the main path: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k}: no launch on the main path")
    return launches, results


def main() -> int:
    sys.path.insert(0, str(REPO))
    device, smi = phase_device()
    phase_build()
    records = phase_kernels(device)
    phase_goldens(device)
    launches, _ = phase_main_path(device, smi)

    import torch
    kernels = []
    for kname, replaces in KERNELS.items():
        first = records[kname][0]
        kernels.append(dict(
            name=kname, route="cuda", source=SOURCE, replaces=replaces,
            launches=launches[kname],
            max_abs_err=max(r["max_abs_err"] for r in records[kname]),
            ms=first["ms"], plain_ms=first["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
