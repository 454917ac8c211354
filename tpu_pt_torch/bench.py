"""Headline benchmark of the port: Mrays/s on the Cornell box (the
counterpart of the repository's ``bench.py``).

The canonical workload: the mixed-BSDF Cornell scene at 1024 x 1024, 16
spp, depth 8, importance sampling and NEE on, the ``pixelq`` scheduler;
frame 0 warms up, frames 1-4 are timed. ``--device cpu`` shrinks it to
256 x 256, 4 spp, 2 frames so that it stays runnable without a card. The
``BENCH_SCENE``, ``BENCH_SIZE``, ``BENCH_SPP``, ``BENCH_FRAMES``,
``BENCH_DEPTH`` and ``BENCH_SCHED`` variables override the workload. Ray
counts come from the renderer's telemetry (``RenderStats``): radiance rays
of live lanes plus NEE shadow rays, so masked-out lanes are not counted.

Run as ``python -m tpu_pt_torch.bench [--device cpu]``. Prints one JSON
line: ``metric``, ``value`` (Mrays/s), ``unit``, ``ms_per_frame``,
``rays_per_frame`` and ``device`` (the card's name, or ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="tpu_pt_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    device = torch.device(ap.parse_args(argv).device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card "
                         "(--device cpu for the shrunk CPU run)")

    import tpu_pt_torch as tp
    from tpu_pt_torch.profiling import barrier_rtt, device_barrier
    from tpu_pt_torch.render import CameraArrays, init_accum, render_frame

    obj = os.environ.get("BENCH_SCENE",
                         str(REPO / "assets" / "cornell_box_mixed.obj"))
    if not os.path.exists(obj):
        subprocess.run([sys.executable, str(REPO / "tools" / "make_assets.py")],
                       check=True)
    scene = tp.load_scene(obj, device=device)
    scene_name = ("Cornell (mixed BSDF)" if obj.endswith("cornell_box_mixed.obj")
                  else os.path.basename(obj))

    size = int(os.environ.get("BENCH_SIZE", 1024 if on_card else 256))
    spp = int(os.environ.get("BENCH_SPP", 16 if on_card else 4))
    frames = int(os.environ.get("BENCH_FRAMES", 4 if on_card else 2))
    depth = int(os.environ.get("BENCH_DEPTH", 8))
    sched = os.environ.get("BENCH_SCHED", "pixelq")
    cfg = tp.RenderConfig(width=size, height=size, spp=spp, max_depth=depth,
                          scheduler=sched, use_direct_lighting=True,
                          use_importance_sampling=True)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)

    accum = init_accum(cfg, device=device)
    accum, img, _ = render_frame(scene, cam, cfg, 0, accum)      # warm-up
    device_barrier(img)
    rtt = barrier_rtt(img)

    # Time frames 1..N and sum their ray counts (the RNG is keyed by frame,
    # so Russian roulette, and the ray count, differ per frame). The stats
    # stay on the device until the clock stops.
    frame_stats = []
    t0 = time.perf_counter()
    for f in range(1, frames + 1):
        accum, img, stats = render_frame(scene, cam, cfg, f, accum)
        frame_stats.append(stats)
    device_barrier(img)
    dt = time.perf_counter() - t0 - rtt

    total_rays = sum(int(s.rays_traced) + int(s.shadow_rays)
                     for s in frame_stats)
    print(json.dumps({
        "metric": f"Mrays/s, {size}x{size} {scene_name}, {depth} bounces, "
                  f"{spp} spp, IS+NEE on",
        "value": round(total_rays / dt / 1e6, 3),
        "unit": "Mrays/s",
        "ms_per_frame": round(dt / frames * 1e3, 2),
        "rays_per_frame": total_rays // frames,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
    }))


if __name__ == "__main__":
    main()
