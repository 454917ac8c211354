#!/usr/bin/env python3
"""Multi-GPU benchmark of the port: a 4K frame tile-sharded over a
(tile, spp) mesh of ``torch.distributed`` ranks, one rank per card.

The twin of tools/bench_dist.py (BASELINE.json config 5, "4K frame
tile-sharded over a mesh with psum sample accumulation"). Renders the
mixed-BSDF Cornell box at 3840x2160, 4 spp, depth 8, IS + NEE through
``tpu_pt_torch.dist.make_sharded_renderer`` over ``device_mesh()``: rows
over the ``tile`` axis, samples over the ``spp`` axis, summed by NCCL
``all_reduce``. Frame 0 warms up, frames 1-2 are timed, ending in a sync.

  torchrun --nproc-per-node=N tools/bench_dist_torch.py   # N cards
  python3 tools/bench_dist_torch.py                       # a one-rank world

NCCL puts no two ranks on one card, so a one-card machine runs the (1, 1)
mesh: the whole sharded path, one shard, and no scaling.

Knobs: DIST_W / DIST_H (3840x2160; DIST_SIZE sets both), DIST_SPP (4),
DIST_FRAMES (2), DIST_TILE / DIST_SPP_SHARDS (mesh factors). Rank 0
prints one JSON line: Mrays/s from the summed radiance and shadow rays,
ms, rays and wavefront rounds per frame (rounds summed over the ranks),
the world size and mesh shape, and the card's name and power limit from
nvidia-smi.
"""

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def run(smi: str) -> dict:
    """Render the workload over ``device_mesh()`` in the world this process
    has joined; returns the JSON payload (``smi``: the card's nvidia-smi
    name and power limit)."""
    import torch.distributed
    import tpu_pt_torch as tp
    from tpu_pt_torch import dist
    from tpu_pt_torch.profiling import barrier_rtt, device_barrier
    from tpu_pt_torch.render import CameraArrays

    size = os.environ.get("DIST_SIZE")
    w = int(os.environ.get("DIST_W", size or 3840))
    h = int(os.environ.get("DIST_H", size or 2160))
    spp = int(os.environ.get("DIST_SPP", 4))
    frames = int(os.environ.get("DIST_FRAMES", 2))
    n_tile = os.environ.get("DIST_TILE")
    n_spp = os.environ.get("DIST_SPP_SHARDS")
    mesh = dist.device_mesh(int(n_tile) if n_tile else None,
                            int(n_spp) if n_spp else None)
    n_tile, n_spp = mesh.shape
    # Sharded spp must divide evenly; height must split into row tiles.
    spp = max(spp, n_spp)
    spp -= spp % n_spp
    if h % n_tile:
        h += n_tile - h % n_tile

    device = dist.rank_device(mesh)
    scene = tp.load_scene(os.path.join(REPO, "assets",
                                       "cornell_box_mixed.obj"),
                          device=device)
    cfg = tp.RenderConfig(width=w, height=h, spp=spp, max_depth=8,
                          use_direct_lighting=True,
                          use_importance_sampling=True)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)
    step = dist.make_sharded_renderer(scene, cfg, mesh)
    accum = dist.init_accum_sharded(cfg, mesh)

    t0 = time.perf_counter()
    accum, img, stats = step(cam, 0, accum)
    device_barrier(img)
    warmup_s = time.perf_counter() - t0
    rtt = barrier_rtt(img)

    frame_stats = []
    t0 = time.perf_counter()
    for f in range(1, frames + 1):
        accum, img, stats = step(cam, f, accum)
        frame_stats.append(stats)
    device_barrier(img)
    dt = time.perf_counter() - t0 - rtt

    total_rays = sum(int(s.rays_traced) + int(s.shadow_rays)
                     for s in frame_stats)
    return {
        "metric": f"Mrays/s, {w}x{h} Cornell tile-sharded over "
                  f"{n_tile}x{n_spp} (tile, spp) mesh, 8 bounces, "
                  f"{spp} spp, IS+NEE on",
        "value": round(total_rays / dt / 1e6, 3),
        "unit": "Mrays/s",
        "ms_per_frame": round(dt / frames * 1e3, 2),
        "rays_per_frame": total_rays // frames,
        "rounds_per_frame": sum(int(s.wavefront_iterations)
                                for s in frame_stats) / frames,
        "warmup_s": round(warmup_s, 2),
        "world": torch.distributed.get_world_size(),
        "mesh": [n_tile, n_spp],
        "backend": torch.distributed.get_backend(),
        "card": smi,
    }


def main():
    import torch.distributed
    from tpu_pt_torch import dist
    if "RANK" in os.environ:          # torchrun names the world
        dist.init_multihost()
    else:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_multihost(f"127.0.0.1:{port}", 1, 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    payload = run(smi)
    if torch.distributed.get_rank() == 0:
        print(json.dumps(payload))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
