#!/usr/bin/env python3
"""Multi-card check of ``tpu_pt_torch.dist``: bench.py's frame sharded over
the cards of one host, held against one card's ``render_frame`` and timed
beside it.

  torchrun --nproc-per-node=N tools/dist_scaling_torch.py

For the default mesh of N ranks (``device_mesh()``), tile-only (N, 1) and
spp-only (1, N), it renders bench.py's frame (the mixed box at 1024 x
1024, 16 spp, depth 8, IS + NEE) for frames 0-1 through
``make_sharded_renderer`` and gathers the accumulator after each frame;
rank 0 holds it against ``render_frame``'s two frames on its own card,
within tests/test_dist.py:55's 1e-5 (each rank's pixelq queue adds a
pixel's samples in its own order) with equal counts. Rank 0 prints one
JSON line per mesh: ms of frame 1 sharded (host clock, from a barrier to
a barrier after the sync, so the slowest rank's time) and on one card,
their ratio, the largest difference, and the cards' names and power
limits from nvidia-smi. Every rank raises when a check fails.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BENCH = dict(width=1024, height=1024, spp=16, max_depth=8,
             use_direct_lighting=True, use_importance_sampling=True)
TOL = 1e-5
FRAMES = 2


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, device, smi: str) -> list:
    """The check in the world this process has joined, on ``cfg`` (a
    RenderConfig); returns rank 0's JSON payloads (empty elsewhere)."""
    import numpy as np
    import torch
    import torch.distributed as tdist
    import tpu_pt_torch as tp
    from tpu_pt_torch import dist
    from tpu_pt_torch.render import CameraArrays, init_accum, render_frame

    rank, world = tdist.get_rank(), tdist.get_world_size()
    scene = tp.load_scene(os.path.join(REPO, "assets",
                                       "cornell_box_mixed.obj"),
                          device=device)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)
    ref = []
    if rank == 0:
        accum = init_accum(cfg, device=device)
        for f in range(FRAMES):
            _sync(device)
            t0 = time.perf_counter()
            accum, _, stats = render_frame(scene, cam, cfg, f, accum)
            _sync(device)
            ref.append((accum.cpu().clone().numpy(),
                        time.perf_counter() - t0, stats))
    tdist.barrier()

    shapes = [tuple(dist.mesh_shape(world))]
    shapes += [s for s in ((world, 1), (1, world)) if s not in shapes]
    payloads = []
    for shape in shapes:
        mesh = dist.device_mesh(*shape)
        step = dist.make_sharded_renderer(scene, cfg, mesh)
        accum = dist.init_accum_sharded(cfg, mesh)
        worst, bad, secs = 0.0, [], []
        for f in range(FRAMES):
            tdist.barrier()
            t0 = time.perf_counter()
            accum, _, stats = step(cam, f, accum)
            _sync(device)
            tdist.barrier()
            secs.append(time.perf_counter() - t0)
            full = dist.gather_frame(accum, mesh)
            if rank:
                continue
            want, _, want_stats = ref[f]
            worst = max(worst, float(np.abs(full - want).max()))
            if not np.allclose(full, want, rtol=TOL, atol=TOL):
                bad.append(f"frame {f}: max |diff| {worst}")
            for k in ("rays_traced", "shadow_rays", "done_histogram"):
                if not bool((getattr(stats, k).cpu()
                             == getattr(want_stats, k).cpu()).all()):
                    bad.append(f"frame {f}: {k}")
        failed = torch.tensor([len(bad)], device=device)
        tdist.broadcast(failed, src=0)
        if int(failed):
            raise AssertionError(f"mesh {shape}: {bad or 'rank 0 failed'}")
        if rank == 0:
            payloads.append({
                "metric": f"ms of frame 1, {cfg.width}x{cfg.height} mixed "
                          f"Cornell, {cfg.spp} spp, depth {cfg.max_depth}, "
                          f"IS+NEE, sharded over {shape[0]}x{shape[1]} "
                          "(tile, spp) against one card",
                "world": world, "mesh": list(shape),
                "backend": tdist.get_backend(),
                "sharded_ms": round(secs[-1] * 1e3, 2),
                "one_card_ms": round(ref[-1][1] * 1e3, 2),
                "speedup": round(ref[-1][1] / secs[-1], 3),
                "max_abs_diff": worst, "tolerance": TOL, "card": smi})
    return payloads


def main():
    import torch
    import torch.distributed as tdist
    import tpu_pt_torch as tp
    from tpu_pt_torch import dist
    dist.init_multihost()
    smi = "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines())
    device = torch.device("cuda", torch.cuda.current_device())
    for payload in run(tp.RenderConfig(**BENCH), device, smi):
        print(json.dumps(payload), flush=True)
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
