"""The system under test, driven as a user drives it: load the cell's
scene, warm up one frame at the cell's shapes, then render progressive
frames back to back for the window.

Everything here that touches the program goes through its public entry
points (``load_scene``, ``Camera``, ``CameraArrays.from_camera``,
``RenderConfig``, ``render.render_frame``, ``dist.make_sharded_renderer``)
and reads only its counters (``RenderStats``, the ``LAUNCHES`` dicts of
``tpu_pt_torch.intersect``).
"""

from __future__ import annotations

import time

import torch

from . import manifest, timing, trace


def scene_path(config: dict):
    """The cell's OBJ, written by the benchmark's own generator into its
    cache inside the checkout (once: later runs find it there)."""
    gen = manifest.scene_generator(config["scene"]["generator"])
    return gen.ensure(config["scene"]["name"], manifest.CACHE / "scenes")


def render_config(config: dict, traffic: dict):
    from tpu_pt_torch import RenderConfig
    return RenderConfig(
        width=traffic["width"], height=traffic["height"], spp=traffic["spp"],
        max_depth=traffic["max_depth"], scheduler=traffic["scheduler"],
        lanes=traffic["lanes"], samples_per_item=traffic["samples_per_item"],
        use_direct_lighting=config["use_direct_lighting"],
        use_importance_sampling=config["use_importance_sampling"])


def camera(config: dict, traffic: dict, device):
    from tpu_pt_torch import Camera
    from tpu_pt_torch.render import CameraArrays
    c = config["camera"]
    return CameraArrays.from_camera(
        Camera(eye=c["eye"], lookat=c["lookat"], up=c["up"], fov_y=c["fov_y"],
               aspect=traffic["width"] / traffic["height"]), device=device)


def build(config: dict, traffic: dict, device, mesh=None):
    """``(step(frame, accum) -> (accum, image, stats), accum)``: the
    program's progressive frame step on ``device``; with ``mesh`` the
    sharded step, whose accumulator is this rank's block of rows."""
    import tpu_pt_torch as tp
    from tpu_pt_torch import render
    scene = tp.load_scene(str(scene_path(config)), device=device,
                          build_bvh=False)
    cfg = render_config(config, traffic)
    cam = camera(config, traffic, device)
    if mesh is None:
        def step(k, accum):
            return render.render_frame(scene, cam, cfg, k, accum)
        return step, render.init_accum(cfg, device=device)
    from tpu_pt_torch import dist
    sharded = dist.make_sharded_renderer(scene, cfg, mesh)

    def step(k, accum):
        return sharded(cam, k, accum)
    return step, dist.init_accum_sharded(cfg, mesh)


def launch_counts() -> dict:
    """The program's kernel-launch counters, by ``module.wrapper``."""
    from tpu_pt_torch.intersect import ablations, clustered, dense, instanced
    return {f"{m.__name__.rsplit('.', 1)[1]}.{k}": v
            for m in (dense, clustered, instanced, ablations)
            for k, v in m.LAUNCHES.items()}


def measure(step, accum, first_frame: int, seconds: float, traced: bool,
            snapshot_frames: int, keep_going=lambda go: go):
    """Warm up on frame ``first_frame - 1``, clear the accumulator, then
    render frames ``first_frame, first_frame + 1, ...`` until ``seconds``
    have passed since the first began. ``keep_going(go)`` lets the ranks
    of a sharded step agree on rank 0's decision. The window ends at a
    device barrier. Returns the window's record, the final accumulator
    and a copy of it after the first ``snapshot_frames`` frames (the final
    one when the window rendered fewer)."""
    dev = accum.device
    on_card = dev.type == "cuda"
    t_warm = time.perf_counter()
    accum, img, _ = step(first_frame - 1, accum)
    timing.device_barrier(img)
    t_warm = time.perf_counter() - t_warm
    accum.zero_()
    rtt = timing.barrier_rtt(img)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    rec = {}
    with trace.traced(traced, rec):
        with trace.window():
            t0 = time.perf_counter()
            frames, stats = [], []
            k = first_frame
            while True:
                accum, img, st = step(k, accum)
                frames.append(k)
                stats.append(st)
                k += 1
                if len(frames) == snapshot_frames:
                    snap = accum.clone()
                if not keep_going(time.perf_counter() - t0 < seconds):
                    break
            timing.device_barrier(img)
            t1 = time.perf_counter()
    after = launch_counts()
    rec.update(
        window_start=t0, window_s=t1 - t0 - rtt, frames=frames, warmup_s=t_warm,
        memory_peak_bytes=(torch.cuda.max_memory_allocated(dev) if on_card else 0),
        launches={k: after[k] - before[k] for k in after if after[k] != before[k]},
        **timing.ray_counts(stats))
    return rec, accum, (snap if len(frames) >= snapshot_frames else accum)
