"""The system under test, driven as a user drives it: load the cell's
scene, warm up one frame at the cell's shapes, then render progressive
frames back to back for the window.

Everything here that touches the program goes through its public entry
points and reads only its counters (``RenderStats``, the ``LAUNCHES``
dicts of ``tpu_pt_torch.intersect``). The entry points are ``Camera``,
``CameraArrays.from_camera``, ``RenderConfig``, ``render.init_accum`` and
``dist.make_sharded_renderer`` for every configuration; then, by the
configuration's ``renderer``, ``load_scene`` and ``render.render_frame``
(``path``), or ``scene.gltf.load_gltf`` with the command line's
``instancing="auto"`` and ``whitted.render_whitted_frame`` (``whitted``),
as the program's command line picks them for OBJ and glTF scenes.
"""

from __future__ import annotations

import time

import torch

from . import manifest, timing, trace


def scene_path(config: dict):
    """The cell's scene file, written by the benchmark's own generator into
    its cache inside the checkout (once: later runs find it there). Keys of
    the ``scene`` entry past ``generator`` and ``name`` are the generator's
    parameters."""
    scene = config["scene"]
    gen = manifest.scene_generator(scene["generator"])
    params = {k: v for k, v in scene.items() if k not in ("generator", "name")}
    return gen.ensure(scene["name"], manifest.CACHE / "scenes", **params)


def render_config(config: dict, traffic: dict):
    """The frame's ``RenderConfig``; a path-tracer configuration states its
    two lighting toggles, and Whitted, which has neither, leaves them off."""
    from tpu_pt_torch import RenderConfig
    toggles = {} if manifest.renderer(config) == "whitted" else {
        k: config[k] for k in ("use_direct_lighting", "use_importance_sampling")}
    return RenderConfig(
        width=traffic["width"], height=traffic["height"], spp=traffic["spp"],
        max_depth=traffic["max_depth"], scheduler=traffic["scheduler"],
        lanes=traffic["lanes"], samples_per_item=traffic["samples_per_item"],
        **toggles)


def camera(config: dict, traffic: dict, device):
    from tpu_pt_torch import Camera
    from tpu_pt_torch.render import CameraArrays
    c = config["camera"]
    return CameraArrays.from_camera(
        Camera(eye=c["eye"], lookat=c["lookat"], up=c["up"], fov_y=c["fov_y"],
               aspect=traffic["width"] / traffic["height"]), device=device)


def build(config: dict, traffic: dict, device, mesh=None):
    """``(step(frame, accum) -> (accum, image, stats), accum)``: the
    program's progressive frame step on ``device``, by the configuration's
    renderer; with ``mesh`` the sharded step, whose accumulator is this
    rank's block of rows."""
    if manifest.renderer(config) == "whitted":
        from tpu_pt_torch import whitted
        from tpu_pt_torch.scene.gltf import load_gltf
        scene = load_gltf(str(scene_path(config)), instancing="auto", device=device)
        return steps(scene, whitted.render_whitted_frame, config, traffic, device, mesh)
    import tpu_pt_torch as tp
    from tpu_pt_torch import render
    scene = tp.load_scene(str(scene_path(config)), device=device, build_bvh=False)
    return steps(scene, render.render_frame, config, traffic, device, mesh)


def steps(scene, frame, config: dict, traffic: dict, device, mesh=None):
    """:func:`build`'s step over a loaded ``scene``, whose one-card frame
    function is ``frame``; the sharded step picks its renderer by the
    scene's type."""
    from tpu_pt_torch import render
    cfg = render_config(config, traffic)
    cam = camera(config, traffic, device)
    if mesh is None:
        def step(k, accum):
            return frame(scene, cam, cfg, k, accum)
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
