"""One rank of the gloo world that ``tests/test_torch_dist.py`` spawns.

Launched with argv ``(rank, world_size, port, out_dir)`` and
``LOCAL_WORLD_SIZE=2`` in its environment (four ranks stand for two
"hosts" of two devices each). Joins the world through
``tpu_pt_torch.dist.init_multihost(device="cpu")``, renders every sharded
case of the tests in turn (the same sequence on every rank, since mesh
construction and the frame step are collective) and writes what it got to
``out_dir/rank<rank>.npz``; the tests compare those arrays with
single-device frames. It imports no JAX: any import of it fails here.
Exit code 0 means every case ran.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# The cases (tests/test_dist.py's and tests/multihost_worker.py's, on four
# ranks in place of eight virtual devices).
BASE = dict(width=32, height=32, spp=8, max_depth=3,
            use_direct_lighting=True, use_importance_sampling=True)
SHAPES = [(4, 1), (2, 2), (1, 4)]
MESHES = {"default": {}, "tile4": dict(n_tile=4), "spp4": dict(n_spp=4),
          "4x1": dict(n_tile=4, n_spp=1), "1x4": dict(n_tile=1, n_spp=4)}
MULTIHOST = dict(width=16, height=16, spp=4, max_depth=3)
WHITTED_SHAPES = [(2, 2), (1, 4)]
WHITTED_VIEW = dict(eye=(6.0, 4.5, 7.0), lookat=(0.0, 0.8, 0.0), fov_y=40.0)


def _stats(stats) -> dict:
    return dict(rays=stats.rays_traced.numpy(),
                shadow=stats.shadow_rays.numpy(),
                hist=stats.done_histogram.numpy(),
                iters=stats.wavefront_iterations.numpy())


def main() -> None:
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import tpu_pt_torch as tp
    from tpu_pt_torch import dist
    from tpu_pt_torch.camera import Camera
    from tpu_pt_torch.render import CameraArrays

    dist.init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    dist.init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    res = {"world": np.int64(torch.distributed.get_world_size()),
           "backend": np.array(torch.distributed.get_backend())}

    def put(prefix, accum=None, u8=None, stats=None, mesh=None, **extra):
        if accum is not None:
            res[f"{prefix}.block_shape"] = np.array(accum.shape)
            res[f"{prefix}.accum"] = dist.gather_frame(accum, mesh)
        if u8 is not None:
            res[f"{prefix}.u8"] = dist.gather_frame(u8, mesh)
        if stats is not None:
            res.update({f"{prefix}.{k}": v for k, v in _stats(stats).items()})
        res.update({f"{prefix}.{k}": v for k, v in extra.items()})

    def frames(scene, cam, cfg, mesh, n=1):
        step = dist.make_sharded_renderer(scene, cfg, mesh)
        accum = dist.init_accum_sharded(cfg, mesh)
        for f in range(n):
            accum, u8, stats = step(cam, f, accum)
        return accum, u8, stats

    for key, kw in MESHES.items():
        res[f"mesh.{key}"] = np.array(dist.device_mesh(**kw).shape)
    errors = {}
    for what, fn in (("mesh_size", lambda: dist.device_mesh(3, 1)),
                     ("multihost_spp", lambda: dist.multihost_mesh(4))):
        try:
            fn()
            errors[what] = 0
        except ValueError:
            errors[what] = 1

    scene = tp.load_scene(os.path.join(REPO, "assets", "cornell_box.obj"),
                          device="cpu")
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device="cpu")
    cfg = tp.RenderConfig(**BASE)
    for what, bad, shape in (("height", cfg.with_(height=30), (4, 1)),
                             ("spp", cfg.with_(spp=6), (1, 4))):
        mesh = dist.device_mesh(*shape)
        try:
            dist.make_sharded_renderer(scene, bad, mesh)
            errors[what] = 0
        except ValueError:
            errors[what] = 1
    res.update({f"error.{k}": np.int64(v) for k, v in errors.items()})

    # The sharded frame against the single-device one, per shape.
    for n_tile, n_spp in SHAPES:
        mesh = dist.device_mesh(n_tile, n_spp)
        accum, u8, stats = frames(scene, cam, cfg, mesh)
        put(f"pt.{n_tile}x{n_spp}", accum, u8, stats, mesh)
    # Tile-only sharding on the scan scheduler: bitwise.
    mesh = dist.device_mesh(4, 1)
    accum, u8, stats = frames(scene, cam, cfg.with_(scheduler="scan"), mesh)
    put("scan", accum, u8, stats, mesh)
    # Three progressive frames on (2, 2) at 2 spp.
    mesh = dist.device_mesh(2, 2)
    accum, u8, stats = frames(scene, cam, cfg.with_(spp=2), mesh, n=3)
    put("progressive", accum, u8, stats, mesh)
    # The accumulator stays sharded.
    mesh = dist.device_mesh(4, 1)
    accum, _, _ = frames(scene, cam, cfg.with_(spp=2), mesh)
    res["sharded.block_shape"] = np.array(accum.shape)

    # Whitted over the same meshes (pbr_test.gltf through brute force).
    ws = tp.load_gltf(os.path.join(REPO, "assets", "pbr_test.gltf"),
                      device="cpu")
    wcam = CameraArrays.from_camera(Camera(
        eye=np.array(WHITTED_VIEW["eye"], np.float32),
        lookat=np.array(WHITTED_VIEW["lookat"], np.float32),
        fov_y=WHITTED_VIEW["fov_y"]), device="cpu")
    wcfg = cfg.with_(intersector="bruteforce")
    for n_tile, n_spp in WHITTED_SHAPES:
        mesh = dist.device_mesh(n_tile, n_spp)
        accum, u8, stats = frames(ws, wcam, wcfg, mesh)
        put(f"whitted.{n_tile}x{n_spp}", accum, u8, stats, mesh)

    # Two "hosts" of two ranks: spp groups stay inside a host.
    for n_spp in (1, 2):
        mesh = dist.multihost_mesh(n_spp)
        accum, _, stats = frames(scene, cam,
                                 tp.RenderConfig(**{**BASE, **MULTIHOST}),
                                 mesh)
        put(f"multihost{n_spp}", accum, None, stats, mesh,
            shape=np.array(mesh.shape))
        accum, _, stats = frames(
            ws, wcam, tp.RenderConfig(**MULTIHOST, intersector="bruteforce"),
            mesh)
        put(f"multihost{n_spp}.whitted", accum, None, stats, mesh)

    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: every case ran", flush=True)


if __name__ == "__main__":
    for _name in ("jax", "jaxlib", "tpu_pt"):
        sys.modules[_name] = None
    main()
