"""Command-line interface: offline rendering and benchmarking (counterpart
of ``tpu_pt/cli.py``).

A flag system in place of the reference's compile-time constants
(``PathTracerMain.cpp:41-59``), with its end-of-run statistics (total
samples, average and total ms, ``PathTracerMain.cpp:738-740``) and the
framework's telemetry. Renders run on the card unless ``--device cpu``
asks for the CPU (where the kernels' plain versions run).

Usage examples:
    python -m tpu_pt_torch.cli render scene.obj -o out.png --spp 128 --frames 4
    python -m tpu_pt_torch.cli render scene.obj --depth 8 --no-direct-lighting
    python -m tpu_pt_torch.cli render scene.obj --resume ckpt.npz --frames 16
    python -m tpu_pt_torch.cli render scene.gltf --instancing instanced
    python -m tpu_pt_torch.cli bench
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("scene", nargs="?", help="OBJ or glTF scene path")
    p.add_argument("-o", "--output", default="render.png",
                   help="output image (.png, .ppm, or .exr linear HDR)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=128,
                   help="samples per pixel per frame (reference default 128)")
    p.add_argument("--frames", type=int, default=1,
                   help="progressive frames to accumulate")
    p.add_argument("--depth", type=int, default=4,
                   help="max bounce depth 1-28 (reference default 4)")
    p.add_argument("--direct-lighting", action="store_true", default=False,
                   help="enable NEE direct lighting (reference key '0')")
    p.add_argument("--no-direct-lighting", dest="direct_lighting",
                   action="store_false")
    p.add_argument("--importance-sampling", action="store_true",
                   default=False,
                   help="cosine-weighted sampling (reference key '1')")
    p.add_argument("--no-importance-sampling", dest="importance_sampling",
                   action="store_false")
    p.add_argument("--intersector", default="auto",
                   choices=["auto", "bruteforce", "dense", "bvh"])
    p.add_argument("--scheduler", default="pixelq",
                   choices=["pixelq", "regen", "scan"])
    p.add_argument("--reference-quirks", action="store_true",
                   help="replicate the reference renderer's known bugs "
                        "(fixed 0.2 metal roughness, first-hit occlusion)")
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--lookat", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=None,
                   help="vertical FOV degrees (default 35, or the glTF "
                        "asset's own camera when it declares one)")
    p.add_argument("--checkpoint", default=None,
                   help="write render state here after finishing")
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint (.npz)")
    p.add_argument("--stats", action="store_true",
                   help="print per-frame telemetry")
    p.add_argument("--validate", action="store_true",
                   help="check every intersection and the frame for "
                        "NaN/Inf and out-of-range ids (the reference's "
                        "OptiX validation mode; slower)")
    p.add_argument("--pipeline", default="auto",
                   choices=["auto", "pathtrace", "whitted"],
                   help="auto: path tracer for .obj, whitted direct "
                        "lighting for .gltf/.glb")
    p.add_argument("--background", type=float, nargs=3,
                   default=[0.0, 0.0, 0.0])
    p.add_argument("--instancing", default=None,
                   choices=["auto", "flatten", "instanced"],
                   help="glTF geometry contract (default auto; a resumed "
                        "render keeps its checkpoint's)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; cpu "
                        "runs the kernels' plain versions)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _apply_view(camera, args) -> None:
    if args.eye is not None:
        camera.eye = np.asarray(args.eye, np.float32)
    if args.lookat is not None:
        camera.lookat = np.asarray(args.lookat, np.float32)
    if args.fov is not None:
        camera.fov_y = args.fov    # an explicit --fov beats the asset's


def _config(args):
    import tpu_pt_torch as tp
    from tpu_pt_torch.config import Quirks
    quirks = Quirks.reference() if args.reference_quirks else Quirks()
    return tp.RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        max_depth=args.depth, use_direct_lighting=args.direct_lighting,
        use_importance_sampling=args.importance_sampling,
        background=tuple(args.background), intersector=args.intersector,
        scheduler=args.scheduler, quirks=quirks)


def _pipeline_for(args) -> str:
    if args.pipeline != "auto":
        return args.pipeline
    if args.scene and args.scene.lower().endswith((".gltf", ".glb")):
        return "whitted"
    return "pathtrace"


def _whitted_setup(args, device):
    """(scene, camera, cfg, accum, first frame, instancing contract) of a
    Whitted render; a resumed one reloads the scene with the contract its
    checkpoint recorded."""
    from tpu_pt_torch.camera import Camera
    from tpu_pt_torch.checkpoint import checkpoint_instancing, load_checkpoint
    from tpu_pt_torch.render import init_accum
    from tpu_pt_torch.scene.gltf import load_gltf

    mode = args.instancing
    if args.resume:
        recorded = checkpoint_instancing(args.resume)
        if mode and recorded and mode != recorded:
            raise SystemExit(f"--instancing {mode} differs from the "
                             f"checkpoint's {recorded}")
        mode = mode or recorded
    ws = load_gltf(args.scene, instancing=mode or "auto", device=device)
    contract = "instanced" if ws.inst is not None else "flatten"
    if args.resume:
        accum, frame_start, cfg, camera = load_checkpoint(args.resume,
                                                          device=device)
        return ws, camera, cfg, accum, frame_start, contract
    cfg = _config(args)
    if ws.camera:
        # The asset's own perspective camera (sutil::Scene loads glTF
        # cameras the same way, Scene.cpp:166-191).
        eye, lookat, up, fov = ws.camera
        camera = Camera(eye=eye, lookat=lookat, up=up, fov_y=fov,
                        aspect=args.width / args.height)
    else:
        # Frame the scene's world bounds.
        lo, hi = ws.world_bounds()
        c = 0.5 * (lo + hi)
        ext = float(np.linalg.norm(hi - lo))
        camera = Camera(eye=c + np.array([0.7, 0.5, 0.9]) * ext, lookat=c,
                        fov_y=35.0, aspect=args.width / args.height)
    _apply_view(camera, args)
    return ws, camera, cfg, init_accum(cfg, device=device), 0, contract


def _pathtrace_setup(args, device):
    """(scene, camera, cfg, accum, first frame, None) of a path-trace
    render, fresh or resumed."""
    import tpu_pt_torch as tp
    from tpu_pt_torch.checkpoint import load_checkpoint
    from tpu_pt_torch.render import init_accum

    scene = tp.load_scene(args.scene, device=device)
    if args.resume:
        accum, frame_start, cfg, camera = load_checkpoint(args.resume,
                                                          device=device)
        return scene, camera, cfg, accum, frame_start, None
    cfg = _config(args)
    camera = tp.cornell_default_camera(aspect=args.width / args.height)
    _apply_view(camera, args)
    return scene, camera, cfg, init_accum(cfg, device=device), 0, None


def _write_image(path: str, host_img_u8: np.ndarray, accum) -> None:
    """Route by extension: .ppm, .exr (linear HDR from the accumulation
    buffer, ZIP-compressed) or .png (default)."""
    from tpu_pt_torch import film
    if path.endswith(".ppm"):
        film.write_ppm(path, host_img_u8)
    elif path.endswith(".exr"):
        film.write_exr(path, accum.cpu().numpy()[::-1], compression="zip")
    else:
        film.write_png(path, host_img_u8)


def cmd_render(args) -> int:
    from tpu_pt_torch import debug
    from tpu_pt_torch.checkpoint import save_checkpoint
    from tpu_pt_torch.render import (CameraArrays, image_to_host,
                                     render_frame)
    from tpu_pt_torch.whitted import render_whitted_frame

    if not args.scene:
        raise SystemExit("scene path required (also with --resume)")
    device = torch.device(args.device)
    whitted = _pipeline_for(args) == "whitted"
    setup = _whitted_setup if whitted else _pathtrace_setup
    scene, camera, cfg, accum, frame_start, contract = setup(args, device)
    cam = CameraArrays.from_camera(camera, device=device)
    if args.validate:
        render = (debug.validate_whitted_frame if whitted
                  else debug.validate_frame)
    else:
        render = render_whitted_frame if whitted else render_frame

    total_ms = 0.0
    img = None
    for k in range(args.frames):
        f = frame_start + k
        _sync(device)
        t0 = time.perf_counter()
        accum, img, stats = render(scene, cam, cfg, f, accum)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        total_ms += ms
        line = f"\rFrame Render Time: {ms:.0f}ms"
        if args.stats:
            rays = int(stats.rays_traced) + int(stats.shadow_rays)
            hist = stats.done_histogram.cpu().numpy().astype(int)
            ends = ("absorbed)={}/{}/{}".format(*hist[:3]) if whitted else
                    "rr/light)={}/{}/{}/{}".format(*hist[:4]))
            line += (f"  [{rays / (ms / 1e3) / 1e6:.1f} Mrays/s, "
                     f"iters {int(stats.wavefront_iterations)}, "
                     f"done(miss/depth/{ends}]")
        print(line, end="", flush=True)
    print()

    # End-of-run totals (PathTracerMain.cpp:738-740 parity).
    frames = args.frames
    print(f"Total Samples: {cfg.spp * frames * cfg.width * cfg.height}")
    print(f"Average Frame Time: {total_ms / max(frames, 1):.1f}ms")
    print(f"Total Render Time: {total_ms:.0f}ms")
    _write_image(args.output, image_to_host(img), accum)
    print(f"wrote {args.output}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, accum, frame_start + frames, cfg,
                        camera, instancing=contract)
        print(f"checkpoint -> {args.checkpoint}")
    return 0


def cmd_bench(args) -> int:
    """The port's headline benchmark (``tpu_pt_torch.bench``), honouring
    the CLI's scene / size / spp / depth / scheduler / frames flags where
    they differ from their defaults (a bare ``bench`` keeps the canonical
    workload)."""
    if args.scene:
        os.environ.setdefault("BENCH_SCENE", os.path.abspath(args.scene))
    if args.width != 512:
        os.environ.setdefault("BENCH_SIZE", str(args.width))
    if args.spp != 128:
        os.environ.setdefault("BENCH_SPP", str(args.spp))
    if args.depth != 4:
        os.environ.setdefault("BENCH_DEPTH", str(args.depth))
    if args.scheduler != "pixelq":
        os.environ.setdefault("BENCH_SCHED", args.scheduler)
    if args.frames != 1:
        os.environ.setdefault("BENCH_FRAMES", str(args.frames))
    from tpu_pt_torch import bench
    bench.main(["--device", args.device])
    return 0


def cmd_view(args) -> int:
    raise NotImplementedError("the interactive viewer is not ported yet "
                              "(ROADMAP.md Queue 1 item 16)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_pt_torch", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)
    for name, fn, text in (("render", cmd_render, "offline progressive render"),
                           ("view", cmd_view, "interactive viewer (not "
                                              "ported yet)"),
                           ("bench", cmd_bench, "run the headline benchmark")):
        p = sub.add_parser(name, help=text)
        _add_render_args(p)
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
