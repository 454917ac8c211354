"""Interactive progressive viewer (terminal, ANSI truecolor; counterpart of
``tpu_pt/viewer.py``).

The reference's GLFW / OpenGL loop (``PathTracerMain.cpp:648-746`` and
``sutil::GLDisplay``): progressive accumulation between input events, live
keyboard toggles, FPS and statistics. A render host is often headless, so
the presenter draws the frame with 24-bit ANSI half-blocks (two image rows
per text row) instead of a textured GL quad, and ``--http PORT`` also
serves it as PNG to a browser. The key bindings, the reset of the
accumulation on every toggle and the frame statistics are the
reference's:

    0        toggle direct lighting        (PathTracerMain.cpp:111-116)
    1        toggle importance sampling    (:117-122)
    Up/Down  max depth 1..28               (:123-132)
    R        reset accumulation            (:133-135)
    Q / Esc  quit                          (:107-110)
    h/l j/k  orbit camera (trackball),  +/- zoom,  w/s dolly

Frames render on ``args.device`` (the card unless the caller asks for the
CPU).
"""

from __future__ import annotations

import os
import select
import sys
import termios
import time
import tty

import numpy as np
import torch


class TerminalDisplay:
    """ANSI truecolor half-block presenter (the GLDisplay equivalent)."""

    def draw(self, rgb_u8: np.ndarray, status: str) -> None:
        """Draw a top-down image array (``image_to_host``'s row order),
        its top row first. (The JAX package's presenter reverses the rows
        once more and so shows the frame upside down.)"""
        try:
            size = os.get_terminal_size()
            cols, rows = size.columns, size.lines - 2
        except OSError:
            cols, rows = 80, 24
        h, w, _ = rgb_u8.shape
        # Two image rows per terminal row; clamp degenerate terminal
        # geometry (ptys may report 0 lines).
        tw = max(2, min(max(cols, 2), w))
        th = max(2, min(max(rows, 1) * 2, h))
        ys = (np.linspace(0, h - 1, th)).astype(int)
        xs = (np.linspace(0, w - 1, tw)).astype(int)
        img = rgb_u8[ys][:, xs]
        out = ["\x1b[H"]
        for r in range(0, th - 1, 2):
            top = img[r]
            bot = img[r + 1]
            line = []
            for c in range(tw):
                tr, tg, tb = top[c]
                br, bg, bb = bot[c]
                line.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                            f"\x1b[48;2;{br};{bg};{bb}m▀")
            out.append("".join(line) + "\x1b[0m\x1b[K\n")
        out.append("\x1b[0m\x1b[K" + status)
        sys.stdout.write("".join(out))
        sys.stdout.flush()


class HttpDisplay:
    """Browser presenter for remote hosts: a standard-library HTTP server
    on a background thread serves the latest frame as PNG (``/frame.png``),
    the status line (``/status``) and a self-refreshing page; ``draw``
    swaps the encoded frame. The PNG comes from :mod:`tpu_pt_torch.film`.
    ``port`` 0 takes a free port (``self.port``)."""

    _PAGE = (b"<!doctype html><title>tpu-pt view</title>"
             b"<body style='margin:0;background:#111;color:#ccc;"
             b"font:12px monospace'>"
             b"<div id=s style='padding:4px'></div>"
             b"<img id=f style='image-rendering:pixelated;width:100%'>"
             b"<script>async function t(){try{"
             b"document.getElementById('f').src='/frame.png?'+Date.now();"
             b"let r=await fetch('/status');"
             b"document.getElementById('s').textContent=await r.text();"
             b"}catch(e){}setTimeout(t,250)}t()</script>")

    def __init__(self, port: int, host: str = "127.0.0.1"):
        import http.server
        import threading
        self._png = b""
        self._status = "starting"
        display = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    body, ctype = display._png, "image/png"
                elif self.path.startswith("/status"):
                    body = display._status.encode()
                    ctype = "text/plain"
                else:
                    body, ctype = display._PAGE, "text/html"
                self.send_response(200 if body else 503)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):          # quiet
                pass

        self._server = http.server.ThreadingHTTPServer((host, port),
                                                       Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        print(f"serving frames at http://{host}:{self.port}/",
              file=sys.stderr)

    def draw(self, rgb_u8: np.ndarray, status: str) -> None:
        import tempfile
        from . import film
        # ``rgb_u8`` comes through ``image_to_host`` (PNG row order).
        with tempfile.NamedTemporaryFile(suffix=".png") as f:
            film.write_png(f.name, rgb_u8)
            f.seek(0)
            self._png = f.read()
        self._status = status

    def close(self):
        self._server.shutdown()
        self._server.server_close()


class _RawInput:
    """Non-blocking raw keyboard input. Without a TTY (piped or closed
    standard input, a headless harness) keys are disabled (``old`` is
    None): the viewer renders ``--frames`` frames and exits."""

    def __enter__(self):
        self.old = None
        try:
            self.fd = sys.stdin.fileno()
            self.old = termios.tcgetattr(self.fd)
            tty.setcbreak(self.fd)
        except (termios.error, OSError, ValueError, AttributeError):
            self.old = None
        return self

    def __exit__(self, *exc):
        if self.old is not None:
            termios.tcsetattr(self.fd, termios.TCSADRAIN, self.old)

    def poll(self) -> str | None:
        if self.old is None:
            return None
        if select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "\x1b":  # an escape sequence (arrows) or a bare Esc
                if select.select([sys.stdin], [], [], 0.01)[0]:
                    seq = sys.stdin.read(2)
                    return {"[A": "UP", "[B": "DOWN", "[C": "RIGHT",
                            "[D": "LEFT"}.get(seq, None)
                return "ESC"
            return ch
        return None


def gltf_view(scene, aspect: float):
    """(camera, dolly step) of the glTF viewer: the asset's own
    perspective camera (``Scene.cpp:166-191``) when it declares one, else
    an orbit view of the world bounds, ``c + [0.7, 0.5, 0.9] * extent``
    with a 40 degree field of view; the dolly step is 5% of the extent."""
    from .camera import Camera
    lo, hi = scene.world_bounds()
    c = 0.5 * (lo + hi)
    ext = float(np.linalg.norm(hi - lo))
    if scene.camera:
        eye, lookat, up, fov = scene.camera
        camera = Camera(eye=np.asarray(eye, np.float32),
                        lookat=np.asarray(lookat, np.float32),
                        up=np.asarray(up, np.float32), fov_y=fov,
                        aspect=aspect)
    else:
        camera = Camera(eye=c + np.array([0.7, 0.5, 0.9]) * ext, lookat=c,
                        fov_y=40.0, aspect=aspect)
    return camera, 0.05 * ext


def run_viewer(scene_path: str, args) -> int:
    import tpu_pt_torch as tp
    from .camera import Trackball
    from .config import MAX_RECURSION_DEPTH
    from .render import CameraArrays, image_to_host, init_accum, render_frame

    device = torch.device(getattr(args, "device", "cuda"))
    cfg = tp.RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        max_depth=args.depth, use_direct_lighting=args.direct_lighting,
        use_importance_sampling=args.importance_sampling,
        intersector=args.intersector, scheduler=args.scheduler)
    aspect = args.width / args.height
    if scene_path.lower().endswith((".gltf", ".glb")):
        # glTF scenes view through the Whitted integrator, the reference's
        # interactive pipeline for its SDK scenes (``cuda/whitted.cu:
        # 44-98``); the path tracer stays the OBJ / scene-JSON viewer.
        from .scene.gltf import load_gltf
        from .whitted import render_whitted_frame
        scene = load_gltf(scene_path,
                          instancing=getattr(args, "instancing", None),
                          device=device)
        camera, move_step = gltf_view(scene, aspect)
        render_fn = render_whitted_frame
    else:
        scene = tp.load_scene(scene_path, device=device)
        camera = tp.cornell_default_camera(aspect=aspect)
        render_fn = render_frame
        move_step = 50.0
    if getattr(args, "fov", None) is not None:
        camera.fov_y = args.fov        # an explicit --fov beats defaults
    trackball = Trackball(camera)
    # --http PORT also serves the frames to a browser; 0 = off.
    http_display = (HttpDisplay(args.http, host=args.http_host)
                    if getattr(args, "http", 0) else None)
    display = TerminalDisplay()

    accum = init_accum(cfg, device=device)
    frame_idx = 0
    refresh = False
    fps_win_t0 = time.perf_counter()
    fps_win_frames = 0
    fps = 0.0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sys.stdout.write("\x1b[2J")  # clear
    with _RawInput() as keys:
        while True:
            key = keys.poll()
            if key in ("q", "Q", "ESC"):
                break
            elif key == "0":
                cfg = cfg.with_(use_direct_lighting=not
                                cfg.use_direct_lighting)
                refresh = True
            elif key == "1":
                cfg = cfg.with_(use_importance_sampling=not
                                cfg.use_importance_sampling)
                refresh = True
            elif key == "UP":
                cfg = cfg.with_(max_depth=min(MAX_RECURSION_DEPTH,
                                              cfg.max_depth + 1))
                refresh = True
            elif key == "DOWN":
                cfg = cfg.with_(max_depth=max(1, cfg.max_depth - 1))
                refresh = True
            elif key in ("r", "R"):
                refresh = True
            elif key in ("h", "l", "j", "k"):
                dx = {"h": -40, "l": 40}.get(key, 0)
                dy = {"j": 40, "k": -40}.get(key, 0)
                trackball.start_tracking(0, 0)
                trackball.update_tracking(dx, dy)
                refresh = True
            elif key in ("+", "="):
                trackball.zoom(+1)
                refresh = True
            elif key == "-":
                trackball.zoom(-1)
                refresh = True
            elif key == "w":
                trackball.move_forward(+move_step)
                refresh = True
            elif key == "s":
                trackball.move_forward(-move_step)
                refresh = True

            if refresh:
                # Any toggle resets the accumulation
                # (refreshAccumulationBuffer, PathTracerMain.cpp:166-182).
                accum = init_accum(cfg, device=device)
                frame_idx = 0
                fps_win_t0 = time.perf_counter()
                fps_win_frames = 0
                refresh = False

            cam = CameraArrays.from_camera(camera, device=device)
            sync()
            t0 = time.perf_counter()
            accum, img, stats = render_fn(scene, cam, cfg, frame_idx, accum)
            sync()
            dt = time.perf_counter() - t0
            frame_idx += 1

            # Windowed FPS over 0.5 s (sutil::displayFPS).
            fps_win_frames += 1
            now = time.perf_counter()
            if now - fps_win_t0 > 0.5:
                fps = fps_win_frames / (now - fps_win_t0)
                fps_win_t0 = now
                fps_win_frames = 0

            rays = float(stats.rays_traced) + float(stats.shadow_rays)
            status = (f"frame {frame_idx} | {dt * 1e3:6.0f} ms | "
                      f"fps {fps:4.1f} | {rays / dt / 1e6:5.1f} Mrays/s | "
                      f"spp {cfg.spp * frame_idx} | depth {cfg.max_depth} | "
                      f"DL {'on' if cfg.use_direct_lighting else 'off'} | "
                      f"IS {'on' if cfg.use_importance_sampling else 'off'}"
                      f" | [0]DL [1]IS [^v]depth [R]eset [Q]uit")
            host_img = image_to_host(img)
            display.draw(host_img, status)
            if http_display is not None:
                http_display.draw(host_img, status)

            # Headless (no TTY): no quit key can arrive, so render
            # --frames progressive frames and exit.
            if keys.old is None and frame_idx >= args.frames:
                break
    if http_display is not None:
        http_display.close()
    sys.stdout.write("\n")
    if getattr(args, "output", None):
        from . import film
        film.write_png(args.output, image_to_host(img))
    return 0
