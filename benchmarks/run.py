"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python -m benchmarks.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run loads the cell's scene, warms up one frame at the cell's shapes,
renders progressive frames through ``tpu_pt_torch`` (the path tracer, or
the Whitted renderer where the configuration names it) back to back for
the window (the sharded cell: one process a card, the program's sharded step
over a (tile, spp) mesh), then checks a sample of the rendered pixels
against the plain reference and prints one JSON line. The seed picks the
frames (the RNG's frame axis) that the window renders and the pixels that
are checked; nothing else depends on it. With ``--trace 1`` the window
runs under ``torch.profiler`` and the line carries the per-layer metrics
and the breakdown; with ``--trace 0`` the end-to-end metrics.

The run exits non-zero and prints no result when the cell's cards are
missing, and when ``jax``, ``jaxlib``, ``flax`` or ``tpu_pt`` were loaded.
"""

import time

T0 = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

from . import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_pt")
WORKER_TIMEOUT_S = 300


def _cache_env() -> None:
    """Any compile cache a library keeps goes inside the checkout, at a
    fixed path (the program's own kernels build into ``build/tpu_pt_torch``
    beside the package). Call it before ``torch`` is imported."""
    build = manifest.ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    # Python's bytecode too: where the environment forbids writing it,
    # every run would compile torch's sources anew (6-8 s of set-up that
    # swings by a second). This process and the ranks it spawns keep it
    # in the checkout instead, so only a checkout's first run compiles.
    pyc = str(build / "pycache")
    sys.pycache_prefix, sys.dont_write_bytecode = pyc, False
    os.environ["PYTHONPYCACHEPREFIX"] = pyc
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    # The parent of the sharded cell's ranks counts cards without taking
    # a CUDA context on any of them.
    os.environ["PYTORCH_NVML_BASED_CUDA_CHECK"] = "1"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def first_frame(seed: int) -> int:
    """The first frame of the window (the warm-up renders the one before)."""
    return 1 + int(seed) % (1 << 20)


def _factory(path: str):
    mod, fn = path.split(":")
    return getattr(importlib.import_module(mod), fn)


def _free_device_memory() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# -- one card ----------------------------------------------------------------------

def _pixel_values(accum, pixels, start: int = 0):
    """(indices into ``pixels``, values [n, 3]) of the pixels that lie in
    ``accum``, a block of rows that starts at flat pixel ``start``."""
    import torch
    block = accum.reshape(-1, 3)
    mine = [i for i, p in enumerate(pixels) if start <= p < start + block.shape[0]]
    idx = torch.as_tensor([int(pixels[i]) - start for i in mine], device=accum.device,
                          dtype=torch.int64)
    return mine, block[idx].cpu().numpy()


def _run_local(spec: dict) -> list[dict]:
    import torch
    from . import session
    dev = torch.device("cuda", 0) if spec["device"] == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)   # the CUDA context, timed apart from the scene
    t = time.perf_counter()
    step, accum = _factory(spec["factory"])(spec["config"], spec["traffic"], dev)
    setup = {"cuda_at": t - spec["t_origin"], "build_s": time.perf_counter() - spec["t_origin"],
             "factory_s": time.perf_counter() - t}
    out = []
    for w in spec["windows"]:
        rec, accum, snap = session.measure(step, accum, w["first_frame"], spec["seconds"],
                                           spec["trace"], spec["snapshot_frames"])
        rec["values"] = _pixel_values(accum, w["pixels"])
        rec["snapshot"] = _pixel_values(snap, w["pixels"])
        del snap
        rec["modules"] = forbidden_modules()
        rec["setup"] = setup
        out.append({"ranks": [rec]})
    del step, accum
    _free_device_memory()
    return out


# -- four cards: one process a card ------------------------------------------------

def _worker(rank: int, spec: dict, queue) -> None:
    """One rank of the sharded cell: joins the world, runs each window in
    step with the others, and sends its records to the parent."""
    out = []
    try:
        import torch
        import torch.distributed as tdist
        from tpu_pt_torch import dist as pdist
        from . import session
        pdist.init_multihost(f"localhost:{spec['port']}", spec["world"], rank,
                             device=spec["device"])
        flags = tdist.new_group(backend="gloo")
        mesh = pdist.device_mesh(*spec["traffic"]["mesh"])
        dev = pdist.rank_device(mesh)
        t = time.perf_counter()
        step, accum = _factory(spec["factory"])(spec["config"], spec["traffic"],
                                                dev, mesh)
        setup = {"cuda_at": t - spec["t_origin"],
                 "build_s": time.perf_counter() - spec["t_origin"],
                 "factory_s": time.perf_counter() - t}

        def agree(go):
            flag = torch.tensor([int(go)])
            tdist.broadcast(flag, 0, group=flags)
            return bool(flag.item())

        for w in spec["windows"]:
            rec, accum, snap = session.measure(step, accum, w["first_frame"],
                                               spec["seconds"], spec["trace"],
                                               spec["snapshot_frames"], agree)
            if mesh.get_local_rank("spp") == 0:
                start = mesh.get_local_rank("tile") * accum.shape[0] * accum.shape[1]
                rec["values"] = _pixel_values(accum, w["pixels"], start)
                rec["snapshot"] = _pixel_values(snap, w["pixels"], start)
            del snap
            rec["modules"] = forbidden_modules()
            rec["setup"] = setup
            out.append(rec)
        tdist.barrier(group=flags)
        tdist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent reports it and fails
        out = {"error": traceback.format_exc()}
    queue.put((rank, out))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_sharded(spec: dict) -> list[dict]:
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    spec = dict(spec, port=_free_port())
    procs = [ctx.Process(target=_worker, args=(r, spec, queue))
             for r in range(spec["world"])]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < len(procs):
            rank, recs = queue.get(timeout=WORKER_TIMEOUT_S)
            got[rank] = recs
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    errors = [f"rank {r}:\n{recs['error']}" for r, recs in sorted(got.items())
              if isinstance(recs, dict)]
    if errors:
        raise RuntimeError("\n".join(errors))
    return [{"ranks": [got[r][i] for r in range(len(procs))]}
            for i in range(len(spec["windows"]))]


def run_windows(cell: dict, config: dict, traffic: dict, seeds, seconds: float,
                traced: bool, device: str = "cuda",
                factory: str = "benchmarks.session:build", t_origin: float = T0):
    """Set the program up once and run one window for each seed. Returns,
    for each seed, ``{"ranks": [record a rank], "pixels", "values"}``:
    the checked pixels and the program's accumulator there."""
    import numpy as np
    from . import check
    world = cell["chips"] if traffic.get("mesh") else 1
    chk = manifest.check(cell["name"])
    windows = [dict(first_frame=first_frame(s),
                    pixels=[int(p) for p in check.sample_pixels(
                        s, traffic["width"], traffic["height"], chk["pixels"])])
               for s in seeds]
    spec = dict(config=config, traffic=traffic, seconds=seconds, trace=traced,
                device=device, factory=factory, world=world, windows=windows,
                t_origin=t_origin, snapshot_frames=chk["snapshot_frames"])
    out = _run_local(spec) if world == 1 else _run_sharded(spec)
    for w, o in zip(windows, out):
        o["pixels"] = w["pixels"]
        for key in ("values", "snapshot"):
            o[key] = np.full((len(w["pixels"]), 3), np.nan, np.float32)
            for rec in o["ranks"]:
                if key in rec:
                    idx, vals = rec.pop(key)
                    o[key][idx] = vals
    return out


# -- the run -------------------------------------------------------------------------

def run_cell(cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
             traced: bool, device: str = "cuda",
             factory: str = "benchmarks.session:build", t_origin: float = T0):
    """Run one cell; returns (result line, lines for standard error, the
    forbidden modules loaded). ``factory`` builds the program's frame step
    (tests put a broken one in its place); ``device`` is ``cuda`` but in
    the CPU tests."""
    import torch
    from . import check, session
    world = cell["chips"] if traffic.get("mesh") else 1
    chk = manifest.check(cell["name"], manifest.renderer(config))   # exits before any work
    out = run_windows(cell, config, traffic, [seed], seconds, traced, device,
                      factory, t_origin)[0]
    ranks, pixels = out["ranks"], out["pixels"]
    r0 = ranks[0]
    frames = r0["frames"]

    print(f"window: {len(frames)} frames from {frames[0]}, {r0['window_s']:.3f} s, "
          f"{r0['rays']} rays, {r0['rounds']} rounds, set-up "
          f"{r0['window_start'] - t_origin:.3f} s (CUDA context at "
          f"{r0['setup']['cuda_at']:.3f} s; scene and step built "
          f"{r0['setup']['factory_s']:.3f} s, done at {r0['setup']['build_s']:.3f} s; "
          f"warm-up frame {r0['warmup_s']:.3f} s)", file=sys.stderr, flush=True)
    t_ref = time.perf_counter()
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    obj = session.scene_path(config)
    ref = check.reference_values(obj, config, traffic, pixels, frames, dev,
                                 snapshot_frames=chk["snapshot_frames"])
    numbers = check.compare(out, ref)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s"
          + (f", trace reduced in {r0['trace']['reduce_s']:.3f} s" if traced else ""),
          file=sys.stderr, flush=True)
    correct, shown = check.verdict(numbers, chk["limits"])

    record = dict(cell=cell["name"], config=config, traffic=traffic, world=world,
                  frames=len(frames), window_s=r0["window_s"], rays=r0["rays"],
                  rays_traced=r0["rays_traced"], shadow_rays=r0["shadow_rays"],
                  rounds=r0["rounds"], lanes=traffic["lanes"],
                  triangles=config["triangles"], peaks=manifest.data("peaks.json"),
                  ranks=ranks)
    bench = manifest.manifest()
    if traced:
        metrics = {}
        for m in manifest.per_layer(bench, cell):
            v = manifest.metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"Mrays_per_s": record["rays"] / record["window_s"] / 1e6,
                  "peak_mem_gib": max(r["memory_peak_bytes"] for r in ranks) / 2**30,
                  "setup_s": r0["window_start"] - t_origin}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(bench, cell)}
    on_card = device == "cuda"
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": world,
                "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
    line = {"correct": correct, "attempted": len(frames), "failed": 0,
            "metrics": metrics, "device": dev_info}
    if traced:
        dev_info["busy_s"] = sum(r["trace"]["busy_s"] for r in ranks) / world
        dev_info["window_s"] = sum(r["trace"]["window_s"] for r in ranks) / world
        line["breakdown"] = {"device_ops": r0["trace"]["device_ops"],
                             "idle_gaps": r0["trace"]["idle_gaps"]}
    line["checked"] = shown
    found = sorted(set(forbidden_modules()).union(*(r["modules"] for r in ranks)))
    err = [f"frames {frames[0]}..{frames[-1]} ({len(frames)}), pixels checked {len(pixels)}, "
           f"mismatched {numbers['mismatched']}"]
    err += [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in shown.items()]
    return line, err, found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmarks.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    bench = manifest.manifest()
    cell = manifest.cell(args.workload, bench)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])

    import torch
    print(f"set-up: torch imported at {time.perf_counter() - T0:.3f} s", file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmarks.run: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, err, found = run_cell(cell, config, traffic, args.seed, args.seconds,
                                bool(args.trace))
    if found:
        print(f"benchmarks.run: modules loaded that the port may not use: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(line))
    for e in err:
        print(e, file=sys.stderr)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
