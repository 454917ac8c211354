"""The readings that a cell's correctness limits are set from.

    python -m benchmarks.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds <s> [--out <file>]

The program is set up once and runs one window a seed, at the cell's own
size and length, exactly as ``benchmarks.run`` does; each window's pixels
are compared with the float32 reference, and the largest reading of each
compared number over the seeds is its *lower* reading. The control is the
reference itself computed in bfloat16 (the precision below the float32
that the configuration states), put in the program's place on the same
pixels of as many frames as a window renders; the smallest reading over
the control seeds is each number's *upper* reading. Prints one JSON
object (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from . import manifest, run


def _ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmarks.calibrate",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run._cache_env()
    import torch
    from . import check, session
    cell = manifest.cell(args.workload)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    obj = session.scene_path(config)
    snap = manifest.check(cell["name"])["snapshot_frames"]
    runs = []
    for seed, out in zip(args.seeds, run.run_windows(
            cell, config, traffic, args.seeds, args.seconds, False)):
        r0 = out["ranks"][0]
        t = time.perf_counter()
        ref = check.reference_values(obj, config, traffic, out["pixels"], r0["frames"], dev,
                                     snapshot_frames=snap)
        runs.append(dict(seed=seed, frames=len(r0["frames"]),
                         Mrays_per_s=r0["rays"] / r0["window_s"] / 1e6,
                         reference_s=time.perf_counter() - t,
                         **check.compare(out, ref)))
        print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
    n_frames = round(statistics.median(r["frames"] for r in runs)) if runs else 8
    controls = []
    for seed in args.control_seeds:
        pixels = check.sample_pixels(seed, traffic["width"], traffic["height"],
                                     manifest.check(cell["name"])["pixels"])
        frames = list(range(run.first_frame(seed), run.first_frame(seed) + n_frames))
        ref = check.reference_values(obj, config, traffic, pixels, frames, dev,
                                     snapshot_frames=snap)
        low = check.reference_values(obj, config, traffic, pixels, frames, dev,
                                     torch.bfloat16, snapshot_frames=snap)
        controls.append(dict(seed=seed, frames=n_frames, **check.compare(low, ref)))
        print(json.dumps(controls[-1]), file=sys.stderr, flush=True)
    names = ("mismatch_share", "median_gap")
    summary = dict(
        workload=cell["name"], card=torch.cuda.get_device_name(0), runs=runs,
        controls=controls,
        lower={k: max(r[k] for r in runs) for k in names} if runs else {},
        upper={k: min(c[k] for c in controls) for k in names} if controls else {})
    text = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
