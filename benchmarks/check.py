"""How ``correct`` is decided: the pixels that the window rendered, drawn
from the seed, against the plain reference of the configuration's renderer
(``reference/``: the path tracer's or the Whitted renderer's).

The reference renders the same pixels of the same frames from the same
scene file and camera, and folds them into a zero accumulator as the
window did. For each pixel the gap is

    max over RGB |program - reference| / (max over RGB |reference| + s),

with ``s`` a hundredth of the sample's mean brightness, so that dark
pixels are held to the image's scale. Two numbers are compared, each
with its limit from ``checks/<cell>.json`` (or ``checks/default.json``):

- ``mismatch_share``: the share of pixels whose gap exceeds ``GAP``. A
  path of the program and the reference's twin part only where a float
  rounding flips a decision (a hit at an edge, a Russian-roulette draw at
  its threshold); the share counts the pixels such a path reaches;
- ``median_gap``: the median pixel's gap; it stays at rounding level
  however many paths part, and catches a bias spread over every pixel.
"""

from __future__ import annotations

import numpy as np
import torch

from . import manifest

GAP = 1e-3


def sample_pixels(seed: int, width: int, height: int, n: int) -> np.ndarray:
    """``n`` distinct flat pixel ids (y * width + x), drawn from the seed."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randperm(width * height, generator=g)[:n].sort().values.numpy()


def reference_values(scene_path, config: dict, traffic: dict, pixels, frames,
                     device, dtype=torch.float32, snapshot_frames: int = 0) -> dict:
    """The reference's accumulator at ``pixels`` after ``frames``
    (``values``) and after the first ``snapshot_frames`` of them
    (``snapshot``), by the reference of the configuration's renderer."""
    return manifest.reference(config).values(scene_path, config, traffic, pixels, frames,
                                             device, dtype, snapshot_frames)


def gaps(program, reference) -> np.ndarray:
    """Each pixel's gap (see the module's docstring); inf where the
    program's value is not finite."""
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    scale = np.abs(reference).max(axis=1)
    gap = np.abs(program - reference).max(axis=1) / (scale + 0.01 * scale.mean())
    return np.where(np.isfinite(gap), gap, np.inf)


def compare(program: dict, reference: dict) -> dict:
    """The compared numbers of a window: ``median_gap`` over the final
    accumulator, ``mismatch_share`` over the snapshot after the window's
    first frames (a fixed number of paths a pixel, so that the share does
    not grow with the frames that a faster program fits in the window)."""
    final = gaps(program["values"], reference["values"])
    early = gaps(program["snapshot"], reference["snapshot"])
    return {"mismatch_share": float(np.mean(early > GAP)),
            "median_gap": float(np.median(final)),
            "mismatched": int(np.sum(early > GAP))}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the limited numbers."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(numbers[k] <= limits[k] for k in limits), shown
