"""Checkpoint / resume for progressive renders (counterpart of
``tpu_pt/checkpoint.py``, the same ``.npz`` format, version 1).

The render state is the progressive accumulation buffer plus the frame
counter (``PathTracerMain.cpp:166-182``), with the config and the camera.
The counter RNG derives every sample from (pixel, sample, frame), so a
render resumed from a checkpoint reproduces exactly the frames an
uninterrupted run would have produced. Checkpoints of either package load
in the other; the port also records the glTF scene's instancing contract
(``instancing``, absent from ``tpu_pt``'s files), so that a resumed
Whitted render reloads its scene the same way.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .camera import Camera
from .config import Quirks, RenderConfig

FORMAT_VERSION = 1
# The JAX package's names for the port's intersectors.
_INTERSECTOR_NAMES = {"pallas": "dense"}


def save_checkpoint(path: str, accum: torch.Tensor, frame_idx: int,
                    cfg: RenderConfig, camera: Camera,
                    instancing: str | None = None) -> None:
    """Write render state to an .npz file. ``instancing`` is the glTF
    contract the scene was loaded with ("flatten" or "instanced"), None
    for an OBJ scene."""
    cfg_dict = dataclasses.asdict(cfg)
    cfg_dict["quirks"] = dataclasses.asdict(cfg.quirks)
    extra = {} if instancing is None else {"instancing": np.str_(instancing)}
    np.savez_compressed(
        path,
        version=np.int32(FORMAT_VERSION),
        accum=accum.detach().cpu().numpy().astype(np.float32),
        frame_idx=np.int64(frame_idx),
        config_json=np.bytes_(json.dumps(cfg_dict).encode()),
        cam_eye=np.asarray(camera.eye, np.float32),
        cam_lookat=np.asarray(camera.lookat, np.float32),
        cam_up=np.asarray(camera.up, np.float32),
        cam_fov_y=np.float32(camera.fov_y),
        cam_aspect=np.float32(camera.aspect),
        **extra,
    )


def load_checkpoint(path: str, device="cuda"):
    """Read render state, ``accum`` onto ``device`` (the card unless the
    caller asks for the CPU). Returns (accum [H, W, 3], frame_idx, cfg,
    camera)."""
    with np.load(path) as z:
        version = int(z["version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"{path}: unknown checkpoint version {version}")
        accum = torch.as_tensor(np.array(z["accum"], np.float32),
                                device=device)
        frame_idx = int(z["frame_idx"])
        cfg_dict = json.loads(bytes(z["config_json"]).decode())
        quirks = Quirks(**cfg_dict.pop("quirks"))
        cfg_dict["background"] = tuple(cfg_dict["background"])
        cfg_dict["intersector"] = _INTERSECTOR_NAMES.get(
            cfg_dict["intersector"], cfg_dict["intersector"])
        cfg = RenderConfig(**cfg_dict, quirks=quirks)
        camera = Camera(eye=z["cam_eye"], lookat=z["cam_lookat"],
                        up=z["cam_up"], fov_y=float(z["cam_fov_y"]),
                        aspect=float(z["cam_aspect"]))
    return accum, frame_idx, cfg, camera


def checkpoint_instancing(path: str) -> str | None:
    """The glTF instancing contract a checkpoint recorded, or None (an OBJ
    render, or a checkpoint written by ``tpu_pt``)."""
    with np.load(path) as z:
        return str(z["instancing"]) if "instancing" in z.files else None
