"""tpu_pt_torch — the PyTorch + CUDA port of ``tpu_pt`` for NVIDIA Hopper.

A progressive wavefront path tracer: OBJ, scene-JSON and glTF scenes
(triangles, analytic spheres, shells and parallelograms, swept-sphere
curves) with diffuse, GGX-metal and dielectric BSDFs, area-light
next-event estimation, Russian roulette and progressive sRGB
accumulation; and the Whitted direct-lighting pipeline over glTF scenes,
flattened or instanced. It imports only ``torch`` and ``numpy``. The ray-triangle sweeps are
hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at first use
on a CUDA device; on CPU tensors their plain PyTorch versions run
instead. Scenes, cameras and accumulators land on the card unless the
caller passes ``device="cpu"``.

Entry points: ``python -m tpu_pt_torch.cli`` (render, bench),
``python -m tpu_pt_torch.bench``, ``checkpoint``, ``debug`` (path replay,
frame validation) and ``profiling``.
"""

__version__ = "0.1.0"

from .config import RenderConfig, Quirks  # noqa: F401
from .camera import Camera, Trackball, cornell_default_camera  # noqa: F401
from .render import (CameraArrays, RenderStats, render_frame,  # noqa: F401
                     render_wavefront, init_accum, image_to_host)
from .checkpoint import save_checkpoint, load_checkpoint  # noqa: F401
from .debug import trace_pixel, validate_frame  # noqa: F401
from .profiling import RenderProfiler  # noqa: F401
from .scene import load_scene, SceneArrays, scene_from_numpy  # noqa: F401
from .scene.gltf import WhittedScene, load_gltf  # noqa: F401
from .whitted import render_whitted_frame  # noqa: F401
from . import vmath  # noqa: F401  (the public [N, 3] vector math)
