"""tpu_pt_torch — the PyTorch + CUDA port of ``tpu_pt`` for NVIDIA Hopper.

A progressive wavefront path tracer: OBJ Cornell scenes with diffuse,
GGX-metal and dielectric BSDFs, area-light next-event estimation, Russian
roulette and progressive sRGB accumulation. It imports only ``torch`` and
``numpy``. The ray-triangle sweeps on the main path are hand-written CUDA
kernels (``csrc/``), built with ``nvcc`` at first use on a CUDA device;
on CPU tensors their plain PyTorch versions run instead.
"""

__version__ = "0.1.0"

from .config import RenderConfig, Quirks  # noqa: F401
from .camera import Camera, cornell_default_camera  # noqa: F401
from .render import (CameraArrays, RenderStats, render_frame,  # noqa: F401
                     render_wavefront, init_accum, image_to_host)
from .scene import load_scene, SceneArrays, scene_from_numpy  # noqa: F401
