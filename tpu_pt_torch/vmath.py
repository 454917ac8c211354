"""The public ``[..., 3]`` vector math under the JAX package's name
(``tpu_pt.vmath``). The port keeps one vector module, ``vec3``, whose
functions take ``[..., 3]`` tensors; this one re-exports it (with its
``EPS`` and the ``Vec3`` alias) and adds ``lerp``, which only
``tpu_pt.vmath`` has.
"""

from __future__ import annotations

from .vec3 import (EPS, Vec3, cross, dot, faceforward,  # noqa: F401
                   length, luminance, normalize, onb_from_normal,
                   onb_transform, reflect, refract, safe_divide, vec3)


def lerp(a, b, t):
    """a + (b - a) t (``tpu_pt.vmath.lerp``); t broadcasts as given."""
    return a + (b - a) * t
