"""Vector math on ``[..., 3]`` float32 tensors (counterpart of
``tpu_pt/vec3.py`` and ``tpu_pt/vmath.py``).

The JAX package keeps vectors as three separate arrays (``V3``) only for
TPU lane layout; here they are ``[..., 3]`` tensors. Every reduction over
the size-3 axis is written out component by component in the JAX
package's order (``x*x' + y*y' + z*z'``), and normalisation uses
``rsqrt`` as ``tpu_pt.vec3`` does, so the port rounds as the reference
does on the render path.
"""

from __future__ import annotations

import torch

Vec3 = torch.Tensor  # [..., 3]

# Squared lengths at or below this normalise to zero (``tpu_pt.vmath.EPS``).
EPS = 1e-12


def vec3(x, y, z) -> torch.Tensor:
    """Stack three broadcastable tensors into a [..., 3] vector."""
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return vec3(ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(dot(a, a), 0.0))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Normalise; vectors with squared length <= EPS map to zero."""
    n2 = dot(a, a)
    inv = torch.where(n2 > EPS, torch.rsqrt(torch.clamp_min(n2, 1e-30)),
                      torch.zeros_like(n2))
    return a * inv[..., None]


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """i - 2*dot(n, i)*n (``sutil/vec_math.h`` reflect)."""
    return i - n * (2.0 * dot(n, i))[..., None]


def faceforward(n: torch.Tensor, i: torch.Tensor,
                nref: torch.Tensor) -> torch.Tensor:
    """n * copysign(1, dot(i, nref)) (``sutil/vec_math.h`` faceforward)."""
    s = torch.where(dot(i, nref) >= 0.0, 1.0, -1.0)
    return n * s[..., None]


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """NTSC weights (0.30, 0.59, 0.11), ``cuda/helpers.h:76-80``."""
    return rgb[..., 0] * 0.30 + rgb[..., 1] * 0.59 + rgb[..., 2] * 0.11


def safe_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b with 0 where b == 0 (``pathTracerPrograms.cu:265-284``),
    as ``a * (1 / b)`` like ``tpu_pt.vec3.safe_divide``."""
    zero = b == 0.0
    inv = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, b))
    return a * inv[..., None]


def onb_from_normal(n: torch.Tensor):
    """Reference ONB (``pathTracerPrograms.cu:54-75``), branch-free.
    Returns (tangent, binormal, normal)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    use_x = (torch.abs(nx) > torch.abs(nz))[..., None]
    zeros = torch.zeros_like(nx)
    b = torch.where(use_x, vec3(-ny, nx, zeros), vec3(zeros, -nz, ny))
    b = normalize(b)
    return cross(b, n), b, n


def onb_transform(local: torch.Tensor, t: torch.Tensor, b: torch.Tensor,
                  n: torch.Tensor) -> torch.Tensor:
    """Local (x, y, z) -> world: x*t + y*b + z*n."""
    return (t * local[..., 0:1] + b * local[..., 1:2]) + n * local[..., 2:3]


def refract(i: torch.Tensor, n: torch.Tensor, ior):
    """Refract ``i`` at normal ``n`` with relative ``ior``
    (``cuda/helpers.h:107-137``). Returns (direction, did_refract); the
    direction is zero on total internal reflection."""
    ior = torch.as_tensor(ior, dtype=torch.float32, device=i.device)
    neg_ndotv = dot(i, n)
    exiting = neg_ndotv > 0.0
    eta = torch.where(exiting, ior, 1.0 / ior)
    nn = torch.where(exiting[..., None], -n, n)
    cos_i = torch.where(exiting, -neg_ndotv, neg_ndotv)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    ok = k >= 0.0
    r = i * eta[..., None] - nn * (eta * cos_i
                                   + torch.sqrt(torch.clamp_min(k, 0.0)))[..., None]
    r = normalize(r)
    return torch.where(ok[..., None], r, torch.zeros_like(r)), ok
