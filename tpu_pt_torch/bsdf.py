"""BSDF sampling and Fresnel terms on ``[..., 3]`` tensors (counterpart of
``tpu_pt/bsdf.py``).

- cosine / uniform hemisphere sampling (``pathTracerPrograms.cu:341-380``)
- GGX microfacet sampling (``pathTracerPrograms.cu:455-476``)
- conductor Fresnel (``pathTracerPrograms.cu:494-510``)
- dielectric Fresnel with TIR (``pathTracerPrograms.cu:534-559``)
"""

from __future__ import annotations

import math

import torch

from . import vec3 as v3

# The reference hardcodes the metal's complex IOR (pathTracerPrograms.cu:943-944).
METAL_ETA = (1.45, 0.7, 1.55)
METAL_K = (3.0, 2.2, 3.5)

_TWO_PI = 2.0 * math.pi


def cosine_sample_hemisphere(u1, u2) -> torch.Tensor:
    """Cosine-weighted local direction (z up); pdf = cos(theta)/pi."""
    cos_t = torch.sqrt(u1)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    phi = _TWO_PI * u2
    return v3.vec3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)


def uniform_sample_hemisphere(u1, u2) -> torch.Tensor:
    """Uniform local hemisphere direction; pdf = 1/(2 pi)."""
    sin_t = torch.sqrt(torch.clamp_min(1.0 - u1 * u1, 0.0))
    phi = _TWO_PI * u2
    return v3.vec3(torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, u1)


def sample_hemisphere_world(n: torch.Tensor, u1, u2,
                            importance: bool) -> torch.Tensor:
    """Sample a direction about world normal ``n`` via the reference ONB."""
    local = (cosine_sample_hemisphere(u1, u2) if importance
             else uniform_sample_hemisphere(u1, u2))
    t, b, nn = v3.onb_from_normal(n)
    return v3.onb_transform(local, t, b, nn)


def sample_ggx(u1, u2, roughness, n: torch.Tensor) -> torch.Tensor:
    """GGX microfacet normal about ``n`` with the reference's tangent
    frame from up = (0,0,1), or (1,0,0) near the pole. Roughness is
    clamped to [0.001, 1]."""
    a = torch.clamp(roughness, 0.001, 1.0)
    phi = _TWO_PI * u1
    cos_t = torch.sqrt((1.0 - u2) / (1.0 + (a * a - 1.0) * u2))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    hx, hy, hz = sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t

    pole = (torch.abs(n[..., 2]) >= 0.999)[..., None]
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=n.device)
    z_axis = torch.tensor([0.0, 0.0, 1.0], device=n.device)
    up = torch.where(pole, x_axis, z_axis).expand_as(n)
    tangent = v3.normalize(v3.cross(up, n))
    bitangent = v3.cross(n, tangent)
    h = (tangent * hx[..., None] + bitangent * hy[..., None]) + n * hz[..., None]
    return v3.normalize(h)


def fresnel_conductor(cos_theta, eta: torch.Tensor,
                      k: torch.Tensor) -> torch.Tensor:
    """Conductor Fresnel reflectance per RGB channel; ``eta`` and ``k``
    broadcast against ``cos_theta[..., None]``."""
    c = torch.as_tensor(cos_theta, dtype=torch.float32)
    c2 = (c * c)[..., None]
    e2 = eta * eta
    k2 = k * k
    t1 = e2 - k2 - c2
    a2b2 = torch.sqrt(torch.clamp_min(t1 * t1 + 4.0 * e2 * k2, 0.0))
    t2 = a2b2 + c2
    two_ec = 2.0 * eta * torch.sqrt(c2)
    rs = (t2 - two_ec + c2) / (t2 + two_ec + c2)
    rp = rs * (t2 - two_ec + 1.0) / (t2 + two_ec + 1.0)
    return 0.5 * (rs + rp)


def metal_eta_k(device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's hardcoded conductor constants as [3] tensors."""
    return (torch.tensor(METAL_ETA, dtype=torch.float32, device=device),
            torch.tensor(METAL_K, dtype=torch.float32, device=device))


def fr_dielectric(cos_theta_i, eta_i, eta_t):
    """Dielectric Fresnel with total internal reflection (PBRT-style): a
    negative cos_theta_i means the ray is inside the medium."""
    cos_i = torch.clamp(torch.as_tensor(cos_theta_i, dtype=torch.float32),
                        -1.0, 1.0)
    entering = cos_i > 0.0
    eta_i = torch.as_tensor(eta_i, dtype=torch.float32, device=cos_i.device)
    eta_t = torch.as_tensor(eta_t, dtype=torch.float32, device=cos_i.device)
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    cos_i = torch.abs(cos_i)

    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    # eta_t is 0 on lanes whose material never refracts (every BSDF is
    # evaluated on every lane, then masked): treat as TIR.
    sin_t = ei / torch.clamp_min(et, 1e-12) * sin_i
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin_t * sin_t, 0.0))

    # The denominators vanish only at the TIR boundary, where the result
    # is overridden to 1; masking them keeps the op NaN-free.
    d_parl = (et * cos_i) + (ei * cos_t)
    d_perp = (ei * cos_i) + (et * cos_t)
    r_parl = ((et * cos_i) - (ei * cos_t)) / torch.where(d_parl > 0, d_parl, 1.0)
    r_perp = ((ei * cos_i) - (et * cos_t)) / torch.where(d_perp > 0, d_perp, 1.0)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, f)
