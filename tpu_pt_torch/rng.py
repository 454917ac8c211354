"""Counter-based RNG (counterpart of ``tpu_pt/rng.py``).

Every uniform is a pure hash of ``(pixel, sample, frame, stream)`` (PCG4D,
Jarzynski & Olano, JCGT 2020), so the port draws the JAX package's own
samples bit for bit, in any lane order. No ``torch.Generator`` enters a
render.

PyTorch has no usable uint32 arithmetic here (``+`` and ``>>`` are not
implemented for uint32 on the CPU, and int32 ``>>`` is arithmetic), so
the hash runs in int64 holding values in ``[0, 2**32)``. Products of two
such values would overflow int64, so ``_mul32`` splits the second factor
into 16-bit halves; every intermediate stays below ``2**50``.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_INV_2_24 = 5.9604644775390625e-08   # 2**-24, exact in float32


def _u32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """Counter (tensor or int) -> int64 tensor of its uint32 value."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    device = like.device if like is not None else None
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 tensors holding uint32 values."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def pcg4d(a, b, c, d):
    """PCG4D hash: four uint32 counters -> four uint32 outputs (as int64)."""
    like = next((t for t in (a, b, c, d) if isinstance(t, torch.Tensor)),
                None)
    x, y, z, w = torch.broadcast_tensors(
        _u32(a, like), _u32(b, like), _u32(c, like), _u32(d, like))

    x = (x * 1664525 + 1013904223) & _M32
    y = (y * 1664525 + 1013904223) & _M32
    z = (z * 1664525 + 1013904223) & _M32
    w = (w * 1664525 + 1013904223) & _M32

    x = (x + _mul32(y, w)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    w = (w + _mul32(y, z)) & _M32

    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)

    x = (x + _mul32(y, w)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    w = (w + _mul32(y, z)) & _M32
    return x, y, z, w


def _to_unit_float(u: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 in [0, 1) with 24-bit resolution (exact)."""
    return (u >> 8).to(torch.float32) * _INV_2_24


def uniform4(pixel, sample, frame, stream):
    """Four independent uniforms in [0, 1) for the counter tuple."""
    x, y, z, w = pcg4d(pixel, sample, frame, stream)
    return (_to_unit_float(x), _to_unit_float(y),
            _to_unit_float(z), _to_unit_float(w))


def uniform2(pixel, sample, frame, stream):
    x, y, _, _ = pcg4d(pixel, sample, frame, stream)
    return _to_unit_float(x), _to_unit_float(y)


# Stream-id layout for one render pass (same ids as the JAX package).
STREAM_JITTER = 0          # camera sub-pixel jitter (2 draws)
STREAM_BOUNCE_A = 1        # per-depth d: stream = STREAM_BOUNCE_A + 2*d
STREAM_BOUNCE_B = 2        # per-depth d: stream = STREAM_BOUNCE_B + 2*d


def bounce_streams(depth):
    """Stream ids for the two pcg4d calls at a given bounce depth."""
    return STREAM_BOUNCE_A + 2 * depth, STREAM_BOUNCE_B + 2 * depth
