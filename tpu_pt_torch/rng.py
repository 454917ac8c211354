"""Counter-based RNG (counterpart of ``tpu_pt/rng.py``).

Every uniform is a pure hash of ``(pixel, sample, frame, stream)`` (PCG4D,
Jarzynski & Olano, JCGT 2020), so the port draws the JAX package's own
samples bit for bit, in any lane order. No ``torch.Generator`` enters a
render.

For CUDA counters ``uniform2``, ``uniform4`` and ``bounce_uniforms``
launch one kernel a draw (``csrc/rng.cu``): PCG4D in native uint32,
bitwise equal to the plain version below, with scalar counters passed by
value, so a draw makes no host-to-card copy. CPU counters take the plain
version; there is no fallback on the card. ``LAUNCHES`` counts the
kernel's launches per wrapper.

The plain version: PyTorch has no usable uint32 arithmetic here (``+``
and ``>>`` are not implemented for uint32 on the CPU, and int32 ``>>`` is
arithmetic), so the hash runs in int64 holding values in ``[0, 2**32)``.
Products of two such values would overflow int64, so ``_mul32`` splits
the second factor into 16-bit halves; every intermediate stays below
``2**50``.
"""

from __future__ import annotations

import ctypes

import torch

_M32 = 0xFFFFFFFF
_INV_2_24 = 5.9604644775390625e-08   # 2**-24, exact in float32
_ROW_ALIGN = 32   # floats: each output row of the kernel starts 128-byte aligned

# Kernel launches per wrapper (read by chip_smoke.py). Draws on CPU tensors
# do not count.
LAUNCHES = {"uniform": 0, "bounce_uniforms": 0}


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


def _card(counters) -> torch.device | None:
    """The CUDA device of the counters' tensors, or None when they are on
    the CPU (or all Python ints): the plain version. Raises for a mix of
    devices, or any other device."""
    devices = {c.device for c in counters if isinstance(c, torch.Tensor)}
    if not devices or devices == {torch.device("cpu")}:
        return None
    if len(devices) > 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"the RNG takes counters on one CPU or CUDA "
                         f"device, not {sorted(map(str, devices))}")
    return next(iter(devices))


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launch(name: str, counters, k: int, device: torch.device):
    """Launch ``tpt_<name>`` on the four counters; returns its ``k`` output
    rows, each a contiguous float32 tensor of the counters' broadcast
    shape. A tensor counter is passed by pointer (per lane, or one element
    broadcast); an int by value as its low 32 bits."""
    from . import _kernels
    shape = torch.broadcast_shapes(
        *(c.shape for c in counters if isinstance(c, torch.Tensor)))
    n = shape.numel()
    # ``keep`` holds the converted counters until the launch is queued:
    # freed earlier, their memory could become ``out``'s.
    args, keep = [], []
    for c in counters:
        if not isinstance(c, torch.Tensor):
            args += [None, 0, int(c) & _M32]
            continue
        c = c.to(torch.int64)
        if c.numel() != 1:
            c = c.expand(shape).contiguous()
        keep.append(c)
        args += [c.data_ptr(), int(c.numel() != 1), 0]
    ld = -(-max(n, 1) // _ROW_ALIGN) * _ROW_ALIGN
    out = torch.empty((k, ld), dtype=torch.float32, device=device)
    if n:
        extra = (k,) if name == "uniform" else ()
        _kernels.launch(f"tpt_{name}", *args, *extra, n, ld, out.data_ptr(),
                        _stream(device))
        LAUNCHES[name] += 1
    return tuple(out[r, :n].view(shape) for r in range(k))


def _uniform(k: int, counters):
    device = _card(counters)
    if device is not None:
        return _launch("uniform", counters, k, device)
    return tuple(_to_unit_float(u) for u in pcg4d(*counters)[:k])


def uniform4(pixel, sample, frame, stream):
    """Four independent uniforms in [0, 1) for the counter tuple."""
    return _uniform(4, (pixel, sample, frame, stream))


def uniform2(pixel, sample, frame, stream):
    return _uniform(2, (pixel, sample, frame, stream))


# Stream-id layout for one render pass (same ids as the JAX package).
STREAM_JITTER = 0          # camera sub-pixel jitter (2 draws)
STREAM_BOUNCE_A = 1        # per-depth d: stream = STREAM_BOUNCE_A + 2*d
STREAM_BOUNCE_B = 2        # per-depth d: stream = STREAM_BOUNCE_B + 2*d


def bounce_streams(depth):
    """Stream ids for the two pcg4d calls at a given bounce depth."""
    return STREAM_BOUNCE_A + 2 * depth, STREAM_BOUNCE_B + 2 * depth


def bounce_uniforms(pixel, sample, frame, depth):
    """The six uniforms of one path-trace bounce at ``depth`` (an int or a
    per-lane tensor): ``(z1, z2, z3)``, the first three of the draw on
    stream ``STREAM_BOUNCE_A + 2 depth``, and ``(lz1, lz2, z_rr)``, the
    first three on ``STREAM_BOUNCE_B + 2 depth``. On the card both draws
    are one launch."""
    counters = (pixel, sample, frame, depth)
    device = _card(counters)
    if device is not None:
        return _launch("bounce_uniforms", counters, 6, device)
    sa, sb = bounce_streams(depth)
    z1, z2, z3, _ = uniform4(pixel, sample, frame, sa)
    lz1, lz2, z_rr, _ = uniform4(pixel, sample, frame, sb)
    return z1, z2, z3, lz1, lz2, z_rr
