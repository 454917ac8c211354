"""Film: progressive accumulation, sRGB tonemapping, PNG IO, RMSE
(counterpart of ``tpu_pt/film.py:29-210``; EXR, PPM and JPEG are not
ported yet).

- progressive running mean (``pathTracerPrograms.cu:803-811``)
- sRGB tonemap + 8-bit quantisation (``cuda/helpers.h:35-62``)
- dependency-free PNG read/write (host numpy)
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def accumulate(prev_accum: torch.Tensor, frame_mean: torch.Tensor,
               frame_idx: int) -> torch.Tensor:
    """Running mean across frames: frame 0 overwrites, frame k > 0 lerps
    with a = 1/(k+1). Returns a new tensor."""
    if frame_idx <= 0:
        return frame_mean.clone()
    a = float(np.float32(1.0) / (np.float32(frame_idx) + np.float32(1.0)))
    return prev_accum + (frame_mean - prev_accum) * a


def to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB transfer (``cuda/helpers.h:35-43``)."""
    lo = 12.92 * c
    hi = 1.055 * torch.pow(torch.clamp_min(c, 1e-10), 1.0 / 2.4) - 0.055
    return torch.where(c < 0.0031308, lo, hi)


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 1], then min(uint(x*256), 255) (``cuda/helpers.h:50-55``)."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.clamp_max((x * 256.0).to(torch.int32), 255).to(torch.uint8)


def make_color(c: torch.Tensor) -> torch.Tensor:
    """Linear float RGB [..., 3] -> sRGB uint8 [..., 3] (``cuda/helpers.h:57-62``)."""
    return quantize_u8(to_srgb(torch.clamp(c, 0.0, 1.0)))


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Per-pixel RMSE between two float images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write an 8-bit RGB or RGBA PNG."""
    img = np.ascontiguousarray(np.asarray(rgb_u8, np.uint8))
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"write_png wants [H, W, 3|4] uint8, got {img.shape}")
    h, w, c = img.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        data = tag + payload
        return struct.pack(">I", len(payload)) + data + struct.pack(
            ">I", zlib.crc32(data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a non-interlaced 8-bit PNG (gray, gray+alpha, RGB or RGBA).
    Returns uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    w = h = None
    channels = 3
    idat = b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, bits, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if bits != 8 or interlace != 0 or ctype not in (0, 2, 4, 6):
                raise ValueError(f"{path}: unsupported PNG format")
            channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    img = _unfilter_scanlines(zlib.decompress(idat), h, w, channels)
    img = img.reshape(h, w, channels)
    if channels < 3:                     # gray (+ alpha) -> RGB
        img = np.repeat(img[:, :, :1], 3, axis=2)
    return img[:, :, :3]


def _unfilter_scanlines(raw: bytes, h: int, w: int,
                        channels: int) -> np.ndarray:
    """Undo per-row PNG filtering -> uint8 [h, w * channels]."""
    stride = w * channels
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for row in range(h):
        filt = rows[row, 0]
        line = rows[row, 1:].copy()
        if filt == 0:
            pass
        elif filt == 1:   # Sub: a cumulative sum mod 256 per channel
            line = np.cumsum(line.reshape(w, channels), axis=0,
                             dtype=np.uint8).reshape(stride)
        elif filt == 2:   # Up
            line += prev
        elif filt == 3:   # Average: serial left dependency
            ln = line.reshape(w, channels).astype(np.int32)
            pv = prev.reshape(w, channels).astype(np.int32)
            left = np.zeros(channels, np.int32)
            for x in range(w):
                left = (ln[x] + ((left + pv[x]) >> 1)) & 0xFF
                ln[x] = left
            line = ln.astype(np.uint8).reshape(stride)
        elif filt == 4:   # Paeth: serial left dependency
            ln = line.reshape(w, channels).astype(np.int32)
            pv = prev.reshape(w, channels).astype(np.int32)
            a = np.zeros(channels, np.int32)
            c = np.zeros(channels, np.int32)
            for x in range(w):
                b = pv[x]
                p = a + b - c
                pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                pred = np.where((pa <= pb) & (pa <= pc), a,
                                np.where(pb <= pc, b, c))
                a = (ln[x] + pred) & 0xFF
                ln[x] = a
                c = b
            line = ln.astype(np.uint8).reshape(stride)
        else:
            raise ValueError(f"bad PNG filter {filt}")
        out[row] = line
        prev = line
    return out
