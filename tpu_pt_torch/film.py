"""Film: progressive accumulation, sRGB tonemapping, image IO, RMSE
(counterpart of ``tpu_pt/film.py``).

- progressive running mean (``pathTracerPrograms.cu:803-811``)
- sRGB tonemap + 8-bit quantisation (``cuda/helpers.h:35-62``)
- dependency-free image IO on the host (numpy): PNG read/write (RGBA for
  textures), PPM read/write, and scanline OpenEXR read/write with the
  NO_COMPRESSION, RLE, ZIPS and ZIP codecs. The EXR PIZ codec and JPEG
  are not ported yet (ROADMAP.md): ``write_exr(..., "piz")`` and reading a
  PIZ block raise.
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


def _png_channels(data: bytes, name: str = "PNG") -> np.ndarray:
    """Decode a non-interlaced 8-bit PNG (gray, gray+alpha, RGB or RGBA)
    held in memory. Returns uint8 [H, W, channels]."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{name}: not a PNG")
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
                raise ValueError(f"{name}: unsupported PNG format")
            channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    img = _unfilter_scanlines(zlib.decompress(idat), h, w, channels)
    return img.reshape(h, w, channels)


def read_png(path: str) -> np.ndarray:
    """Read a non-interlaced 8-bit PNG (gray, gray+alpha, RGB or RGBA).
    Returns uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        img = _png_channels(f.read(), path)
    if img.shape[2] < 3:                 # gray (+ alpha) -> RGB
        img = np.repeat(img[:, :, :1], 3, axis=2)
    return img[:, :, :3]


def png_rgba(data: bytes, name: str = "PNG") -> np.ndarray:
    """A PNG held in memory as uint8 [H, W, 4], alpha kept (255 where the
    file has none): the texture path of glTF materials, whose base-color
    alpha drives alpha masking and blending."""
    img = _png_channels(data, name)
    h, w, c = img.shape
    out = np.full((h, w, 4), 255, np.uint8)
    if c == 1:
        out[:, :, :3] = np.repeat(img, 3, axis=2)
    elif c == 2:
        out[:, :, :3] = np.repeat(img[:, :, :1], 3, axis=2)
        out[:, :, 3] = img[:, :, 1]
    else:
        out[:, :, :c] = img
    return out


def read_png_rgba(path: str) -> np.ndarray:
    """Like :func:`read_png` but keeps the alpha channel (255 when the
    file has none). Returns uint8 [H, W, 4]
    (``tpu_pt.film.read_png_rgba``)."""
    with open(path, "rb") as f:
        return png_rgba(f.read(), path)


def read_ppm(path: str) -> np.ndarray:
    """Read a P6 (binary) or P3 (ascii) PPM (``sutil::PPMLoader`` parity).
    Returns uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    # Header tokens, skipping comments.
    tokens = []
    pos = 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.find(b"\n", pos) + 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    magic, w, h, maxval = (tokens[0], int(tokens[1]), int(tokens[2]),
                           int(tokens[3]))
    pos += 1  # single whitespace after maxval
    if magic == b"P6":
        img = np.frombuffer(data, np.uint8, w * h * 3, pos)
    elif magic == b"P3":
        vals = data[pos:].split()
        img = np.array(vals[: w * h * 3], np.int64).astype(np.uint8)
    else:
        raise ValueError(f"unsupported PPM magic {magic!r}")
    if maxval != 255:
        img = (img.astype(np.float32) * (255.0 / maxval)).astype(np.uint8)
    return img.reshape(h, w, 3).copy()


def write_ppm(path: str, rgb_u8: np.ndarray) -> None:
    """Binary PPM writer (``sutil::saveImage`` PPM parity)."""
    img = np.ascontiguousarray(np.asarray(rgb_u8, np.uint8))
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


# --------------------------------------------------------------------------
# OpenEXR (float HDR) IO: the reference vendors tinyexr for this
# (``support/tinyexr``, used by ``sutil::loadImage``); here a
# dependency-free subset: scanline images, FLOAT or HALF channels.
# --------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_EXR_PT_UINT, _EXR_PT_HALF, _EXR_PT_FLOAT = 0, 1, 2
_EXR_COMP = {"none": 0, "rle": 1, "zips": 2, "zip": 3}   # lines/block 1,1,1,16
_EXR_PIZ = 4
_PIZ_TODO = ("the EXR PIZ codec is not ported yet (ROADMAP.md); use none, "
             "rle, zips or zip")


def _exr_predict(data: bytes) -> np.ndarray:
    """The OpenEXR compressors' pre-pass: reorder the bytes into two
    halves, then delta-encode (+128 bias). ZIP deflates the result; RLE
    run-length-packs it."""
    arr = np.frombuffer(data, np.uint8)
    half = (arr.size + 1) // 2
    reordered = np.empty(arr.size, np.uint8)
    reordered[:half] = arr[0::2]
    reordered[half:] = arr[1::2]
    enc = reordered.copy()
    enc[1:] -= reordered[:-1]
    enc[1:] += 128                                # uint8 wraps mod 256
    return enc


def _exr_unpredict(enc: np.ndarray) -> bytes:
    enc = enc.copy()
    enc[1:] += 128                                # undo the +128 bias: -128
    rec = np.cumsum(enc, dtype=np.uint8)
    half = (rec.size + 1) // 2
    out = np.empty(rec.size, np.uint8)
    out[0::2] = rec[:half]
    out[1::2] = rec[half:]
    return out.tobytes()


def _exr_rle_encode(data: bytes) -> bytes:
    """OpenEXR RLE (ImfRle.cpp scheme): the pre-pass, then runs of >= 3
    equal bytes stored as (count - 1, byte) with count <= 128 and literal
    spans as (-len, bytes...) with len <= 127. Run boundaries are found
    vectorised; only the emit loop walks the (far shorter) span list."""
    src = _exr_predict(data)
    n = src.size
    if n == 0:
        return b""
    starts = np.concatenate([[0], np.flatnonzero(np.diff(src)) + 1])
    lens = np.diff(np.concatenate([starts, [n]]))
    srcb = src.tobytes()
    out = bytearray()
    lit_s, lit_n = -1, 0                        # open literal span

    def flush_literals():
        nonlocal lit_s, lit_n
        p = lit_s
        while lit_n > 0:
            take = min(lit_n, 127)
            out.append(256 - take)              # -len, two's complement
            out.extend(srcb[p:p + take])
            p += take
            lit_n -= take
        lit_s = -1

    for s, ln in zip(starts.tolist(), lens.tolist()):
        if ln >= 3:
            flush_literals()
            b = srcb[s:s + 1]
            while ln > 0:
                take = min(ln, 128)
                if take < 3:                    # tail too short for a run
                    if lit_s < 0:
                        lit_s = s
                    lit_n += take
                    break
                out.append(take - 1)
                out.extend(b)
                s += take
                ln -= take
        else:
            if lit_s < 0:
                lit_s = s
            lit_n += ln
    flush_literals()
    return bytes(out)


def _exr_rle_decode(data: bytes, expect: int) -> bytes:
    """Inverse of :func:`_exr_rle_encode` (any conformant OpenEXR RLE
    stream); a block that decodes short raises."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expect:
        c = data[i]
        i += 1
        if c >= 128:                              # negative: literal span
            ln = 256 - c
            out.extend(data[i:i + ln])
            i += ln
        else:                                     # run of c + 1 bytes
            out.extend(data[i:i + 1] * (c + 1))
            i += 1
    if len(out) < expect:
        raise ValueError(
            f"EXR RLE block decoded {len(out)} of {expect} bytes")
    return _exr_unpredict(np.frombuffer(bytes(out[:expect]), np.uint8))


def write_exr(path: str, rgb: np.ndarray, half: bool = False,
              compression: str = "none") -> None:
    """Write a linear float RGB image as a scanline EXR.

    ``rgb`` is [H, W, 3] float; ``half`` selects HALF (float16) channels;
    ``compression`` is ``"none"``, ``"rle"``, ``"zips"`` (ZIP, 1
    scanline per block) or ``"zip"`` (ZIP, 16 scanlines per block);
    ``"piz"`` raises (not ported yet). Channels are stored B, G, R
    (alphabetical, as EXR requires). Incompressible blocks are stored
    raw, as the format prescribes."""
    if compression == "piz":
        raise NotImplementedError(_PIZ_TODO)
    img = np.asarray(rgb, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {img.shape}")
    comp = _EXR_COMP[compression]
    lines_per_block = 16 if comp == 3 else 1
    h, w, _ = img.shape
    ptype = _EXR_PT_HALF if half else _EXR_PT_FLOAT
    dtype = np.dtype("<f2") if half else np.dtype("<f4")

    def attr(name: bytes, typ: bytes, data: bytes) -> bytes:
        return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data

    chans = b""
    for ch in (b"B", b"G", b"R"):
        chans += ch + b"\0" + struct.pack("<i", ptype) + b"\0\0\0\0"
        chans += struct.pack("<ii", 1, 1)
    chans += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        attr(b"channels", b"chlist", chans)
        + attr(b"compression", b"compression", bytes([comp]))
        + attr(b"dataWindow", b"box2i", box)
        + attr(b"displayWindow", b"box2i", box)
        + attr(b"lineOrder", b"lineOrder", b"\0")
        + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\0"
    )
    preamble = struct.pack("<ii", _EXR_MAGIC, 2) + header
    bgr = img[:, :, ::-1].astype(dtype)           # scanlines store B, G, R
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    payloads = []
    for b in range(n_blocks):
        rows = bgr[b * lines_per_block:(b + 1) * lines_per_block]
        raw = b"".join(row.tobytes(order="F") for row in rows)
        if comp == 1:
            z = _exr_rle_encode(raw)
        elif comp:
            z = zlib.compress(_exr_predict(raw).tobytes(), 6)
        else:
            z = raw
        payloads.append(z if len(z) < len(raw) else raw)
    with open(path, "wb") as f:
        f.write(preamble)
        off = len(preamble) + 8 * n_blocks
        for payload in payloads:
            f.write(struct.pack("<Q", off))
            off += 8 + len(payload)
        for b, payload in enumerate(payloads):
            f.write(struct.pack("<ii", b * lines_per_block, len(payload)))
            f.write(payload)


def read_exr(path: str) -> np.ndarray:
    """Read a single-part scanline EXR with FLOAT / HALF / UINT channels
    and NO_COMPRESSION, RLE, ZIPS or ZIP blocks (a PIZ block raises).
    Returns [H, W, 3] float32 (R, G, B), or the channels in file order
    when R, G and B are not all present."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _EXR_MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")
    pos = 8
    attrs = {}
    while buf[pos] != 0:
        e = buf.index(b"\0", pos)
        name = buf[pos:e].decode()
        pos = e + 1
        e = buf.index(b"\0", pos)
        typ = buf[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (typ, buf[pos:pos + size])
        pos += size
    pos += 1

    comp = attrs["compression"][1][0]
    if comp not in (0, 1, 2, 3, _EXR_PIZ):
        raise ValueError(f"unsupported EXR compression {comp} (none, rle, "
                         "zips, zip)")
    lines_per_block = {3: 16, _EXR_PIZ: 32}.get(comp, 1)
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    chans = []
    cb = attrs["channels"][1]
    cpos = 0
    while cb[cpos] != 0:
        e = cb.index(b"\0", cpos)
        (ptype,) = struct.unpack_from("<i", cb, e + 1)
        chans.append((cb[cpos:e].decode(), ptype))
        cpos = e + 1 + 16
    dtypes = {_EXR_PT_HALF: np.dtype("<f2"), _EXR_PT_FLOAT: np.dtype("<f4"),
              _EXR_PT_UINT: np.dtype("<u4")}
    line_bytes = sum(w * dtypes[pt].itemsize for _, pt in chans)

    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)
    out = {}
    for off in offsets:
        y, nbytes = struct.unpack_from("<ii", buf, off)
        lines = min(lines_per_block, h - (y - y0))
        raw_size = lines * line_bytes
        data = buf[off + 8:off + 8 + nbytes]
        if comp and nbytes < raw_size:        # raw-stored blocks pass through
            if comp == _EXR_PIZ:
                raise NotImplementedError(_PIZ_TODO)
            if comp == 1:
                data = _exr_rle_decode(data, raw_size)
            else:
                data = _exr_unpredict(
                    np.frombuffer(zlib.decompress(data), np.uint8))
        p = 0
        for li in range(lines):
            for cname, ptype in chans:        # stored alphabetically
                dt = dtypes[ptype]
                row = np.frombuffer(data, dt, w, p).astype(np.float32)
                out.setdefault(cname,
                               np.zeros((h, w), np.float32))[y - y0 + li] = row
                p += w * dt.itemsize
    if all(c in out for c in "RGB"):
        return np.stack([out["R"], out["G"], out["B"]], axis=2)
    return np.stack([out[c] for c, _ in chans], axis=2)


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
