"""Film: progressive accumulation, sRGB tonemapping, image IO, RMSE
(counterpart of ``tpu_pt/film.py``).

- progressive running mean (``pathTracerPrograms.cu:803-811``)
- sRGB tonemap + 8-bit quantisation (``cuda/helpers.h:35-62``)
- dependency-free image IO on the host (numpy): PNG read/write (RGBA for
  textures), PPM and JPEG read/write (``jpeg``), and scanline OpenEXR
  read/write with the NO_COMPRESSION, RLE, ZIPS, ZIP and PIZ codecs.
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


def write_jpeg(path: str, rgb_u8: np.ndarray, quality: int = 90) -> None:
    """Write a baseline JPEG (``tpu_pt.film.write_jpeg``; ``jpeg``)."""
    from . import jpeg
    with open(path, "wb") as f:
        f.write(jpeg.encode_jpeg(np.asarray(rgb_u8, np.uint8), quality))


def read_jpeg(path: str) -> np.ndarray:
    """Read a baseline or progressive JPEG to uint8 [H, W, 3]."""
    from . import jpeg
    with open(path, "rb") as f:
        return jpeg.decode_jpeg(f.read())


def read_ppm(path: str) -> np.ndarray:
    """Read a P6 (binary) or P3 (ascii) PPM (``sutil::PPMLoader`` parity).
    Returns uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        return ppm_rgb(f.read())


def ppm_rgb(data: bytes) -> np.ndarray:
    """A P6 or P3 PPM held in memory as uint8 [H, W, 3]."""
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
# lines per block: 1, 1, 1, 16, 32
_EXR_COMP = {"none": 0, "rle": 1, "zips": 2, "zip": 3, "piz": 4}
_EXR_PIZ = 4


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


# --------------------------------------------------------------------------
# PIZ compression (OpenEXR's wavelet + Huffman scheme, the default of many
# DCC tools), the port's own copy of ``tpu_pt/film.py``'s codec (host-side
# numpy): the format's published algorithm, channel-planar u16 reorder,
# bitmap value compaction, the 14/16-bit 2-D wavelet, canonical Huffman
# with a run-length pseudo-symbol.

_PIZ_SHORT_ZERORUN = 59       # packed-code-length zero-run escapes
_PIZ_LONG_ZERORUN = 63
_PIZ_SHORTEST_LONG_RUN = 2 + _PIZ_LONG_ZERORUN - _PIZ_SHORT_ZERORUN  # 6
_PIZ_ENCSIZE = 65537          # 64k symbols + the run-length code


def _piz_wenc(a, b, w14):
    """One wavelet butterfly (encode): (a, b) -> (low, high) u16."""
    if w14:
        av = a.astype(np.int16).astype(np.int32)
        bv = b.astype(np.int16).astype(np.int32)
        m = (av + bv) >> 1
        d = av - bv
        return (m.astype(np.int16).astype(np.uint16),
                d.astype(np.int16).astype(np.uint16))
    ao = (a.astype(np.int64) + 32768) & 65535
    bv = b.astype(np.int64)
    m = (ao + bv) >> 1
    d = ao - bv
    m = np.where(d < 0, (m + 32768) & 65535, m)
    return m.astype(np.uint16), (d & 65535).astype(np.uint16)


def _piz_wdec(l, h, w14):
    """Inverse butterfly: (low, high) -> (a, b) u16."""
    if w14:
        ls = l.astype(np.int16).astype(np.int32)
        hi = h.astype(np.int16).astype(np.int32)
        ai = ls + (hi & 1) + (hi >> 1)
        return (ai.astype(np.int16).astype(np.uint16),
                (ai - hi).astype(np.int16).astype(np.uint16))
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    b = (m - (d >> 1)) & 65535
    a = (d + b - 32768) & 65535
    return a.astype(np.uint16), b.astype(np.uint16)


def _piz_wav2(a, mx, encode):
    """In-place 2-D wavelet (ImfWav scheme) over u16 [ny, nx]."""
    ny, nx = a.shape
    n = min(nx, ny)
    w14 = mx < (1 << 14)
    levels = []
    p, p2 = 1, 2
    while p2 <= n:
        levels.append((p, p2))
        p, p2 = p2, p2 * 2
    if not encode:
        levels.reverse()
    for p, p2 in levels:
        rows = np.arange(0, ny - p2 + 1, p2)
        cols = np.arange(0, nx - p2 + 1, p2)
        r = rows[:, None]
        c = cols[None, :]
        # The odd remainder column/row sits one step past the quads.
        cx = (cols[-1] + p2) if cols.size else 0
        ry = (rows[-1] + p2) if rows.size else 0
        if encode:
            if rows.size and cols.size:
                a00, a01 = a[r, c], a[r, c + p]
                a10, a11 = a[r + p, c], a[r + p, c + p]
                i00, i01 = _piz_wenc(a00, a01, w14)
                i10, i11 = _piz_wenc(a10, a11, w14)
                a[r, c], a[r + p, c] = _piz_wenc(i00, i10, w14)
                a[r, c + p], a[r + p, c + p] = _piz_wenc(i01, i11, w14)
            if (nx & p) and rows.size:
                l, h = _piz_wenc(a[rows, cx], a[rows + p, cx], w14)
                a[rows, cx], a[rows + p, cx] = l, h
            if (ny & p) and cols.size:
                l, h = _piz_wenc(a[ry, cols], a[ry, cols + p], w14)
                a[ry, cols], a[ry, cols + p] = l, h
        else:
            if rows.size and cols.size:
                i00, i10 = _piz_wdec(a[r, c], a[r + p, c], w14)
                i01, i11 = _piz_wdec(a[r, c + p], a[r + p, c + p], w14)
                a[r, c], a[r, c + p] = _piz_wdec(i00, i01, w14)
                a[r + p, c], a[r + p, c + p] = _piz_wdec(i10, i11, w14)
            if (nx & p) and rows.size:
                x, y = _piz_wdec(a[rows, cx], a[rows + p, cx], w14)
                a[rows, cx], a[rows + p, cx] = x, y
            if (ny & p) and cols.size:
                x, y = _piz_wdec(a[ry, cols], a[ry, cols + p], w14)
                a[ry, cols], a[ry, cols + p] = x, y


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, nbits, value):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)

    def flush(self):
        if self.n:
            self.out.append((self.acc << (8 - self.n)) & 0xFF)
            self.acc = self.n = 0
        return bytes(self.out)


class _BitReader:
    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.n = 0

    def get(self, nbits):
        while self.n < nbits:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc = (self.acc << 8) | b
            self.n += 8
        self.n -= nbits
        v = (self.acc >> self.n) & ((1 << nbits) - 1)
        self.acc &= (1 << self.n) - 1
        return v


def _piz_canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """OpenEXR canonical code assignment: same-length codes get
    consecutive values, allocated longest-first (ImfHuf scheme)."""
    n = np.zeros(59, np.int64)
    for ln in lengths[lengths > 0]:
        n[ln] += 1
    c = 0
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        n[i] = c
        c = nc
    codes = np.zeros(lengths.shape[0], np.int64)
    for i in np.flatnonzero(lengths > 0):
        ln = lengths[i]
        codes[i] = n[ln]
        n[ln] += 1
    return codes


def _piz_code_lengths(freq: np.ndarray):
    """Huffman code lengths over the nonzero-frequency symbols plus the
    run-length pseudo-symbol. Returns (lengths, im, iM) where iM is the
    pseudo-symbol's index (max nonzero + 1, ImfHuf parity)."""
    import heapq
    nz = np.flatnonzero(freq)
    im = int(nz[0]) if nz.size else 0
    i_max = int(nz[-1]) if nz.size else 0
    rlc = i_max + 1                       # run-length pseudo-symbol
    syms = list(nz) + [rlc]
    lengths = np.zeros(_PIZ_ENCSIZE, np.int64)
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths, im, rlc
    # Heap of (freq, tiebreak, [symbols]); each merge deepens both sides.
    heap = [(int(freq[s]) if s != rlc else 1, s, [s]) for s in syms]
    heapq.heapify(heap)
    while len(heap) > 1:
        fa, ta, sa = heapq.heappop(heap)
        fb, tb, sb = heapq.heappop(heap)
        for s in sa + sb:
            lengths[s] += 1
        heapq.heappush(heap, (fa + fb, min(ta, tb), sa + sb))
    while lengths.max() > 58:             # depth limit (rare): flatten
        lengths[lengths > 1] -= 1
    return lengths, im, rlc


def _piz_pack_lengths(lengths, im, iM) -> bytes:
    """6-bit code lengths with zero-run escapes (hufPackEncTable)."""
    w = _BitWriter()
    i = im
    while i <= iM:
        ln = int(lengths[i])
        if ln == 0:
            zerun = 1
            j = i
            while (j < iM and zerun < 255 + _PIZ_SHORTEST_LONG_RUN
                   and lengths[j + 1] == 0):
                j += 1
                zerun += 1
            if zerun >= 2:
                if zerun >= _PIZ_SHORTEST_LONG_RUN:
                    w.put(6, _PIZ_LONG_ZERORUN)
                    w.put(8, zerun - _PIZ_SHORTEST_LONG_RUN)
                else:
                    w.put(6, _PIZ_SHORT_ZERORUN + zerun - 2)
                i = j + 1
                continue
        w.put(6, ln)
        i += 1
    return w.flush()


def _piz_unpack_lengths(r: _BitReader, im, iM) -> np.ndarray:
    lengths = np.zeros(_PIZ_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        ln = r.get(6)
        if ln == _PIZ_LONG_ZERORUN:
            i += r.get(8) + _PIZ_SHORTEST_LONG_RUN
        elif ln >= _PIZ_SHORT_ZERORUN:
            i += ln - _PIZ_SHORT_ZERORUN + 2
        else:
            lengths[i] = ln
            i += 1
    return lengths


def _piz_huf_compress(raw: np.ndarray) -> bytes:
    """hufCompress: header, packed code-length table, coded data."""
    freq = np.bincount(raw, minlength=_PIZ_ENCSIZE).astype(np.int64)
    lengths, im, rlc = _piz_code_lengths(freq)
    codes = _piz_canonical_codes(lengths)
    table = _piz_pack_lengths(lengths, im, rlc)

    w = _BitWriter()

    def put_code(s):
        w.put(int(lengths[s]), int(codes[s]))

    i = 0
    n = raw.shape[0]
    vals = raw.tolist()
    while i < n:
        s = vals[i]
        run = 0
        while i + run + 1 < n and vals[i + run + 1] == s and run < 255:
            run += 1
        # A run emits symbol + rlc + 8-bit count when cheaper.
        if (run and lengths[s] + lengths[rlc] + 8 <
                lengths[s] * (run + 1)):
            put_code(s)
            put_code(rlc)
            w.put(8, run)
        else:
            for _ in range(run + 1):
                put_code(s)
        i += run + 1
    n_bits = w.n + 8 * len(w.out)
    data = w.flush()
    head = struct.pack("<IIIII", im, rlc, len(table), n_bits, 0)
    return head + table + data


def _piz_huf_decompress(buf: bytes, n_out: int) -> np.ndarray:
    im, iM, table_len, n_bits, _ = struct.unpack_from("<IIIII", buf, 0)
    r = _BitReader(buf[20:20 + table_len])
    lengths = _piz_unpack_lengths(r, im, iM)
    codes = _piz_canonical_codes(lengths)
    # Decode table {(len, code): symbol}; bit-serial decode (max 58).
    dec = {(int(lengths[s]), int(codes[s])): int(s)
           for s in np.flatnonzero(lengths > 0)}
    # Coded data starts right after the (byte-aligned) packed table.
    data = _BitReader(buf[20 + table_len:])
    out = np.empty(n_out, np.uint16)
    k = 0
    c = 0
    ln = 0
    rlc = iM
    bits_read = 0
    while k < n_out:
        if bits_read >= n_bits + 8:
            raise ValueError("EXR PIZ: Huffman stream exhausted early")
        c = (c << 1) | data.get(1)
        bits_read += 1
        ln += 1
        s = dec.get((ln, c))
        if s is None:
            if ln > 58:
                raise ValueError("EXR PIZ: invalid Huffman code")
            continue
        if s == rlc:
            if k == 0:
                raise ValueError("EXR PIZ: run-length code first")
            cnt = data.get(8)
            bits_read += 8
            if k + cnt > n_out:
                raise ValueError("EXR PIZ: run overflows output")
            out[k:k + cnt] = out[k - 1]
            k += cnt
        else:
            out[k] = s
            k += 1
        c = 0
        ln = 0
    return out


def _piz_channel_views(chans, ny):
    """Per-channel (nx, size-in-u16s, rows) layout for a PIZ block."""
    return [(nx, size, ny) for nx, size in chans]


def _exr_piz_encode(raw: bytes, chans, ny: int) -> bytes:
    """PIZ-compress one scanline block.

    ``raw`` is the uncompressed block (scanline-major, channels in
    header order within each scanline); ``chans`` is [(width,
    size_in_u16s), ...] per channel; ``ny`` the scanline count."""
    u16 = np.frombuffer(raw, "<u2").copy()
    # Reorder scanline-major -> channel-planar (ImfPizCompressor's
    # ChannelData copy): plane k is [ny, nx*size] u16.
    row_u16 = sum(nx * size for nx, size in chans)
    planes = []
    pos = 0
    rows = u16.reshape(ny, row_u16)
    for nx, size in chans:
        planes.append(rows[:, pos:pos + nx * size].copy())
        pos += nx * size
    flat = np.concatenate([p.reshape(-1) for p in planes])

    # Bitmap of present values; zero is never stored. (packbits, NOT a
    # fancy-indexed |= — duplicate byte indices don't accumulate.)
    present = np.zeros(65536, bool)
    present[flat] = True
    present[0] = False
    bitmap = np.packbits(present.astype(np.uint8), bitorder="little")
    # Forward LUT: dense index per present value (0 always present).
    lut_src = np.flatnonzero(np.concatenate(([True], present[1:])))
    max_value = lut_src.size - 1
    fwd = np.zeros(65536, np.uint16)
    fwd[lut_src] = np.arange(lut_src.size, dtype=np.uint16)

    off = 0
    out_planes = []
    for nx, size in chans:
        plane = fwd[flat[off:off + ny * nx * size]].reshape(ny, nx * size)
        off += ny * nx * size
        for j in range(size):
            view = plane[:, j::size].copy()
            _piz_wav2(view, max_value, encode=True)
            plane[:, j::size] = view
        out_planes.append(plane.reshape(-1))
    coded = _piz_huf_compress(np.concatenate(out_planes))

    nz = np.flatnonzero(bitmap)
    min_nz = int(nz[0]) if nz.size else 8191
    max_nz = int(nz[-1]) if nz.size else 0
    head = struct.pack("<HH", min_nz, max_nz)
    if min_nz <= max_nz:
        head += bitmap[min_nz:max_nz + 1].tobytes()
    return head + struct.pack("<I", len(coded)) + coded


def _exr_piz_decode(data: bytes, chans, ny: int) -> bytes:
    """Inverse of :func:`_exr_piz_encode` (accepts any conformant
    OpenEXR PIZ block)."""
    min_nz, max_nz = struct.unpack_from("<HH", data, 0)
    pos = 4
    bitmap = np.zeros(8192, np.uint8)
    if min_nz <= max_nz:
        n = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(data, np.uint8, n, pos)
        pos += n
    (coded_len,) = struct.unpack_from("<I", data, pos)
    pos += 4

    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1                                  # zero always present
    rev = np.flatnonzero(bits).astype(np.uint16)  # dense index -> value
    max_value = rev.size - 1

    n_u16 = ny * sum(nx * size for nx, size in chans)
    flat = _piz_huf_decompress(data[pos:pos + coded_len], n_u16)

    row_u16 = sum(nx * size for nx, size in chans)
    out = np.empty((ny, row_u16), np.uint16)
    off = 0
    col = 0
    for nx, size in chans:
        plane = flat[off:off + ny * nx * size].reshape(ny, nx * size).copy()
        off += ny * nx * size
        for j in range(size):
            view = plane[:, j::size].copy()
            _piz_wav2(view, max_value, encode=False)
            plane[:, j::size] = view
        out[:, col:col + nx * size] = rev[plane]
        col += nx * size
    return out.tobytes()


def write_exr(path: str, rgb: np.ndarray, half: bool = False,
              compression: str = "none") -> None:
    """Write a linear float RGB image as a scanline EXR.

    ``rgb`` is [H, W, 3] float; ``half`` selects HALF (float16) channels;
    ``compression`` is ``"none"``, ``"rle"``, ``"zips"`` (ZIP, 1
    scanline per block), ``"zip"`` (ZIP, 16 scanlines per block) or
    ``"piz"`` (wavelet + Huffman, 32 scanlines per block). Channels are
    stored B, G, R (alphabetical, as EXR requires). Incompressible blocks
    are stored raw, as the format prescribes."""
    img = np.asarray(rgb, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {img.shape}")
    comp = _EXR_COMP[compression]
    lines_per_block = {3: 16, _EXR_PIZ: 32}.get(comp, 1)
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
        elif comp == _EXR_PIZ:
            # u16s per sample: 1 for HALF, 2 for FLOAT
            z = _exr_piz_encode(raw, [(w, 1 if half else 2)] * 3,
                                rows.shape[0])
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
    and NO_COMPRESSION, RLE, ZIPS, ZIP or PIZ blocks.
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
                         "zips, zip, piz)")
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
                data = _exr_piz_decode(
                    data, [(w, dtypes[pt].itemsize // 2) for _, pt in chans],
                    lines)
            elif comp == 1:
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
