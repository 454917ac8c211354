"""Baseline and progressive JPEG decoder and baseline encoder, without
dependencies: the port's own copy of ``tpu_pt/jpeg.py`` (host-side numpy).

glTF core mandates JPEG images; the reference decodes them through
tinygltf's stb_image (``sutil/Scene.cpp:267-550``). This implements the
baseline (SOF0) and extended-sequential (SOF1) DCT modes: marker parsing
and the inherently serial Huffman entropy decode run in Python with a
16-bit table-lookup bit reader; everything block-parallel (dequantize,
de-zigzag, IDCT, chroma upsample, YCbCr->RGB) is vectorized numpy over
all blocks at once.

Supported: grayscale and 3-component YCbCr, any sampling factors
(4:4:4 / 4:2:2 / 4:2:0 / ...), restart intervals, 8-bit precision,
and progressive (SOF2) mode: spectral selection + successive
approximation, DC/AC first and refinement scans, EOB runs.
Not supported: arithmetic coding, 12-bit, CMYK, hierarchical (SOF5+).
"""

from __future__ import annotations

import struct

import numpy as np

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

# 8x8 IDCT basis: A[u, x] = c(u)/2 * cos((2x+1) u pi / 16); block = A^T K A.
_IDCT_A = np.zeros((8, 8), np.float32)
for _u in range(8):
    _c = np.sqrt(0.125) if _u == 0 else 0.5
    for _x in range(8):
        _IDCT_A[_u, _x] = _c * np.cos((2 * _x + 1) * _u * np.pi / 16.0)


class _Huff:
    """Canonical Huffman table compiled to a 16-bit peek LUT."""

    __slots__ = ("sym", "ln")

    def __init__(self, counts, symbols):
        self.sym = np.zeros(1 << 16, np.uint8)
        self.ln = np.zeros(1 << 16, np.uint8)
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                lo = code << (16 - length)
                hi = lo + (1 << (16 - length))
                self.sym[lo:hi] = symbols[k]
                self.ln[lo:hi] = length
                code += 1
                k += 1
            code <<= 1


class _Bits:
    """MSB-first bit reader over destuffed entropy-coded bytes.

    Exhausted input pads with 1-bits (the JPEG byte-align fill value), so
    a final EOB that leans on padding still decodes.
    """

    __slots__ = ("buf", "i", "acc", "n")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.i = 0
        self.acc = 0
        self.n = 0

    def _fill(self, need: int) -> None:
        while self.n < need:
            b = self.buf[self.i] if self.i < len(self.buf) else 0xFF
            self.i += 1
            self.acc = (self.acc << 8) | b
            self.n += 8

    def huff(self, table: _Huff) -> int:
        self._fill(16)
        peek = (self.acc >> (self.n - 16)) & 0xFFFF
        length = table.ln[peek]
        if length == 0:
            raise ValueError("invalid JPEG Huffman code")
        self.n -= int(length)
        self.acc &= (1 << self.n) - 1
        return int(table.sym[peek])

    def receive(self, s: int) -> int:
        """Raw s bits, MSB-first (no EXTEND)."""
        if s == 0:
            return 0
        self._fill(s)
        v = (self.acc >> (self.n - s)) & ((1 << s) - 1)
        self.n -= s
        self.acc &= (1 << self.n) - 1
        return v

    def bit(self) -> int:
        return self.receive(1)

    def receive_extend(self, s: int) -> int:
        if s == 0:
            return 0
        v = self.receive(s)
        if v < (1 << (s - 1)):               # negative branch of EXTEND
            v -= (1 << s) - 1
        return v


def _destuff(seg: bytes) -> bytes:
    return seg.replace(b"\xff\x00", b"\xff")


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG to uint8 [H, W, 3] (grayscale replicated)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (missing SOI)")
    pos = 2
    qt: dict[int, np.ndarray] = {}
    huff_dc: dict[int, _Huff] = {}
    huff_ac: dict[int, _Huff] = {}
    frame = None
    restart_interval = 0
    out = None

    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:                    # EOI
            break
        (seglen,) = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2:pos + seglen]
        pos += seglen

        if marker == 0xDB:                    # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                if pq:
                    qt[tq] = np.frombuffer(seg, ">u2", 64, p).astype(np.int32)
                    p += 128
                else:
                    qt[tq] = np.frombuffer(seg, np.uint8, 64,
                                           p).astype(np.int32)
                    p += 64
        elif marker in (0xC0, 0xC1, 0xC2):    # SOF0 / SOF1 / SOF2
            prec, h, w, nc = struct.unpack_from(">BHHB", seg, 0)
            if prec != 8:
                raise ValueError(f"unsupported JPEG precision {prec}")
            comps = []
            for i in range(nc):
                cid, hv, tq = struct.unpack_from(">BBB", seg, 6 + 3 * i)
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
            frame = dict(h=h, w=w, comps=comps, prog=marker == 0xC2)
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise ValueError("only baseline/extended-sequential/"
                             "progressive JPEG supported "
                             f"(SOF marker 0x{marker:02X})")
        elif marker == 0xC4:                  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = list(seg[p + 1:p + 17])
                n = sum(counts)
                symbols = list(seg[p + 17:p + 17 + n])
                (huff_ac if tc else huff_dc)[th] = _Huff(counts, symbols)
                p += 17 + n
        elif marker == 0xDD:                  # DRI
            (restart_interval,) = struct.unpack(">H", seg)
        elif marker == 0xDA:                  # SOS
            if frame is None:
                raise ValueError("JPEG SOS before SOF")
            _init_coefs(frame)
            ns = seg[0]
            scan = []
            for i in range(ns):
                cs, tt = seg[1 + 2 * i], seg[2 + 2 * i]
                comp = next(c for c in frame["comps"] if c["id"] == cs)
                # AC-only progressive scans carry no DC table (and
                # vice versa); missing tables must not be an error.
                scan.append((comp, huff_dc.get(tt >> 4),
                             huff_ac.get(tt & 15)))
            p = 1 + 2 * ns
            ss, se, a = seg[p], seg[p + 1], seg[p + 2]
            ah, al = a >> 4, a & 15
            # Entropy-coded data runs until the next non-RST marker.
            end = pos
            while end < len(data) - 1:
                if (data[end] == 0xFF and data[end + 1] != 0x00
                        and not (0xD0 <= data[end + 1] <= 0xD7)):
                    break
                end += 1
            if frame["prog"]:
                _decode_scan_prog(data[pos:end], frame, scan,
                                  restart_interval, ss, se, ah, al)
            else:
                _decode_scan_seq(data[pos:end], frame, scan,
                                 restart_interval)
            out = True
            pos = end
    if out is None:
        raise ValueError("no JPEG scan decoded")
    return _reconstruct(frame, qt)


def _init_coefs(frame) -> None:
    """Allocate the per-component MCU-padded coefficient planes once
    (shared by sequential and progressive scans; progressive scans
    ACCUMULATE into them across multiple SOS segments)."""
    if "mcux" in frame:
        return
    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    frame["hmax"], frame["vmax"] = hmax, vmax
    frame["mcux"] = -(-frame["w"] // (8 * hmax))
    frame["mcuy"] = -(-frame["h"] // (8 * vmax))
    for c in comps:
        c["bw"] = frame["mcux"] * c["h"]      # blocks across, MCU-padded
        c["bh"] = frame["mcuy"] * c["v"]
        c["coef"] = np.zeros((c["bh"] * c["bw"], 64), np.int32)
        # Non-interleaved scans walk the component's OWN block grid
        # (ceil of its scaled dimensions), not the MCU-padded one.
        c["cbw"] = -(-(frame["w"] * c["h"]) // (8 * hmax))
        c["cbh"] = -(-(frame["h"] * c["v"]) // (8 * vmax))


def _rst_segments(ecs: bytes, restart_interval: int):
    """Split entropy data at restart markers (DC predictors and EOB
    runs reset per segment; the last segment may be short)."""
    if not restart_interval:
        return [ecs]
    segments = []
    s = 0
    i = 0
    while i < len(ecs) - 1:
        if ecs[i] == 0xFF and 0xD0 <= ecs[i + 1] <= 0xD7:
            segments.append(ecs[s:i])
            s = i + 2
            i += 2
        else:
            i += 1
    segments.append(ecs[s:])
    return segments


def _scan_units(frame, scan):
    """(unit count, per-unit block-row resolver) for a scan.

    Interleaved scans walk MCUs (h x v blocks per component);
    single-component scans walk that component's own block grid
    (JPEG A.2.2 — the non-interleaved case, mandatory for progressive
    AC scans and legal in baseline too)."""
    if len(scan) == 1:
        entry = scan[0]
        c = entry[0]
        cbw, bw = c["cbw"], c["bw"]

        def rows(unit):
            by, bx = divmod(unit, cbw)
            return ((entry, [by * bw + bx]),)
        return c["cbw"] * c["cbh"], rows

    mcux = frame["mcux"]

    def rows(unit):
        my, mx = divmod(unit, mcux)
        out = []
        for entry in scan:
            c = entry[0]
            rr = [(my * c["v"] + by) * c["bw"] + mx * c["h"] + bx
                  for by in range(c["v"]) for bx in range(c["h"])]
            out.append((entry, rr))
        return out
    return frame["mcux"] * frame["mcuy"], rows


def _decode_scan_seq(ecs: bytes, frame, scan, restart_interval: int):
    """Sequential (baseline) scan: full DC+AC per block."""
    n_units, unit_rows = _scan_units(frame, scan)
    unit = 0
    for seg in _rst_segments(ecs, restart_interval):
        bits = _Bits(_destuff(seg))
        preds = {id(c): 0 for c, _, _ in scan}
        seg_end = (min(unit + restart_interval, n_units)
                   if restart_interval else n_units)
        while unit < seg_end:
            for (c, dc, ac), rr in unit_rows(unit):
                for row in rr:
                    preds[id(c)] = _decode_block(
                        bits, dc, ac, preds[id(c)], c["coef"][row])
            unit += 1
        if unit >= n_units:
            break


def _decode_scan_prog(ecs: bytes, frame, scan, restart_interval: int,
                      ss: int, se: int, ah: int, al: int):
    """Progressive scan (JPEG G.1.2): DC/AC first or refinement pass
    over the spectral band [ss, se] at successive-approximation shift
    ``al``; coefficients accumulate into the frame's planes."""
    if ss == 0:
        if se != 0:
            raise ValueError("progressive DC scan with Se != 0")
    elif len(scan) != 1:
        raise ValueError("progressive AC scan must be single-component")
    n_units, unit_rows = _scan_units(frame, scan)
    unit = 0
    for seg in _rst_segments(ecs, restart_interval):
        bits = _Bits(_destuff(seg))
        preds = {id(c): 0 for c, _, _ in scan}
        eobrun = 0
        seg_end = (min(unit + restart_interval, n_units)
                   if restart_interval else n_units)
        while unit < seg_end:
            for (c, dc, ac), rr in unit_rows(unit):
                for row in rr:
                    coefs = c["coef"][row]
                    if ss == 0:
                        if ah == 0:           # DC first
                            t = bits.huff(dc)
                            preds[id(c)] += bits.receive_extend(t)
                            coefs[0] = preds[id(c)] << al
                        elif bits.bit():      # DC refinement
                            coefs[0] += 1 << al
                    elif ah == 0:
                        eobrun = _ac_first(bits, ac, coefs, ss, se, al,
                                           eobrun)
                    else:
                        eobrun = _ac_refine(bits, ac, coefs, ss, se, al,
                                            eobrun)
            unit += 1
        if unit >= n_units:
            break


def _ac_first(bits: _Bits, ac: _Huff, coefs: np.ndarray, ss: int,
              se: int, al: int, eobrun: int) -> int:
    """AC first pass (G.1.2.2): coefficients appear at magnitude
    << al; EOB runs skip whole bands of blocks."""
    if eobrun > 0:
        return eobrun - 1
    k = ss
    while k <= se:
        rs = bits.huff(ac)
        r, s = rs >> 4, rs & 15
        if s == 0:
            if r < 15:                        # EOBn: run of (1<<r)+bits
                eobrun = (1 << r) - 1
                if r:
                    eobrun += bits.receive(r)
                return eobrun
            k += 16                           # ZRL
            continue
        k += r
        if k > se:
            raise ValueError("JPEG AC index out of spectral band")
        coefs[k] = bits.receive_extend(s) << al
        k += 1
    return 0


def _ac_refine(bits: _Bits, ac: _Huff, coefs: np.ndarray, ss: int,
               se: int, al: int, eobrun: int) -> int:
    """AC refinement pass (G.1.2.3): appends one correction bit to
    every already-nonzero coefficient it passes and inserts new +-1
    coefficients at the signalled zero positions."""
    p1 = 1 << al
    m1 = -(1 << al)
    if eobrun > 0:
        # Inside an EOB run: no new coefficients this block, but every
        # already-nonzero coefficient still takes a correction bit.
        for k in range(ss, se + 1):
            if coefs[k] != 0:
                if bits.bit() and (coefs[k] & p1) == 0:
                    coefs[k] += p1 if coefs[k] > 0 else m1
        return eobrun - 1
    k = ss
    while k <= se:
        rs = bits.huff(ac)
        r, s = rs >> 4, rs & 15
        val = 0
        if s == 0:
            if r < 15:
                # EOBn: (1 << r) - 1 FURTHER blocks (the current block
                # finishes via the r=64 sweep below, which only emits
                # correction bits — no decrement for it).
                eobrun = (1 << r) - 1
                if r:
                    eobrun += bits.receive(r)
                r = 64
            # else r == 15: run of 16 zero-history coefficients
        else:
            if s != 1:
                raise ValueError("JPEG AC refinement size != 1")
            val = p1 if bits.bit() else m1
        while k <= se:
            kk = k
            k += 1
            if coefs[kk] != 0:
                if bits.bit() and (coefs[kk] & p1) == 0:
                    coefs[kk] += p1 if coefs[kk] > 0 else m1
            else:
                if r == 0:
                    if val:
                        coefs[kk] = val
                    break
                r -= 1
    return eobrun


def _reconstruct(frame, qt) -> np.ndarray:
    """Block-parallel dequantize + IDCT + upsample + color convert."""
    h, w, comps = frame["h"], frame["w"], frame["comps"]
    hmax, vmax = frame["hmax"], frame["vmax"]
    planes = []
    for c in comps:
        k = (c["coef"] * qt[c["tq"]]).astype(np.float32)
        blocks = np.zeros((k.shape[0], 64), np.float32)
        blocks[:, _ZIGZAG] = k
        blocks = blocks.reshape(-1, 8, 8)
        px = np.einsum("ux,nuv,vy->nxy", _IDCT_A, blocks, _IDCT_A)
        px = np.clip(np.round(px + 128.0), 0, 255).astype(np.uint8)
        plane = (px.reshape(c["bh"], c["bw"], 8, 8)
                 .transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8))
        plane = np.repeat(np.repeat(plane, vmax // c["v"], axis=0),
                          hmax // c["h"], axis=1)
        planes.append(plane[:h, :w])

    if len(planes) == 1:
        return np.repeat(planes[0][:, :, None], 3, axis=2)
    if len(planes) != 3:
        raise ValueError(f"unsupported JPEG component count {len(planes)}")
    y = planes[0].astype(np.float32)
    cb = planes[1].astype(np.float32) - 128.0
    cr = planes[2].astype(np.float32) - 128.0
    rgb = np.stack([y + 1.402 * cr,
                    y - 0.344136 * cb - 0.714136 * cr,
                    y + 1.772 * cb], axis=2)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def _decode_block(bits: _Bits, dc: _Huff, ac: _Huff, pred: int,
                  coefs: np.ndarray) -> int:
    t = bits.huff(dc)
    pred += bits.receive_extend(t)
    coefs[0] = pred
    k = 1
    while k < 64:
        rs = bits.huff(ac)
        r, s = rs >> 4, rs & 15
        if s == 0:
            if r != 15:
                break                          # EOB
            k += 16                            # ZRL
            continue
        k += r
        if k > 63:
            raise ValueError("JPEG AC coefficient index out of range")
        coefs[k] = bits.receive_extend(s)
        k += 1
    return pred


# ----------------------------------------------------------------------------
# Baseline JPEG encoder (4:4:4, optimized per-image Huffman tables).
# The reference's vendored stack writes JPEG via stb_image_write (inside
# support/tinygltf); this is the dependency-free equivalent. Two passes:
# gather symbol statistics, build optimal length-limited Huffman codes
# (JPEG spec Annex K.2 algorithm), then emit.
# ----------------------------------------------------------------------------

_QT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int32)
_QT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], np.int32)


def _scaled_qt(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg quality scaling: 50 = spec tables, 100 = all-ones."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int32)


def _build_huffman_lengths(freq: np.ndarray) -> tuple[list[int], list[int]]:
    """Optimal length-limited JPEG Huffman table (spec K.2 figs K.1-K.3).

    ``freq`` has 257 entries; slot 256 is the reserved guard symbol that
    keeps any real code from being all ones. Returns (BITS[1..16] counts,
    HUFFVAL symbol order)."""
    freq = freq.astype(np.int64).copy()
    freq[256] = 1
    codesize = np.zeros(257, np.int32)
    others = np.full(257, -1, np.int32)
    while True:
        nz = np.nonzero(freq)[0]
        if nz.size < 2:
            break
        order = nz[np.lexsort((-nz, freq[nz]))]    # least freq, highest sym
        v1, v2 = int(order[0]), int(order[1])
        freq[v1] += freq[v2]
        freq[v2] = 0
        codesize[v1] += 1
        while others[v1] != -1:
            v1 = others[v1]
            codesize[v1] += 1
        others[v1] = v2
        codesize[v2] += 1
        while others[v2] != -1:
            v2 = others[v2]
            codesize[v2] += 1
    bits = np.zeros(33, np.int32)
    for s in codesize[codesize > 0]:
        bits[min(int(s), 32)] += 1
    # Limit code lengths to 16 (fig K.3): move pairs up the tree.
    for length in range(32, 16, -1):
        while bits[length] > 0:
            j = length - 2
            while bits[j] == 0:
                j -= 1
            bits[length] -= 2
            bits[length - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    # Remove the guard symbol's code (the longest one, fig K.3 end).
    for length in range(16, 0, -1):
        if bits[length] > 0:
            bits[length] -= 1
            break
    syms = [int(s) for s in np.lexsort((np.arange(257), codesize))
            if codesize[s] > 0 and s != 256]
    return [int(b) for b in bits[1:17]], syms


class _BitWriter:
    __slots__ = ("out", "acc", "n")

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int) -> None:
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)          # byte stuffing
            self.n -= 8
            self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put(0x7F, 8 - self.n)         # pad with 1-bits


def _csize(v: int) -> int:
    return int(v).bit_length() if v >= 0 else int(-v).bit_length()


def _block_symbols(coefs: np.ndarray, pred: int):
    """One quantized zigzag block -> (dc_sym, dc_bits), [(ac_sym, bits)]."""
    diff = int(coefs[0]) - pred
    s = _csize(diff)
    dc = (s, (diff if diff >= 0 else diff + (1 << s) - 1) & ((1 << s) - 1))
    acs = []
    run = 0
    nz = np.nonzero(coefs[1:])[0]
    last = int(nz[-1]) + 1 if nz.size else 0
    for k in range(1, last + 1):
        v = int(coefs[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            acs.append((0xF0, (0, 0)))          # ZRL
            run -= 16
        s = _csize(v)
        bits = (v if v >= 0 else v + (1 << s) - 1) & ((1 << s) - 1)
        acs.append(((run << 4) | s, (s, bits)))
        run = 0
    if last < 63:
        acs.append((0x00, (0, 0)))              # EOB
    return int(coefs[0]), dc, acs


def encode_jpeg(rgb: np.ndarray, quality: int = 90) -> bytes:
    """Encode uint8 [H, W, 3] (or [H, W] grayscale) as baseline 4:4:4 JPEG."""
    img = np.asarray(rgb)
    gray = img.ndim == 2
    h, w = img.shape[:2]
    if gray:
        planes = [img.astype(np.float32)]
    else:
        f = img.astype(np.float32)
        r, g, b = f[:, :, 0], f[:, :, 1], f[:, :, 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
    qts = [_scaled_qt(_QT_LUMA, quality)]
    if not gray:
        qts.append(_scaled_qt(_QT_CHROMA, quality))

    bh, bw = -(-h // 8), -(-w // 8)
    zz_blocks = []
    for ci, p in enumerate(planes):
        pad = np.pad(p, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
        blocks = (pad.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
                  .reshape(-1, 8, 8) - 128.0)
        k = np.einsum("ux,nxy,vy->nuv", _IDCT_A, blocks, _IDCT_A)
        q = qts[min(ci, len(qts) - 1)]
        zz = np.round(k.reshape(-1, 64) / q[_ZIGZAG].reshape(1, 64)
                      ).astype(np.int32)[:, np.argsort(_ZIGZAG)]
        # zz is now in zigzag order: entry j is coefficient at zigzag j.
        zz_blocks.append(zz)

    # Pass 1: symbol statistics per (dc/ac, luma/chroma) table.
    nt = 1 if gray else 2
    dc_freq = [np.zeros(257, np.int64) for _ in range(nt)]
    ac_freq = [np.zeros(257, np.int64) for _ in range(nt)]
    n_blocks = bh * bw
    sym_stream = []                              # per MCU, per component
    preds = [0] * len(planes)
    for m in range(n_blocks):
        for ci in range(len(planes)):
            t = min(ci, nt - 1)
            preds[ci], dc, acs = _block_symbols(zz_blocks[ci][m], preds[ci])
            dc_freq[t][dc[0]] += 1
            for sym, _ in acs:
                ac_freq[t][sym] += 1
            sym_stream.append((t, dc, acs))
    dc_tabs = [_build_huffman_lengths(f) for f in dc_freq]
    ac_tabs = [_build_huffman_lengths(f) for f in ac_freq]

    def codes(tab):
        bits, syms = tab
        out = {}
        code = 0
        k = 0
        for ln in range(1, 17):
            for _ in range(bits[ln - 1]):
                out[syms[k]] = (code, ln)
                code += 1
                k += 1
            code <<= 1
        return out

    dc_codes = [codes(t) for t in dc_tabs]
    ac_codes = [codes(t) for t in ac_tabs]

    # Pass 2: emit.
    bwr = _BitWriter()
    for t, (s, bits_v), acs in sym_stream:
        c, ln = dc_codes[t][s]
        bwr.put(c, ln)
        if s:
            bwr.put(bits_v, s)
        for sym, (sb, vb) in acs:
            c, ln = ac_codes[t][sym]
            bwr.put(c, ln)
            if sb:
                bwr.put(vb, sb)
    bwr.flush()

    def seg(marker: int, payload: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    out = bytearray(b"\xff\xd8")
    out += seg(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for i, q in enumerate(qts):
        out += seg(0xDB, bytes([i]) + bytes(int(x) for x in q))
    ncomp = 1 if gray else 3
    sof = struct.pack(">BHHB", 8, h, w, ncomp)
    for ci in range(ncomp):
        sof += bytes([ci + 1, 0x11, min(ci, len(qts) - 1)])
    out += seg(0xC0, sof)
    for t in range(nt):
        bits, syms = dc_tabs[t]
        out += seg(0xC4, bytes([t]) + bytes(bits) + bytes(syms))
        bits, syms = ac_tabs[t]
        out += seg(0xC4, bytes([0x10 | t]) + bytes(bits) + bytes(syms))
    sos = bytes([ncomp])
    for ci in range(ncomp):
        t = min(ci, nt - 1)
        sos += bytes([ci + 1, (t << 4) | t])
    sos += b"\x00\x3f\x00"
    out += seg(0xDA, sos)
    out += bwr.out
    out += b"\xff\xd9"
    return bytes(out)
