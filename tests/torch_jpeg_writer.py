"""A JPEG writer for the tests of ``nerf_sandbox_tpu_torch/data/jpeg.py``
(numpy; not collected, and no part of the port, which gains no encoder).

It writes the files Pillow cannot: any h x v sampling per component,
arithmetic coding (``jcarith.c``'s QM coder, with DAC conditioning), custom
progressive scan scripts (complete or not), lossless (predictors 1-7,
point transform), and the kinds imageio refuses. Huffman tables are built
per scan from the symbol counts (T.81 Annex K.2), so every scan script
codes. The same coefficients can be written Huffman- or arithmetic-coded:
:func:`dct_components` makes them, :func:`write_jpeg` codes them.

    comps = dct_components(planes, [(2, 2), (1, 1), (1, 1)], quality=90)
    write_jpeg(path, comps, W, H, coding="arith", script=PROGRESSIVE_SCRIPT)
"""

from __future__ import annotations

import heapq
import struct
from pathlib import Path

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# T.81 Annex K.1's tables, natural order
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.full(64, 99)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 16, 17, 24]] = [17, 18, 24, 47, 21, 26, 66, 24, 26, 47]
# libjpeg's jpeg_simple_progression for three components ("Y" is 0)
PROGRESSIVE_SCRIPT = [
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
    ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
    ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]


def synth_image(H: int, W: int, C: int, seed: int, noise: float = 12.0) -> np.ndarray:
    """Smooth colour fields plus Gaussian noise of std ``noise``, uint8 (H,
    W, C)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0 - c)
                    for c in range(C)], -1) + rng.normal(0, noise, (H, W, C))
    return np.clip(img, 0, 255).astype(np.uint8)


def set_sampling(path, factors):
    """Rewrite the (h, v) factors in a file's frame header, leaving its
    scans as they are (a frame libjpeg-turbo refuses before any scan)."""
    data = bytearray(Path(path).read_bytes())
    pos = 2
    while data[pos + 1] not in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    for i, (h, v) in enumerate(factors):
        data[pos + 11 + 3 * i] = (h << 4) | v
    Path(path).write_bytes(bytes(data))


def _dct_matrix() -> np.ndarray:
    k, n = np.mgrid[0:8, 0:8]
    m = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


_C = _dct_matrix()


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG quality scaling of a natural-order table → zig-zag order, 1-255."""
    s = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * s + 50) // 100, 1, 255)[ZIGZAG]


def downsample(plane: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """Box mean over fy x fy blocks, the edge replicated to whole blocks."""
    H, W = plane.shape
    h, w = -(-H // fy), -(-W // fx)
    p = np.pad(plane.astype(np.float64), ((0, h * fy - H), (0, w * fx - W)), mode="edge")
    return np.round(p.reshape(h, fy, w, fx).mean((1, 3))).astype(np.int64)


def dct_components(planes, factors, quality=90, ids=None, qtables=None):
    """Full-size uint8 planes and their (h, v) factors → components: each a
    dict of id, h, v, its zig-zag quantization table ``q`` and ``tq`` slot,
    and ``coef``, (blocks down, blocks across, 64) quantized zig-zag
    coefficients over the frame's padded block grid (whole MCUs)."""
    H, W = planes[0].shape
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    comps = []
    for i, (plane, (h, v)) in enumerate(zip(planes, factors)):
        sub = downsample(plane, vmax // v, hmax // h)
        if qtables is None:
            q, tq = quant_table(LUMA_Q if i == 0 else CHROMA_Q, quality), min(i, 1)
        else:
            q, tq = qtables[i], i
        bh, bw = mcuy * v, mcux * h
        p = np.pad(sub, ((0, 8 * bh - sub.shape[0]), (0, 8 * bw - sub.shape[1])), mode="edge")
        blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).astype(np.float64) - 128
        f = np.einsum("ij,abjk,lk->abil", _C, blocks, _C).reshape(bh, bw, 64)[..., ZIGZAG]
        comps.append({"id": (ids or [1, 2, 3, 4, 5])[i], "h": h, "v": v, "q": q, "tq": tq,
                      "coef": np.round(f / q).astype(np.int64)})
    return comps


# ---------------------------------------------------------------- bits

class BitWriter:
    """MSB-first bits with 0xFF bytes stuffed, padded with 1 bits."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, nbits: int):
        if nbits <= 0:
            return
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        out, self.out = bytes(self.out), bytearray()
        return out


def huffman_table(freq):
    """Symbol counts {symbol: n} → (counts by length 1-16, symbols), T.81
    Annex K.2: lengths from a Huffman tree with one reserved code point,
    limited to 16 bits (Figure K.3)."""
    syms = sorted(s for s, n in freq.items() if n > 0) or [0]
    heap = [(freq.get(s, 1), s, [s]) for s in syms] + [(1, -1, [256])]
    heapq.heapify(heap)
    size = {s: 0 for s in syms + [256]}
    tie = 257
    while len(heap) > 1:
        f1, _, a = heapq.heappop(heap)
        f2, _, b = heapq.heappop(heap)
        for s in a + b:
            size[s] += 1
        heapq.heappush(heap, (f1 + f2, tie, a + b))
        tie += 1
    bits = [0] * 65
    for s, n in size.items():
        bits[n] += 1
    for i in range(64, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1                                   # the reserved code point
    order = sorted(size, key=lambda s: (size[s], s))[:-1]
    return bits[1:17], order


def huffman_codes(counts, symbols):
    """Canonical codes → {symbol: (code, length)}."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def _category(v: int) -> int:
    return abs(v).bit_length()


def _value_bits(v: int, s: int) -> int:
    return v if v >= 0 else v + (1 << s) - 1


# ---------------------------------------------------------------- scans

def scan_blocks(comps, sel, mcux, mcuy):
    """The blocks of a scan in coding order → ([(component, by, bx)], blocks
    per MCU): one component over its own grid, several MCU by MCU."""
    if len(sel) == 1:
        c = comps[sel[0]]
        hib, wib = c["hib"], c["wib"]
        return [(sel[0], y, x) for y in range(hib) for x in range(wib)], 1
    out = []
    for my in range(mcuy):
        for mx in range(mcux):
            for ci in sel:
                c = comps[ci]
                out += [(ci, my * c["v"] + v, mx * c["h"] + h)
                        for v in range(c["v"]) for h in range(c["h"])]
    return out, sum(comps[ci]["h"] * comps[ci]["v"] for ci in sel)


class _HuffScan:
    """Events of one Huffman scan: ("s", table, symbol) and ("b", value, n)
    per interval; the tables are built from them."""

    def __init__(self):
        self.events, self.eobrun, self.be = [], 0, []

    def sym(self, table, s):
        self.events.append(("s", table, s))

    def bits(self, v, n):
        self.events.append(("b", v, n))

    def flush_eobrun(self, table):
        if self.eobrun:
            n = self.eobrun.bit_length() - 1
            self.sym(table, n << 4)
            self.bits(self.eobrun, n)
            self.eobrun = 0
        for b in self.be:
            self.bits(b, 1)
        self.be = []


def _seq_block(ev, coef, pred, dct, act):
    diff = int(coef[0]) - pred
    s = _category(diff)
    ev.sym(dct, s)
    ev.bits(_value_bits(diff, s), s)
    run = 0
    last = max([k for k in range(1, 64) if coef[k]] or [0])
    for k in range(1, last + 1):
        v = int(coef[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            ev.sym(act, 0xF0)
            run -= 16
        s = _category(v)
        ev.sym(act, (run << 4) | s)
        ev.bits(_value_bits(v, s), s)
        run = 0
    if last < 63:
        ev.sym(act, 0)


def _ac_first_block(ev, coef, ss, se, al, act):
    run = 0
    for k in range(ss, se + 1):
        v = int(coef[k])
        a = abs(v) >> al
        if a == 0:
            run += 1
            continue
        ev.flush_eobrun(act)
        while run > 15:
            ev.sym(act, 0xF0)
            run -= 16
        s = a.bit_length()
        ev.sym(act, (run << 4) | s)
        ev.bits(a if v > 0 else ~a, s)
        run = 0
    if run:
        ev.eobrun += 1
        if ev.eobrun == 0x7FFF:
            ev.flush_eobrun(act)


def _ac_refine_block(ev, coef, ss, se, al, act):
    absv = [abs(int(coef[k])) >> al for k in range(64)]
    eob = max([k for k in range(ss, se + 1) if absv[k] == 1] or [0])
    run, br = 0, []
    for k in range(ss, se + 1):
        a = absv[k]
        if a == 0:
            run += 1
            continue
        while run > 15 and k <= eob:
            ev.flush_eobrun(act)
            ev.sym(act, 0xF0)
            run -= 16
            for b in br:
                ev.bits(b, 1)
            br = []
        if a > 1:
            br.append(a & 1)
            continue
        ev.flush_eobrun(act)
        ev.sym(act, (run << 4) | 1)
        ev.bits(1 if coef[k] > 0 else 0, 1)
        for b in br:
            ev.bits(b, 1)
        br, run = [], 0
    if run or br:
        ev.eobrun += 1
        ev.be += br
        if ev.eobrun == 0x7FFF or len(ev.be) > 937:
            ev.flush_eobrun(act)


def _huffman_scan(comps, sel, blocks, per, kind, ss, se, ah, al):
    """→ ([events per interval], {table: counts}); tables are ("dc", i) /
    ("ac", i) where i is the scan slot."""
    intervals = []
    for start in range(0, len(blocks), per):
        ev = _HuffScan()
        pred = {ci: 0 for ci in sel}
        for ci, by, bx in blocks[start:start + per]:
            c, slot = comps[ci], sel.index(ci)
            coef = c["coef"][by, bx]
            if kind == "lossless":
                d = int(c["diff"][by, bx])
                s = 16 if d == 32768 else _category(d)
                ev.sym(("dc", slot), s)
                if s != 16:
                    ev.bits(_value_bits(d, s), s)
            elif kind == "sequential":
                _seq_block(ev, coef, pred[ci], ("dc", slot), ("ac", slot))
                pred[ci] = int(coef[0])
            elif ss == 0 and ah == 0:
                v = int(coef[0]) >> al
                s = _category(v - pred[ci])
                ev.sym(("dc", slot), s)
                ev.bits(_value_bits(v - pred[ci], s), s)
                pred[ci] = v
            elif ss == 0:
                ev.bits((int(coef[0]) >> al) & 1, 1)
            elif ah == 0:
                _ac_first_block(ev, coef, ss, se, al, ("ac", slot))
            else:
                _ac_refine_block(ev, coef, ss, se, al, ("ac", slot))
        if kind == "progressive" and ss > 0:
            ev.flush_eobrun(("ac", 0))
        intervals.append(ev.events)
    freq = {}
    for events in intervals:
        for e in events:
            if e[0] == "s":
                freq.setdefault(e[1], {}).setdefault(e[2], 0)
                freq[e[1]][e[2]] += 1
    return intervals, freq


# ---------------------------------------------------------------- arithmetic

_D2 = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


class QMEncoder:
    """``jcarith.c``'s encoder: C with 3 spacer bits above the output byte,
    stacked 0xFF bytes (sc) that a carry may turn to 0x00, pending zero
    bytes (zc) dropped at the end."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _zeros(self):
        self.out += b"\x00" * self.zc
        self.zc = 0

    def encode(self, st, i, val):
        sv = st[i]
        qe, lps, mps, switch = _D2[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):                        # the LPS
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (lps | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ mps
        while True:                                 # renormalization
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:                      # a carry
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _arith_magnitude(enc, st, i, a, x2):
    """|v| - 1 = ``a`` from the first magnitude bin ``i``: DC (``x2`` None)
    moves to X1 = 20, AC decides twice in ``i`` and moves to ``x2``."""
    m = 1 << (a.bit_length() - 1) if a else 0
    enc.encode(st, i, 1 if m else 0)
    if not m:
        return
    if x2 is None:
        i, mm = 20, 1
    else:
        enc.encode(st, i, 1 if m > 1 else 0)
        if m == 1:
            return
        i, mm = x2, 2
    while mm < m:
        enc.encode(st, i, 1)
        mm <<= 1
        i += 1
    enc.encode(st, i, 0)
    b = m >> 1
    while b:
        enc.encode(st, i + 14, 1 if a & b else 0)
        b >>= 1


def _arith_dc(enc, st, ctx, diff, bounds):
    """→ the next context."""
    if diff == 0:
        enc.encode(st, ctx, 0)
        return 0
    enc.encode(st, ctx, 1)
    sign = 1 if diff < 0 else 0
    enc.encode(st, ctx + 1, sign)
    a = abs(diff) - 1
    _arith_magnitude(enc, st, ctx + 2 + sign, a, None)
    m = 1 << (a.bit_length() - 1) if a else 0
    lo, hi = bounds
    return 0 if m < (1 << lo) >> 1 else (12 + 4 * sign if m > (1 << hi) >> 1 else 4 + 4 * sign)


def _arith_ac(enc, st, vals, ss, se, kx, fixed):
    """AC values (already point-transformed, signed) over ss..se."""
    ke = max([k for k in range(ss, se + 1) if vals[k]] or [ss - 1])
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if k > ke:
            enc.encode(st, i, 1)
            return
        enc.encode(st, i, 0)
        while vals[k] == 0:
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        enc.encode(st, i + 1, 1)
        enc.encode(fixed, 0, 1 if vals[k] < 0 else 0)
        _arith_magnitude(enc, st, i + 2, abs(vals[k]) - 1, 189 if k <= kx else 217)
        k += 1


def _arith_refine(enc, st, coef, ss, se, al, fixed):
    absv = [abs(int(coef[k])) >> al for k in range(64)]
    kex = max([k for k in range(1, se + 1) if absv[k] > 1] or [0])
    ke = max([k for k in range(ss, se + 1) if absv[k]] or [0])
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if k > kex:
            if k > ke:
                enc.encode(st, i, 1)
                return
            enc.encode(st, i, 0)
        while True:
            if absv[k] > 1:
                enc.encode(st, i + 2, absv[k] & 1)
                break
            if absv[k] == 1:
                enc.encode(st, i + 1, 1)
                enc.encode(fixed, 0, 1 if coef[k] < 0 else 0)
                break
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        k += 1


def _arith_scan(comps, sel, blocks, per, kind, ss, se, ah, al, dac):
    """→ the scan's coded bytes, restart markers included."""
    out = b""
    dc_bounds, ac_kx = dac or ({}, {})
    for n, start in enumerate(range(0, len(blocks), per)):
        if n:
            out += bytes([0xFF, 0xD0 + (n - 1) % 8])
        enc, fixed = QMEncoder(), bytearray([113])
        dc_st = {ci: bytearray(64) for ci in sel}
        ac_st = {ci: bytearray(256) for ci in sel}
        pred, ctx = {ci: 0 for ci in sel}, {ci: 0 for ci in sel}
        for ci, by, bx in blocks[start:start + per]:
            c, slot = comps[ci], sel.index(ci)
            coef = c["coef"][by, bx]
            bounds, kx = dc_bounds.get(slot, (0, 1)), ac_kx.get(slot, 5)
            if kind == "sequential" or (ss == 0 and ah == 0):
                v = int(coef[0]) >> (al if kind != "sequential" else 0)
                ctx[ci] = _arith_dc(enc, dc_st[ci], ctx[ci], v - pred[ci], bounds)
                pred[ci] = v
                if kind == "sequential":
                    _arith_ac(enc, ac_st[ci], [int(x) for x in coef], 1, 63, kx, fixed)
            elif ss == 0:
                enc.encode(fixed, 0, (int(coef[0]) >> al) & 1)
            elif ah == 0:
                vals = [int(np.sign(x)) * (abs(int(x)) >> al) for x in coef]
                _arith_ac(enc, ac_st[ci], vals, ss, se, kx, fixed)
            else:
                _arith_refine(enc, ac_st[ci], coef, ss, se, al, fixed)
        out += enc.finish()
    return out


# ---------------------------------------------------------------- lossless

def lossless_components(planes, factors, psv, pt, ids=None, restart_rows=None):
    """Full-size planes → components for a lossless frame (one interleaved
    scan when there are several): each sample's ``diff`` from predictor
    ``psv`` over samples shifted down by ``pt``, the first row of each
    restart interval (every ``restart_rows`` MCU rows) predicted afresh."""
    H, W = planes[0].shape
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    mcux, mcuy = -(-W // hmax), -(-H // vmax)
    comps = []
    for i, (plane, (h, v)) in enumerate(zip(planes, factors)):
        x = downsample(plane, vmax // v, hmax // h) >> pt
        rows, cols = x.shape
        diff = np.zeros((mcuy * v, mcux * h), np.int64)
        first = set(range(0, rows, v * (restart_rows or mcuy)))
        for y in range(rows):
            for j in range(cols):
                if y in first:
                    p = (1 << (7 - pt)) if j == 0 else x[y, j - 1]
                elif j == 0:
                    p = x[y - 1, 0]
                else:
                    ra, rb, rc = int(x[y, j - 1]), int(x[y - 1, j]), int(x[y - 1, j - 1])
                    p = (0, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                         rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv]
                diff[y, j] = int(x[y, j]) - int(p)
        comps.append({"id": (ids or [1, 2, 3, 4, 5])[i], "h": h, "v": v, "tq": 0,
                      "diff": diff, "coef": diff[..., None]})
    return comps


# ---------------------------------------------------------------- file

def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def write_jpeg(path, comps, W, H, *, coding="huffman", script=None, restart=0,
               jfif=True, adobe=None, dac=None, sof=None, precision=8, lossless=None,
               height=None, interleave=True, dnl=False):
    """Code ``comps`` into a JPEG file.

    ``script``: None for sequential (one interleaved scan, or one scan per
    component when ``interleave`` is False), else a list of (component
    indices, Ss, Se, Ah, Al) for a progressive frame. ``lossless``: (psv,
    pt) for components from :func:`lossless_components`. ``coding``:
    "huffman" or "arith" (``dac``: ({slot: (L, U)}, {slot: Kx})).
    ``restart``: MCUs per restart interval. ``jfif``/``adobe``: APP0 and
    APP14 (transform) markers. ``sof``, ``precision``, ``height``, ``dnl``
    override the frame header, for the kinds that are refused."""
    arith = coding == "arith"
    kind = "lossless" if lossless else ("progressive" if script else "sequential")
    if sof is None:
        sof = {("sequential", False): 0xC1, ("progressive", False): 0xC2,
               ("lossless", False): 0xC3, ("sequential", True): 0xC9,
               ("progressive", True): 0xCA, ("lossless", True): 0xCB}[kind, arith]
    unit = 1 if lossless else 8
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux, mcuy = -(-W // (unit * hmax)), -(-H // (unit * vmax))
    for c in comps:
        c["wib"] = -(-(-(-W * c["h"] // hmax)) // unit)
        c["hib"] = -(-(-(-H * c["v"] // vmax)) // unit)
    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    if not lossless:
        tables = {}
        for c in comps:
            tables[c["tq"]] = c["q"]
        for tq, q in sorted(tables.items()):
            big = precision > 8 or q.max() > 255
            out += _segment(0xDB, bytes([(16 if big else 0) | tq]) + (
                q.astype(">u2").tobytes() if big else q.astype(np.uint8).tobytes()))
    out += _segment(sof, struct.pack(">BHHB", precision, 0 if dnl else (height or H), W,
                                     len(comps)) + b"".join(
        bytes([c["id"], (c["h"] << 4) | c["v"], c["tq"]]) for c in comps))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    if arith and dac:
        body = b"".join(bytes([s, (hi << 4) | lo]) for s, (lo, hi) in dac[0].items())
        body += b"".join(bytes([16 + s, kx]) for s, kx in dac[1].items())
        out += _segment(0xCC, body)
    if lossless:
        scans = [(tuple(range(len(comps))), lossless[0], 0, 0, lossless[1])]
    elif script is None:
        scans = ([(tuple(range(len(comps))), 0, 63, 0, 0)] if interleave
                 else [((i,), 0, 63, 0, 0) for i in range(len(comps))])
    else:
        scans = script
    for n, (sel, ss, se, ah, al) in enumerate(scans):
        blocks, per_mcu = scan_blocks(comps, list(sel), mcux, mcuy)
        per = restart * per_mcu if restart else len(blocks)
        if arith:
            data = _arith_scan(comps, list(sel), blocks, per, kind, ss, se, ah, al, dac)
            sel_bytes = b"".join(bytes([comps[ci]["id"], (slot << 4) | slot])
                                 for slot, ci in enumerate(sel))
        else:
            intervals, freq = _huffman_scan(comps, list(sel), blocks, per, kind, ss, se, ah, al)
            codes, dht = {}, b""
            for (cls, slot), f in sorted(freq.items()):
                counts, symbols = huffman_table(f)
                codes[cls, slot] = huffman_codes(counts, symbols)
                dht += bytes([(1 if cls == "ac" else 0) << 4 | slot]) + bytes(counts) + bytes(
                    symbols)
            if dht:
                out += _segment(0xC4, dht)
            data = b""
            for m, events in enumerate(intervals):
                if m:
                    data += bytes([0xFF, 0xD0 + (m - 1) % 8])
                bw = BitWriter()
                for e in events:
                    if e[0] == "s":
                        code, length = codes[e[1]][e[2]]
                        bw.put(code, length)
                    else:
                        bw.put(e[1], e[2])
                data += bw.flush()
            sel_bytes = b"".join(bytes([comps[ci]["id"], (slot << 4) | slot])
                                 for slot, ci in enumerate(sel))
        out += _segment(0xDA, bytes([len(sel)]) + sel_bytes + bytes([ss, se, (ah << 4) | al]))
        out += data
        if dnl and n == 0:
            out += _segment(0xDC, struct.pack(">H", H))
    Path(path).write_bytes(out + b"\xff\xd9")
