"""JPEG decoding with numpy: every file ``imageio.v2.imread`` reads.

Stands in for ``imageio.v2.imread`` on JPEG files, which the JAX package's
LLFF loader (``nerf_sandbox_tpu/data/llff_loader.py``) reads through Pillow
and libjpeg-turbo, and which the port does without. The arithmetic is
libjpeg-turbo's, so the arrays are bit-equal to ``imageio.v2.imread``'s, in
value, dtype and shape:

* the entropy decoding of every process Pillow's libjpeg-turbo reads:
  sequential and progressive, Huffman- (:mod:`jpeg_huffman`) or
  arithmetic-coded (:mod:`jpeg_arith`), and 8-bit lossless
  (:mod:`jpeg_lossless`), with restart intervals;
* block smoothing of a progressive file whose scans leave low-frequency
  AC bits unsent (:mod:`jpeg_smooth`, ``jdcoefct.c``);
* the integer "islow" inverse DCT (``jidctint.c``), its outputs wrapped
  through the IDCT range-limit table as the library indexes it;
* upsampling at every whole sampling ratio as ``jdsample.c`` chooses it:
  fancy (triangle) 2x1 and 2x2 when the plane is more than 2 samples wide,
  fancy 1x2 (4:4:0), plain replication otherwise (lossless files have no
  fancy upsampling); luma need not have the largest factors;
* colour: YCbCr to RGB through the library's fixed-point tables
  (``jdcolor.c``, 16 fraction bits); a 3-component file is RGB instead when
  an Adobe marker says transform 0, or, without JFIF and Adobe markers,
  when its component ids are 'R', 'G', 'B' (``jdapimin.c``). 4 components
  are CMYK, or YCCK turned to CMYK when an Adobe marker says a transform
  other than 0 (``ycck_cmyk_convert``); Pillow then inverts all four
  channels (rawmode ``CMYK;I``) and imageio returns (H, W, 4).

What imageio refuses, this raises on too (``ValueError`` naming the file):
precision other than 8 bits and component counts other than 1, 3 or 4
(Pillow, ``PIL/JpegImagePlugin.py:SOF``), hierarchical and arithmetic
lossless processes, a height left to a DNL marker, sampling factors outside
1-4 or at a fractional ratio, an interleaved MCU of more than 10 blocks,
and lossless restart intervals that split an MCU row (libjpeg-turbo). A
damaged file raises ``ValueError`` naming it. EXIF orientation is ignored,
as ``imageio.v2.imread`` ignores it by default.

The entropy decoding is a Python loop over the coded symbols or decisions;
everything after it is numpy over all blocks at once.
"""

from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np

from nerf_sandbox_tpu_torch.data import jpeg_arith, jpeg_huffman, jpeg_lossless, jpeg_smooth

# zig-zag position -> natural (row-major) position in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

REFUSED = "imageio.v2.imread (Pillow, libjpeg-turbo) refuses it too"
# SOF marker -> (progressive, arithmetic, lossless)
_PROCESS = {0xC0: (False, False, False), 0xC1: (False, False, False),
            0xC2: (True, False, False), 0xC3: (False, False, True),
            0xC9: (False, True, False), 0xCA: (True, True, False)}
_REFUSED_SOF = {0xC5: "hierarchical", 0xC6: "hierarchical progressive",
                0xC7: "hierarchical lossless", 0xC8: "JPG-extension",
                0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
                0xCE: "arithmetic-coded hierarchical progressive",
                0xCF: "arithmetic-coded hierarchical lossless",
                0xDE: "hierarchical (DHP)"}
# the end of an entropy-coded segment: 0xFF followed by neither a stuffed
# zero, nor a restart marker, nor a fill byte
_SEGMENT_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")
_STUFFED = re.compile(rb"\xff+\x00")
# T.81 Annex K.3's tables (libjpeg-turbo's ``std_huff_tables``), for the
# slots 0 and 1 that a sequential file (Motion JPEG) leaves undefined:
# (class, slot) -> (counts, symbols)
_STD_HUFFMAN = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))}
MAX_BLOCKS_IN_MCU = 10
PILLOW_MAXBLOCK = 65536          # PIL/ImageFile.py: MAXBLOCK, the read size of a decode

# jidctint.c's constants: FIX(x) = round(x * 2^13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _range_limit_table() -> np.ndarray:
    """The library's post-IDCT table, indexed by ``x & 1023``: x + 128
    clamped to [0, 255] for x in [-512, 511], wrapping outside."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_RANGE_LIMIT = _range_limit_table()


def _idct_pass(c, shift):
    """One 1-D pass of ``jpeg_idct_islow`` over the 8 coefficient arrays
    ``c`` (int64), each output descaled by ``shift`` bits."""
    z1 = (c[2] + c[6]) * _F0541
    tmp2 = z1 + c[6] * -_F1847
    tmp3 = z1 + c[2] * _F0765
    tmp0 = (c[0] + c[4]) << 13
    tmp1 = (c[0] - c[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(x + half) >> shift for x in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """(..., 8, 8) dequantized coefficients (natural order, int64) → (..., 8,
    8) uint8 samples: columns first (13 - 2 bits), then rows (13 + 2 + 3
    bits), through the range-limit table."""
    ws = np.stack(_idct_pass([coef[..., k, :] for k in range(8)], 11), axis=-2)
    out = np.stack(_idct_pass([ws[..., k] for k in range(8)], 18), axis=-1)
    return _RANGE_LIMIT[out & 1023]


def _fancy_h2(p: np.ndarray, bias_even: int, bias_odd: int, shift: int) -> np.ndarray:
    """Double the width of ``p`` (int64): output 2j is (3 p[j] + p[j-1] +
    bias_even) >> shift and 2j + 1 is (3 p[j] + p[j+1] + bias_odd) >> shift,
    the edge samples replicated."""
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int64)
    out[:, 0::2] = (3 * p + left + bias_even) >> shift
    out[:, 1::2] = (3 * p + right + bias_odd) >> shift
    return out


def _upsample(p: np.ndarray, rh: int, rv: int, fancy: bool) -> np.ndarray:
    """A (compH, compW) uint8 plane → ``rh`` x ``rv`` times its size, by the
    method ``jdsample.c:jinit_upsampler`` picks for the ratio."""
    if (rh, rv) == (1, 1):
        return p
    q = p.astype(np.int64)
    if fancy and (rh, rv) == (2, 1) and p.shape[1] > 2:
        return _fancy_h2(q, 1, 2, 2).astype(np.uint8)
    if fancy and (rh, rv) in ((1, 2), (2, 2)) and (rh == 1 or p.shape[1] > 2):
        above = np.concatenate([q[:1], q[:-1]], axis=0)
        below = np.concatenate([q[1:], q[-1:]], axis=0)
        cols = np.empty((2 * q.shape[0], q.shape[1]), np.int64)
        cols[0::2] = 3 * q + above
        cols[1::2] = 3 * q + below
        if rh == 1:                                   # h1v2_fancy_upsample
            cols[0::2] += 1
            cols[1::2] += 2
            return (cols >> 2).astype(np.uint8)
        return _fancy_h2(cols, 8, 7, 4).astype(np.uint8)
    return np.repeat(np.repeat(p, rv, axis=0), rh, axis=1)


def _ycc(y, cb, cr):
    """``jdcolor.c``'s fixed-point YCbCr → R, G, B (16 fraction bits), int64
    and not yet clamped."""
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    return (y + ((91881 * cr + 32768) >> 16),
            y + ((-22554 * cb + 32768 - 46802 * cr) >> 16),
            y + ((116130 * cb + 32768) >> 16))


def _colour(planes, jfif, adobe, ids, lossless) -> np.ndarray:
    """The upsampled planes → the array imageio returns. A lossless file
    without markers is RGB whatever its ids; libjpeg-turbo converts no
    colours in lossless mode, so a lossless YCbCr or YCCK file is refused."""
    if len(planes) == 1:
        return planes[0]
    if lossless and (jfif or adobe not in (None, 0)):
        raise ValueError(f"lossless JPEG in {('YCbCr', 'YCCK')[len(planes) == 4]}, which "
                         f"needs a colour conversion; {REFUSED}")
    if len(planes) == 3:
        rgb = adobe == 0 if not jfif and adobe is not None else (
            not jfif and adobe is None and (lossless or ids == [82, 71, 66]))
        if rgb:
            return np.stack(planes, axis=-1)
        return np.clip(np.stack(_ycc(*planes), axis=-1), 0, 255).astype(np.uint8)
    if adobe not in (None, 0):                        # YCCK → CMYK
        cmy = [np.clip(255 - x, 0, 255) for x in _ycc(*planes[:3])]
        planes = [x.astype(np.uint8) for x in cmy] + [planes[3]]
    return 255 - np.stack(planes, axis=-1)            # Pillow's "CMYK;I"


def _segments(data: bytes, start: int):
    """The entropy-coded data from ``start`` → (its restart intervals with
    stuffed zeros removed, each interval's (first byte, position of the
    code byte of the marker that ends it), the position of the marker after
    the data)."""
    m = _SEGMENT_END.search(data, start)
    if m is None:
        raise ValueError("entropy-coded data runs past the end of the file")
    parts, spans, at = [], [], start
    for r in _RESTART.finditer(data, start, m.start()):
        parts.append(data[at:r.start()])
        spans.append((at, r.start() + 1))
        at = r.end()
    parts.append(data[at:m.start()])
    spans.append((at, m.start() + 1))
    return [_STUFFED.sub(b"\xff", p.rstrip(b"\xff")) for p in parts], spans, m.start()


def _readable(buf, first, code, end):
    """How many bytes the arithmetic decoder may take from ``buf``, an
    interval whose data starts at byte ``first`` of the file and whose
    marker's code byte is at ``code``, before it needs byte ``end`` or
    later; None when it never does. A stuffed 0xFF takes its zero along;
    reading past the data reads the marker."""
    raw_end = first + np.arange(len(buf)) + np.cumsum(np.frombuffer(buf, np.uint8) == 0xFF)
    n = int(np.searchsorted(raw_end, end))
    return None if n == len(buf) and code < end else n


def _scan_order(comps, mcux, mcuy, unit):
    """The units (blocks of 64 coefficients, or lossless samples) of a scan
    in coding order → ([(offset, slot)], units per MCU). One component:
    its own grid, row by row; several: MCU by MCU, each component's
    v x h units in turn."""
    if len(comps) == 1:
        c = comps[0]
        by, bx = np.mgrid[0:c["hib"], 0:c["wib"]]
        return [(o, 0) for o in (c["offset"] + unit * (by * c["bw"] + bx)).ravel().tolist()], 1
    cols = []
    for slot, c in enumerate(comps):
        my, mx, v, h = np.meshgrid(np.arange(mcuy), np.arange(mcux), np.arange(c["v"]),
                                   np.arange(c["h"]), indexing="ij")
        off = c["offset"] + unit * ((my * c["v"] + v) * c["bw"] + mx * c["h"] + h)
        cols.append((off.reshape(mcuy * mcux, -1), slot))
    per_mcu = sum(o.shape[1] for o, _ in cols)
    offs = np.concatenate([o for o, _ in cols], axis=1).reshape(-1)
    slots = np.concatenate([np.full(o.shape, s) for o, s in cols], axis=1).reshape(-1)
    return list(zip(offs.tolist(), slots.tolist())), per_mcu


class _Decoder:
    """The decoder's state through the markers of one file."""

    def __init__(self):
        self.qt, self.luts = {}, {}
        self.dc_cond = {t: (0, 1) for t in range(16)}     # DAC defaults L, U
        self.ac_cond = {t: 5 for t in range(16)}          # and Kx
        self.restart, self.jfif, self.adobe = 0, False, None
        self.frame, self.comps, self.coefs = None, [], None

    def lut(self, tc, th, standard=False):
        """Huffman table ``th`` of class ``tc`` (0 DC, 1 AC); ``standard``:
        fall back to T.81's, as libjpeg-turbo does for sequential scans."""
        if standard and (tc, th) not in self.luts and (tc, th) in _STD_HUFFMAN:
            counts, symbols = _STD_HUFFMAN[tc, th]
            self.luts[tc, th] = jpeg_huffman.huffman_lut(counts, symbols)
        if (tc, th) not in self.luts:
            raise ValueError(f"scan names undefined Huffman table {('DC', 'AC')[tc]}{th}")
        return self.luts[tc, th]

    def start_frame(self, marker, seg):
        if self.frame is not None:
            raise ValueError("a second frame header")
        if marker in _REFUSED_SOF:
            raise ValueError(f"{_REFUSED_SOF[marker]} JPEG; {REFUSED}")
        precision, H, W, nf = struct.unpack(">BHHB", seg[:6])
        if precision != 8:
            raise ValueError(f"{precision}-bit JPEG; {REFUSED}")
        if nf not in (1, 3, 4):
            raise ValueError(f"JPEG with {nf} components; {REFUSED}")
        if H == 0:
            raise ValueError(f"JPEG whose height is left to a DNL marker; {REFUSED}")
        if W == 0 or len(seg) < 6 + 3 * nf:
            raise ValueError("bad frame header")
        progressive, arith, lossless = _PROCESS[marker]
        for i in range(nf):
            cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
            self.comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq,
                               "bits": [-1] * 64})
        factors = [(c["h"], c["v"]) for c in self.comps]
        if not all(1 <= h <= 4 and 1 <= v <= 4 for h, v in factors):
            raise ValueError(f"JPEG sampling factors {factors} outside 1-4; {REFUSED}")
        hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
        if any(hmax % h or vmax % v for h, v in factors):
            raise ValueError(f"JPEG sampling {factors} at a fractional ratio; {REFUSED}")
        unit = 1 if lossless else 8
        mcux, mcuy = -(-W // (unit * hmax)), -(-H // (unit * vmax))
        offset = 0
        for c in self.comps:
            c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
            c["cw"], c["ch"] = -(-W * c["h"] // hmax), -(-H * c["v"] // vmax)
            c["wib"], c["hib"] = -(-c["cw"] // unit), -(-c["ch"] // unit)
            c["offset"] = offset
            offset += c["bw"] * c["bh"] * unit * unit
        self.coefs = [0] * offset
        self.frame = dict(H=H, W=W, hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy, unit=unit,
                          progressive=progressive, arith=arith, lossless=lossless)

    def scan(self, seg, data, pos):
        """An SOS segment and its entropy-coded data from ``pos`` → the
        position of the marker after it."""
        f = self.frame
        if f is None:
            raise ValueError("scan before the frame header")
        ns = seg[0]
        if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
            raise ValueError("bad scan header")
        comps, tables = [], []
        for i in range(ns):
            cs, t = seg[1 + 2 * i:3 + 2 * i]
            c = next((c for c in self.comps if c["id"] == cs), None)
            if c is None or c in comps:
                raise ValueError(f"scan names unknown or repeated component {cs}")
            comps.append(c)
            tables.append((t >> 4, t & 15))
        ss, se, a = seg[1 + 2 * ns:4 + 2 * ns]
        ah, al = a >> 4, a & 15
        if ns > 1 and sum(c["h"] * c["v"] for c in comps) > MAX_BLOCKS_IN_MCU:
            raise ValueError(f"an interleaved MCU of more than {MAX_BLOCKS_IN_MCU} blocks; "
                             f"{REFUSED}")
        intervals, spans, end = _segments(data, pos)
        order, per_mcu = _scan_order(comps, f["mcux"], f["mcuy"], f["unit"] ** 2)
        per = self.restart * per_mcu if self.restart else len(order)
        if f["lossless"]:
            self._lossless_scan(comps, tables, intervals, order, per, ss, al)
            return end
        for c in comps:                      # quantization tables latch at a first scan
            if "q" not in c:
                if c["tq"] not in self.qt:
                    raise ValueError(f"no quantization table {c['tq']}")
                c["q"] = self.qt[c["tq"]]
        if f["progressive"]:
            if ((ss == 0 and se != 0) or (ss > 0 and (se < ss or se > 63 or ns != 1))
                    or (ah and al != ah - 1) or al > 13):
                raise ValueError(f"bad progressive scan (Ss {ss}, Se {se}, Ah {ah}, Al {al})")
            for c in comps:
                c["bits"][ss:se + 1] = [al] * (se + 1 - ss)
        if f["arith"]:
            # Pillow hands libjpeg-turbo the file in MAXBLOCK pieces, and the
            # arithmetic decoder cannot wait for the next: a scan fails when
            # it needs a byte past the piece in which it started
            piece_end = ((pos - 1) // PILLOW_MAXBLOCK + 1) * PILLOW_MAXBLOCK
            try:
                jpeg_arith.decode_scan(intervals, order, tables, per, self.coefs,
                                       (self.dc_cond, self.ac_cond), f["progressive"],
                                       ss, se, ah, al,
                                       [_readable(b, *span, piece_end)
                                        for b, span in zip(intervals, spans)])
            except jpeg_arith.ReadLimit:
                raise ValueError(f"arithmetic-coded scan from byte {pos} needs byte "
                                 f"{piece_end} or later, past the {PILLOW_MAXBLOCK}-byte "
                                 f"piece Pillow reads it in; {REFUSED}") from None
        elif not f["progressive"]:
            luts = [(self.lut(0, d, True), self.lut(1, a, True)) for d, a in tables]
            jpeg_huffman.sequential(intervals, order, luts, per, self.coefs)
        elif ss == 0 and ah == 0:
            jpeg_huffman.dc_first(intervals, order, [self.lut(0, d) for d, _ in tables], per,
                                  self.coefs, al)
        elif ss == 0:
            jpeg_huffman.dc_refine(intervals, order, per, self.coefs, al)
        elif ah == 0:
            jpeg_huffman.ac_first(intervals, order, self.lut(1, tables[0][1]), per,
                                  self.coefs, ss, se, al)
        else:
            jpeg_huffman.ac_refine(intervals, order, self.lut(1, tables[0][1]), per,
                                   self.coefs, ss, se, al)
        return end

    def _lossless_scan(self, comps, tables, intervals, order, per, psv, al):
        f = self.frame
        if not 1 <= psv <= 7 or al >= 8:
            raise ValueError(f"bad lossless scan (predictor {psv}, point transform {al})")
        per_row = f["mcux"] if len(comps) > 1 else comps[0]["wib"]
        if self.restart % per_row:
            raise ValueError(f"a lossless restart interval of {self.restart} MCUs in rows of "
                             f"{per_row}; {REFUSED}")
        diffs = jpeg_lossless.differences(intervals, order, [self.lut(0, d) for d, _ in tables],
                                          per, len(self.coefs))
        rows_per_restart = self.restart // per_row if self.restart else None
        for c in comps:
            # (re)starts come at MCU rows; each resets the prediction of the
            # first row of the iMCU row it falls in
            v = c["v"]
            if len(comps) > 1:
                starts = range(0, f["mcuy"], rows_per_restart or f["mcuy"])
                first = {m * v for m in starts}
            else:
                starts = range(0, c["hib"], rows_per_restart or c["hib"])
                first = {r // v * v for r in starts}
            d = np.array(diffs[c["offset"]:c["offset"] + c["bw"] * c["bh"]], np.int64)
            d = d.reshape(c["bh"], c["bw"])[:c["hib"], :c["wib"]]
            x = jpeg_lossless.undifference(d, first, psv, 1 << (7 - al))
            c["plane"] = ((x << al) & 0xFF).astype(np.uint8)

    def image(self) -> np.ndarray:
        f = self.frame
        if f is None:
            raise ValueError("no frame header")
        smooth = f["progressive"] and jpeg_smooth.smoothing_ok(self.comps)
        planes = []
        for c in self.comps:
            if f["lossless"]:
                plane = c.get("plane")
                if plane is None:
                    plane = np.zeros((c["ch"], c["cw"]), np.uint8)
            else:
                n = c["bw"] * c["bh"] * 64
                zz = np.array(self.coefs[c["offset"]:c["offset"] + n], np.int64).reshape(
                    c["bh"], c["bw"], 64)
                q = c.get("q", np.zeros(64, np.int64))
                if smooth:
                    blocks = jpeg_smooth.smooth(zz, c, q, f["mcuy"])
                else:
                    blocks = zz[:c["hib"], :c["wib"]]
                nat = np.empty_like(blocks)
                nat[..., ZIGZAG] = blocks * q
                pix = _idct_islow(nat.reshape(c["hib"], c["wib"], 8, 8))
                plane = pix.transpose(0, 2, 1, 3).reshape(8 * c["hib"], 8 * c["wib"])
                plane = plane[:c["ch"], :c["cw"]]
            planes.append(_upsample(plane, f["hmax"] // c["h"], f["vmax"] // c["v"],
                                    not f["lossless"])[:f["H"], :f["W"]])
        return _colour(planes, self.jfif, self.adobe, [c["id"] for c in self.comps],
                       f["lossless"])


def _decode(data: bytes) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    dec, pos = _Decoder(), 2
    while True:
        while pos + 1 < len(data) and data[pos] == 0xFF and data[pos + 1] == 0xFF:
            pos += 1                                  # fill bytes
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError(f"bad or missing marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xD9:                            # EOI
            return dec.image()
        if pos + 4 > len(data):
            raise ValueError(f"truncated at byte {pos}")
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos + 4:pos + 2 + length]
        if len(seg) != length - 2:
            raise ValueError(f"truncated segment {marker:#x}")
        pos += 2 + length
        if marker in _PROCESS or marker in _REFUSED_SOF:
            dec.start_frame(marker, seg)
        elif marker == 0xDB:                          # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                dec.qt[tq] = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8
                                           ).astype(np.int64)
                i += 1 + n
        elif marker == 0xC4:                          # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                n = sum(counts)
                dec.luts[tc, th] = jpeg_huffman.huffman_lut(counts, seg[i + 17:i + 17 + n])
                i += 17 + n
        elif marker == 0xCC:                          # DAC
            for i in range(0, len(seg) - 1, 2):
                tb, val = seg[i], seg[i + 1]
                if tb >= 16:
                    dec.ac_cond[tb - 16] = val
                elif (val & 15) > (val >> 4):
                    raise ValueError(f"bad DAC conditioning {val:#x}")
                else:
                    dec.dc_cond[tb] = (val & 15, val >> 4)
        elif marker == 0xDD:                          # DRI
            (dec.restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00" and len(seg) >= 14:
            dec.jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            dec.adobe = seg[11]
        elif marker == 0xDA:                          # SOS
            pos = dec.scan(seg, data, pos)


def read_jpeg(path) -> np.ndarray:
    """Decode a JPEG → uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) CMYK,
    as ``imageio.v2.imread`` returns it."""
    try:
        return _decode(Path(path).read_bytes())
    except (ValueError, IndexError, struct.error) as e:
        raise ValueError(f"{path}: {e}") from None
