"""Arithmetic-coded JPEG scans, sequential and progressive (``jdarith.c``),
decoded into a flat list of zig-zag coefficients.

The QM decoder of ITU-T T.81 Annex D with libjpeg's register layout: C
holds the code base and the unread bits (CT of them), A the interval; each
decision reads its probability state from a statistics bin and updates it
through Table D.2. The statistics: per DC table 64 bins (the conditioning
context S0 of each component, 0/4/8/12/16 from the last difference's sign
and magnitude against the DAC bounds L and U; X1..X15 at 20; the magnitude
bits 14 above), per AC table 256 (3 per coefficient index: end of band,
nonzero, magnitude; X2.. at 189 below Kx, 217 above), and a fixed bin at
probability 0.5 for the AC signs and refinements. They are cleared at the
start of each scan and at every restart, with the DC predictions.

Arguments as in :mod:`jpeg_huffman`; ``tables`` holds each slot's (DC
table, AC table) numbers, ``cond`` the DAC conditioning: {table: (L, U)}
for DC and {table: Kx} for AC.
"""

from __future__ import annotations

from nerf_sandbox_tpu_torch.data.jpeg_huffman import intervals_of

# T.81 Table D.2: Qe, next state after an LPS (with the MPS switch at bit
# 7), next state after an MPS; state 113 is the fixed 0.5 estimate.
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
QE = [q for q, _, _, _ in _D2]
NEXT_LPS = [lps | (switch << 7) for _, lps, _, switch in _D2]
NEXT_MPS = [mps for _, _, mps, _ in _D2]
FIXED = 113


class ReadLimit(ValueError):
    """The decoder needed a byte past the limit it was given."""


def qm_decoder(buf, limit=None):
    """→ decode(stats, i): the next binary decision of the interval ``buf``
    (stuffed zeros removed; zeros are read past its end, as after a
    marker), coded in bin ``stats[i]``, which it updates. Taking more than
    ``limit`` bytes (reading past the end counts) raises :class:`ReadLimit`."""
    c, a, ct, pos = 0, 0, -16, 0
    n = len(buf)
    if limit is None:
        limit = 1 << 62

    def decode(st, i):
        nonlocal c, a, ct, pos
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                if pos >= limit:
                    raise ReadLimit
                c = (c << 8) | (buf[pos] if pos < n else 0)
                pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000                  # two bytes read
            a <<= 1
        sv = st[i]
        s = sv & 0x7F
        qe = QE[s]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:                              # MPS, exchanged
                st[i] = (sv & 0x80) ^ NEXT_MPS[s]
            else:                                   # LPS
                st[i] = (sv & 0x80) ^ NEXT_LPS[s]
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:                              # LPS, exchanged
                st[i] = (sv & 0x80) ^ NEXT_LPS[s]
                sv ^= 0x80
            else:                                   # MPS
                st[i] = (sv & 0x80) ^ NEXT_MPS[s]
        return sv >> 7

    return decode


def _ac_magnitude(decode, st, i, x2):
    """Figures F.23/F.24 for an AC coefficient from its first magnitude bin
    ``i``, which decides twice, then X2 = ``x2`` upwards → |v| - 1."""
    if not decode(st, i):
        return 0
    if not decode(st, i):
        return 1
    m = 2
    while decode(st, x2):
        m <<= 1
        if m == 0x8000:
            raise ValueError("bad arithmetic code (magnitude overflow)")
        x2 += 1
    return _bits(decode, st, x2 + 14, m)


def _bits(decode, st, i, m):
    """The magnitude's bits below its top bit ``m``, in bin ``i``."""
    v, m = m, m >> 1
    while m:
        if decode(st, i):
            v |= m
        m >>= 1
    return v


def _dc_diff(decode, st, ctx, bounds):
    """One DC difference in the DC statistics ``st`` from context ``ctx``
    → (difference, next context)."""
    if not decode(st, ctx):
        return 0, 0
    sign = decode(st, ctx + 1)
    i = ctx + 2 + sign
    m = decode(st, i)
    if m:
        i = 20
        while decode(st, i):
            m <<= 1
            if m == 0x8000:
                raise ValueError("bad arithmetic code (magnitude overflow)")
            i += 1
    lo, hi = bounds
    ctx = 0 if m < (1 << lo) >> 1 else (12 + 4 * sign if m > (1 << hi) >> 1 else 4 + 4 * sign)
    v = _bits(decode, st, i + 14, m) + 1
    return (-v if sign else v), ctx


def _ac_value(decode, st, i, k, kx, fixed):
    """A nonzero AC coefficient at index ``k``, its first magnitude bin
    ``i``: the sign at probability 0.5, then the magnitude."""
    sign = decode(fixed, 0)
    v = _ac_magnitude(decode, st, i, 189 if k <= kx else 217) + 1
    return -v if sign else v


def _int16(v):
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v


def decode_scan(intervals, order, tables, per, coefs, cond, progressive, ss, se, ah, al,
                limits):
    """One arithmetic-coded scan into ``coefs``; ``limits`` holds each
    interval's byte limit (:func:`qm_decoder`)."""
    dc_cond, ac_cond = cond
    dc_used = sorted({d for d, _ in tables})
    ac_used = sorted({a for _, a in tables})
    for (buf, blocks), limit in zip(intervals_of(intervals, order, per), limits):
        decode = qm_decoder(buf, limit)
        fixed = bytearray([FIXED])
        dc_st = {t: bytearray(64) for t in dc_used}
        ac_st = {t: bytearray(256) for t in ac_used}
        last, ctx = [0] * len(tables), [0] * len(tables)
        if not progressive:
            for base, slot in blocks:
                dt, at = tables[slot]
                d, ctx[slot] = _dc_diff(decode, dc_st[dt], ctx[slot], dc_cond[dt])
                last[slot] = (last[slot] + d) & 0xFFFF
                coefs[base] = _int16(last[slot])
                st, kx, k = ac_st[at], ac_cond[at], 1
                while k <= 63:
                    i = 3 * (k - 1)
                    if decode(st, i):                   # end of block
                        break
                    while not decode(st, i + 1):
                        i += 3
                        k += 1
                        if k > 63:
                            raise ValueError("bad arithmetic code (index past 63)")
                    coefs[base + k] = _ac_value(decode, st, i + 2, k, kx, fixed)
                    k += 1
        elif ss == 0 and ah == 0:                       # DC first
            for base, slot in blocks:
                dt = tables[slot][0]
                d, ctx[slot] = _dc_diff(decode, dc_st[dt], ctx[slot], dc_cond[dt])
                last[slot] = (last[slot] + d) & 0xFFFF
                coefs[base] = _int16(last[slot] << al)
        elif ss == 0:                                   # DC refinement
            for base, _ in blocks:
                if decode(fixed, 0):
                    coefs[base] |= 1 << al
        elif ah == 0:                                   # AC first
            for base, slot in blocks:
                at = tables[slot][1]
                st, kx, k = ac_st[at], ac_cond[at], ss
                while k <= se:
                    i = 3 * (k - 1)
                    if decode(st, i):
                        break
                    while not decode(st, i + 1):
                        i += 3
                        k += 1
                        if k > se:
                            raise ValueError("bad arithmetic code (index past the band)")
                    coefs[base + k] = _ac_value(decode, st, i + 2, k, kx, fixed) << al
                    k += 1
        else:                                           # AC refinement
            p1, m1 = 1 << al, -1 << al
            for base, slot in blocks:
                st = ac_st[tables[slot][1]]
                kex = se
                while kex > 0 and not coefs[base + kex]:
                    kex -= 1
                k = ss
                while k <= se:
                    i = 3 * (k - 1)
                    if k > kex and decode(st, i):
                        break
                    while True:
                        c = coefs[base + k]
                        if c:                           # a correction bit
                            if decode(st, i + 2):
                                coefs[base + k] = c + m1 if c < 0 else c + p1
                            break
                        if decode(st, i + 1):           # newly nonzero
                            coefs[base + k] = m1 if decode(fixed, 0) else p1
                            break
                        i += 3
                        k += 1
                        if k > se:
                            raise ValueError("bad arithmetic code (index past the band)")
                    k += 1
