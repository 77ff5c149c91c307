"""Huffman-coded JPEG scans: sequential and progressive (``jdhuff.c``,
``jdphuff.c``), decoded into a flat list of zig-zag coefficients.

Every decoder takes the scan's restart intervals (stuffed zeros removed),
``order``, its blocks in coding order as (offset into ``coefs``, component
slot in the scan), and ``per``, the blocks of one restart interval. A
restart resets the DC predictions and the end-of-band run. The decoding is
a Python loop over the coded symbols with a 16-bit lookup table per code.
"""

from __future__ import annotations

import numpy as np

_PAD = b"\x00" * 8


def huffman_lut(counts, symbols):
    """Canonical Huffman code → a 65536-entry list: the entry of every 16-bit
    window that starts with a code holds (length << 8) | symbol, 0 for
    windows that start with no code."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                raise ValueError("bad Huffman table")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    return lut.tolist()


def intervals_of(intervals, order, per):
    """→ [(interval bytes padded with zeros, its blocks)], checking that the
    scan holds as many intervals as its blocks need."""
    n = -(-len(order) // per) if order else 0
    if len(intervals) < n:
        raise ValueError("fewer restart intervals than the image needs")
    return [(intervals[i] + _PAD, order[i * per:(i + 1) * per]) for i in range(n)]


def _extend(v, s):
    """HUFF_EXTEND: the s-bit value ``v`` as a signed difference."""
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _check_end(pos, buf):
    if pos > 8 * (len(buf) - len(_PAD)):
        raise ValueError("entropy-coded data ends early")


def sequential(intervals, order, luts, per, coefs):
    """A sequential scan: each block's DC difference and its 63 ACs.
    ``luts`` holds each slot's (DC lut, AC lut)."""
    for buf, blocks in intervals_of(intervals, order, per):
        pos, pred = 0, [0] * len(luts)
        for base, slot in blocks:
            dc_lut, ac_lut = luts[slot]
            k, lut = 0, dc_lut
            while k < 64:
                b = pos >> 3
                w = int.from_bytes(buf[b:b + 5], "big")
                r = 40 - (pos & 7)
                e = lut[(w >> (r - 16)) & 0xFFFF]
                if not e:
                    raise ValueError("bad Huffman code")
                length = e >> 8
                s = e & 15
                if k == 0:                                  # DC difference
                    v = 0
                    if s:
                        v = _extend((w >> (r - length - s)) & ((1 << s) - 1), s)
                    pos += length + s
                    pred[slot] += v
                    coefs[base] = pred[slot]
                    k, lut = 1, ac_lut
                    continue
                run = (e >> 4) & 15
                pos += length
                if s == 0:
                    if run != 15:                           # end of block
                        break
                    k += 16
                    continue
                k += run
                if k > 63:
                    raise ValueError("coefficient index past 63")
                coefs[base + k] = _extend((w >> (r - length - s)) & ((1 << s) - 1), s)
                pos += s
                k += 1
        _check_end(pos, buf)


def dc_first(intervals, order, luts, per, coefs, al):
    """DC first scan: each block's DC difference, shifted up by ``al``."""
    for buf, blocks in intervals_of(intervals, order, per):
        pos, pred = 0, [0] * len(luts)
        for base, slot in blocks:
            b = pos >> 3
            w = int.from_bytes(buf[b:b + 5], "big")
            r = 40 - (pos & 7)
            e = luts[slot][(w >> (r - 16)) & 0xFFFF]
            if not e:
                raise ValueError("bad Huffman code")
            length, s = e >> 8, e & 15
            if s:
                pred[slot] += _extend((w >> (r - length - s)) & ((1 << s) - 1), s)
            pos += length + s
            coefs[base] = pred[slot] << al
        _check_end(pos, buf)


def dc_refine(intervals, order, per, coefs, al):
    """DC refinement scan: one bit a block, OR-ed into bit ``al``."""
    p1 = 1 << al
    for buf, blocks in intervals_of(intervals, order, per):
        bits = np.unpackbits(np.frombuffer(buf, np.uint8))[:len(blocks)].tolist()
        for (base, _), bit in zip(blocks, bits):
            if bit:
                coefs[base] |= p1
        _check_end(len(blocks), buf)


def ac_first(intervals, order, lut, per, coefs, ss, se, al):
    """AC first scan over coefficients ``ss..se`` of one component, with
    end-of-band runs."""
    for buf, blocks in intervals_of(intervals, order, per):
        pos, eobrun = 0, 0
        for base, _ in blocks:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                b = pos >> 3
                w = int.from_bytes(buf[b:b + 5], "big")
                r = 40 - (pos & 7)
                e = lut[(w >> (r - 16)) & 0xFFFF]
                if not e:
                    raise ValueError("bad Huffman code")
                length, run, s = e >> 8, (e >> 4) & 15, e & 15
                pos += length
                if s:
                    k += run
                    if k > se:
                        raise ValueError("coefficient index past the band")
                    coefs[base + k] = _extend(
                        (w >> (r - length - s)) & ((1 << s) - 1), s) << al
                    pos += s
                    k += 1
                elif run == 15:
                    k += 16
                else:
                    eobrun = 1 << run
                    if run:
                        eobrun += (w >> (r - length - run)) & ((1 << run) - 1)
                        pos += run
                    eobrun -= 1
                    break
        _check_end(pos, buf)


def ac_refine(intervals, order, lut, per, coefs, ss, se, al):
    """AC refinement scan: one correction bit for each coefficient already
    nonzero, newly nonzero ones (+-1 at bit ``al``) with their zero runs,
    and end-of-band runs over which only the corrections are sent."""
    p1, m1 = 1 << al, -1 << al
    for buf, blocks in intervals_of(intervals, order, per):
        pos, eobrun = 0, 0
        for base, _ in blocks:
            k = ss
            if eobrun == 0:
                while k <= se:
                    b = pos >> 3
                    w = int.from_bytes(buf[b:b + 5], "big")
                    r = 40 - (pos & 7)
                    e = lut[(w >> (r - 16)) & 0xFFFF]
                    if not e:
                        raise ValueError("bad Huffman code")
                    length, run, s = e >> 8, (e >> 4) & 15, e & 15
                    pos += length
                    if s:
                        bit = (buf[pos >> 3] >> (7 - (pos & 7))) & 1
                        pos += 1
                        s = p1 if bit else m1
                    elif run != 15:
                        eobrun = 1 << run
                        if run:
                            eobrun += (w >> (r - length - run)) & ((1 << run) - 1)
                            pos += run
                        break
                    while k <= se:                  # skip `run` zeros
                        c = coefs[base + k]
                        if c:
                            if (buf[pos >> 3] >> (7 - (pos & 7))) & 1 and not c & p1:
                                coefs[base + k] = c + p1 if c >= 0 else c + m1
                            pos += 1
                        elif run == 0:
                            break
                        else:
                            run -= 1
                        k += 1
                    if s:
                        if k > se:
                            raise ValueError("coefficient index past the band")
                        coefs[base + k] = s
                    k += 1
            if eobrun:
                for i in range(base + k, base + se + 1):
                    c = coefs[i]
                    if c:
                        if (buf[pos >> 3] >> (7 - (pos & 7))) & 1 and not c & p1:
                            coefs[i] = c + p1 if c >= 0 else c + m1
                        pos += 1
                eobrun -= 1
        _check_end(pos, buf)
