"""Lossless JPEG scans (SOF3, Huffman; ``jdlhuff.c``, ``jddiffct.c``,
``jdpred.c``, ``jdlossls.c``).

Each sample is its difference from a prediction, Huffman-coded as a DC
difference is (category 16 stands for 32768 with no further bits). The
samples are undifferenced a row at a time, modulo 2^16:

* the first row of the scan, and the first row of each iMCU row in which a
  restart marker was read, with the initial prediction 2^(P - Pt - 1) for
  its first sample and the sample to the left (Ra) for the rest;
* every other row with the sample above (Rb) for its first sample and the
  scan's predictor (1-7: Ra, Rb, Rc, Ra + Rb - Rc, Ra + (Rb - Rc) / 2,
  Rb + (Ra - Rc) / 2, (Ra + Rb) / 2, halves as arithmetic shifts) for the
  rest, Rc the sample above-left;

then shifted up by the point transform Pt and cut to 8 bits. A restart
interval must be a whole number of MCU rows, as libjpeg-turbo requires.
"""

from __future__ import annotations

import numpy as np

from nerf_sandbox_tpu_torch.data.jpeg_huffman import intervals_of

_M = 0xFFFF


def differences(intervals, order, luts, per, n):
    """The scan's coded differences → a list of ``n`` ints, each at its
    ``order`` offset."""
    out = [0] * n
    for buf, samples in intervals_of(intervals, order, per):
        pos = 0
        for off, slot in samples:
            b = pos >> 3
            w = int.from_bytes(buf[b:b + 5], "big")
            r = 40 - (pos & 7)
            e = luts[slot][(w >> (r - 16)) & 0xFFFF]
            if not e:
                raise ValueError("bad Huffman code")
            length, s = e >> 8, e & 31
            pos += length
            if s == 16:
                out[off] = 32768
            elif s:
                v = (w >> (r - length - s)) & ((1 << s) - 1)
                out[off] = v - (1 << s) + 1 if v < (1 << (s - 1)) else v
                pos += s
        if pos > 8 * (len(buf) - 8):
            raise ValueError("entropy-coded data ends early")
    return out


def undifference(diff, first_rows, psv, initial):
    """(rows, width) differences → samples modulo 2^16; the rows in
    ``first_rows`` start afresh from ``initial``."""
    out = np.empty_like(diff)
    for y in range(diff.shape[0]):
        d = diff[y]
        if y in first_rows:
            t = d.copy()
            t[0] += initial
            out[y] = np.cumsum(t) & _M
            continue
        b = out[y - 1]
        if psv in (1, 4, 5):              # Ra enters linearly: a running sum
            t = d.copy()
            t[0] += b[0]
            if psv == 4:
                t[1:] += b[1:] - b[:-1]
            elif psv == 5:
                t[1:] += (b[1:] - b[:-1]) >> 1
            out[y] = np.cumsum(t) & _M
        elif psv in (2, 3):
            x = d + b
            if psv == 3:
                x[1:] = d[1:] + b[:-1]
            out[y] = x & _M
        else:
            row, bl = d.tolist(), b.tolist()
            ra = (row[0] + bl[0]) & _M
            row[0] = ra
            for j in range(1, len(row)):
                if psv == 6:
                    ra = (row[j] + bl[j] + ((ra - bl[j - 1]) >> 1)) & _M
                else:
                    ra = (row[j] + ((ra + bl[j]) >> 1)) & _M
                row[j] = ra
            out[y] = row
    return out
