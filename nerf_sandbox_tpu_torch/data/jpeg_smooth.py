"""Block smoothing of progressive JPEGs (``jdcoefct.c``: ``smoothing_ok``,
``decompress_smooth_data``), libjpeg-turbo's default, which Pillow keeps.

When a progressive file's scans leave any of the first 9 AC coefficients
(zig-zag 1-9) of a component short of their last bit, or never send them,
each block's still-zero low-frequency coefficients are estimated from the
DC values of its 5 x 5 neighbourhood of blocks before the inverse DCT;
when none of the 9 was ever sent, the DC value is re-estimated too, and
the 9 from wider kernels. An estimate of a coefficient whose top bits were
sent is clamped below its first sent bit. The neighbourhood repeats the
edge blocks: columns clamped to the component's width, rows through the
library's row pointers, which count in the current iMCU row's block rows
(in an image's last iMCU rows that differs from clamping and can read the
padding blocks below the image). The stored coefficients stay as they
are; the estimates go only to the inverse DCT. Held bit for bit to
Pillow's output by ``tests/test_torch_jpeg_smooth.py``.
"""

from __future__ import annotations

import numpy as np

# zig-zag index k = 1..9 of the estimated coefficients; each kernel is the
# 5 x 5 weights of the DC values, rows top to bottom (DC01..DC25)
_WIDE = {    # none of zig-zag 1-9 ever sent: the DC re-estimated too (0)
    1: [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3],
        [-1, -1, 0, 1, 1]],
    2: [[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0, 0, 0, 0, 0], [1, -13, -38, -13, 1],
        [1, 3, 3, 3, 1]],
    3: [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]],
    4: [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0], [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]],
    5: [[0, 0, 0, 0, 0], [0, 2, -5, 2, 0], [1, 7, -14, 7, 1], [0, 2, -5, 2, 0], [0, 0, 0, 0, 0]],
    6: [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]],
    7: [[0, 0, 0, 0, 0], [0, 1, -3, 1, 0], [0, 0, 0, 0, 0], [0, -1, 3, -1, 0], [0, 0, 0, 0, 0]],
    8: [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, -3, 0, 3, 0], [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]],
    9: [[0, 0, 0, 0, 0], [0, 1, 2, 1, 0], [0, 0, 0, 0, 0], [0, -1, -2, -1, 0], [0, 0, 0, 0, 0]],
    0: [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
        [-2, -6, -8, -6, -2]],
}
_NARROW = {  # some of them sent: the first 5 only
    1: [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-7, 50, 0, -50, 7], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
    2: [[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0, 0, 0, 0, 0], [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]],
    3: [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]],
    4: [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0, 0, 0, 0, 0], [1, -10, 0, 10, -1],
        [0, 1, 0, -1, 0]],
    5: [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-1, 13, -24, 13, -1], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
}


def smoothing_ok(comps) -> bool:
    """``smoothing_ok``: every component has its DC partly sent and nonzero
    quantizers at the 10 positions, and some component lacks bits of a
    coefficient among zig-zag 1-9."""
    for c in comps:
        if "q" not in c or not np.all(c["q"][:10]) or c["bits"][0] < 0:
            return False
    return any(b != 0 for c in comps for b in c["bits"][1:10])


def _clamped(n: int) -> np.ndarray:
    """The 5 block columns each block of a row of ``n`` reads → (n, 5)."""
    return np.clip(np.arange(n)[:, None] + np.arange(-2, 3)[None], 0, n - 1)


def _pointer_rows(hib: int, v: int, imcu_rows: int) -> np.ndarray:
    """The 5 block rows each block row of a component reads, from the
    library's row pointers (``image_block_row`` counts in the current iMCU
    row's block rows) → (hib, 5)."""
    out = []
    for m in range(imcu_rows):
        block_rows = v if m < imcu_rows - 1 else (hib % v or v)
        image_rows = block_rows * imcu_rows
        for r in range(block_rows):
            at, cur = m * block_rows + r, m * v + r
            prev = cur - 1 if at > 0 else cur
            prev2 = cur - 2 if at > 1 else prev
            nxt = cur + 1 if at < image_rows - 1 else cur
            nxt2 = cur + 2 if at < image_rows - 2 else nxt
            out.append((prev2, prev, cur, nxt, nxt2))
    return np.array(out, np.int64)


def _estimate(num, q_dc, q, al):
    """pred = round(|num| / (q << 8)), clamped to 2^al - 1 when al > 0,
    with num's sign; ``num`` is already times ``q_dc``."""
    a = (np.abs(num) + (q << 7)) // (q << 8)
    if al > 0:
        a = np.minimum(a, (1 << al) - 1)
    return np.where(num >= 0, a, -a)


def smooth(zz: np.ndarray, c, q: np.ndarray, imcu_rows: int) -> np.ndarray:
    """A component's (bh, bw, 64) zig-zag coefficients (its padded grid) →
    its (hib, wib, 64) blocks for the inverse DCT, with the estimates."""
    hib, wib, bits = c["hib"], c["wib"], c["bits"]
    rows = _pointer_rows(hib, c["v"], imcu_rows)
    cols = _clamped(wib)
    dc = zz[..., 0]
    win = dc[rows[:, None, :, None], cols[None, :, None, :]]          # (hib, wib, 5, 5)
    out = zz[:hib, :wib].copy()
    wide = all(b == -1 for b in bits[1:10])
    kernels = _WIDE if wide else _NARROW
    for k in range(1, 10):
        if k not in kernels or bits[k] == 0:
            continue
        num = q[0] * np.einsum("hwab,ab->hw", win, np.array(kernels[k], np.int64))
        pred = _estimate(num, q[0], q[k], bits[k])
        cur = out[..., k]
        out[..., k] = np.where(cur == 0, pred, cur)
    if wide:
        num = q[0] * np.einsum("hwab,ab->hw", win, np.array(_WIDE[0], np.int64))
        out[..., 0] = _estimate(num, q[0], q[0], 0)
    return ((out + 0x8000) & 0xFFFF) - 0x8000
