"""The card scatter's plan and order (``ops/hash_scatter.py``,
``csrc/hash_scatter.cu``) on the CPU, where no kernel runs.

* :func:`scatter_plan` as a pure function: the bucket shift from the width,
  the bucket count, the table's windows, tiles, stage, shared memory, the
  scratch's parts, and its refusals;
* a numpy model of the kernels' order (count per tile and bucket, the
  scans, one warp a tile moving its pairs 32 at a time with ranks inside a
  group of equal buckets, one warp a bucket adding each row's lanes in lane
  order in float32; a hot bucket split by row adds the same values in the
  same order; a table of several windows, one pass each) held bit-equal
  to ``hash_scatter_plain`` (``index_add_`` on the CPU) on spread,
  level-major (``corner_rows``), hot-row, out-of-range, stage-, tile- and
  window-boundary pairs, and to JAX's scatter-add
  (``.at[].add``, the transpose of the JAX package's table gather) on
  level-major keys;
* the model's partition is a stable sort of the pairs in range by bucket.

Bit-equal means equal float32 bit patterns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sandbox_tpu_torch.models import hashgrid as thg
from nerf_sandbox_tpu_torch.ops import hash_scatter as hs

FINE = 16 * 196608 * 8          # a fine pass of the CLI's hash step: 25.2 M pairs
ROWS = 16 * 2 ** 19             # the default tables' rows


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def model_scatter(keys, vals, n_rows, plan):
    """The kernels' order in numpy, a pass a window of the table's rows →
    ((n_rows, F) float32, the partition's flat indices in bucket order)."""
    keys = np.asarray(keys, np.int64)
    vals = np.asarray(vals, np.float32)
    out = np.zeros((n_rows, vals.shape[1]), np.float32)
    srcs = [np.zeros(0, np.int64)]
    for w in range(plan.windows):
        row0 = w * plan.window
        rows = min(plan.window, n_rows - row0)
        out[row0:row0 + rows], src = _model_pass(keys - row0, vals, rows, plan)
        srcs.append(src)
    return out, np.concatenate(srcs)


def _model_pass(keys, vals, n_rows, plan):
    """One pass on keys relative to its window of ``n_rows`` rows."""
    n, F = vals.shape
    s, tile, T = plan.shift, plan.tile, plan.tiles
    B = -(-n_rows >> s)
    valid = (keys >= 0) & (keys < n_rows)
    bucket = np.where(valid, keys >> s, -1)
    # 1. count: a tile's pairs in range per bucket
    counts = np.zeros((T, B), np.int64)
    for t in range(T):
        b = bucket[t * tile:(t + 1) * tile]
        counts[t] = np.bincount(b[b >= 0], minlength=B)
    # 2. scan: exclusive over the tiles within a bucket; the buckets' starts
    offsets = np.cumsum(counts, axis=0) - counts
    starts = np.concatenate([[0], np.cumsum(counts.sum(0))])
    # 3. partition: one warp a tile, 32 pairs at a time in flat order
    rows = np.full(starts[-1], -1, np.int64)
    src = np.full(starts[-1], -1, np.int64)
    lanes = np.arange(32)
    for t in range(T):
        dest = starts[:-1] + offsets[t]
        for g in range(t * tile, min(n, (t + 1) * tile), 32):
            b = bucket[g:min(g + 32, (t + 1) * tile, n)]
            peers = b[:, None] == b[None, :]                  # __match_any_sync
            rank = (peers & (lanes[None, :b.size] < lanes[:b.size, None])).sum(1)
            ok = b >= 0
            d = dest[b[ok]] + rank[ok]
            rows[d] = keys[g:g + b.size][ok] & ((1 << s) - 1)
            src[d] = g + lanes[:b.size][ok]
            lead = ok & (rank == 0)
            dest[b[lead]] += peers.sum(1)[lead]
    assert (rows >= 0).all()
    # 4. sum: one warp a bucket, its region 32 pairs at a time; the lowest
    # lane of a row adds the row's lanes in lane order (F <= 8,
    # csrc/hash_scatter.cu:HS_SMALL_F; a stage of hot rows, by owner lanes
    # walking its pairs in order, adds the same values in the same order),
    # else pair by pair
    out = np.zeros((B << s, F), np.float32)
    for b in range(B):
        acc = np.zeros((1 << s, F), np.float32)
        for g in range(starts[b], starts[b + 1], 32):
            r = rows[g:min(g + 32, starts[b + 1])]
            p = src[g:g + r.size]
            if F <= 8:
                for row in dict.fromkeys(r.tolist()):
                    a = acc[row].copy()
                    for lane in np.flatnonzero(r == row):
                        a = a + vals[p[lane]]
                    acc[row] = a
            else:
                for j in range(r.size):
                    acc[r[j]] = acc[r[j]] + vals[p[j]]
        out[b << s:(b + 1) << s] = acc
    return out[:n_rows], src


def _plain(keys, vals, n_rows):
    keys = np.asarray(keys, np.int64)
    ok = (keys >= 0) & (keys < n_rows)
    return hs.hash_scatter_plain(torch.from_numpy(keys[ok]),
                                 torch.from_numpy(np.asarray(vals, np.float32)[ok]),
                                 n_rows).numpy()


def _check(keys, vals, n_rows, tile, window_buckets=hs.WINDOW_BUCKETS):
    plan = hs.scatter_plan(len(keys), vals.shape[1], n_rows, tile=tile,
                           window_buckets=window_buckets)
    got, src = model_scatter(keys, vals, n_rows, plan)
    assert np.array_equal(_bits(got), _bits(_plain(keys, vals, n_rows)))
    k = np.asarray(keys, np.int64)
    ok = np.flatnonzero((k >= 0) & (k < n_rows))
    assert np.array_equal(src, ok[np.argsort(k[ok] >> plan.shift, kind="stable")])
    return plan


def _corner_keys(n_pts, where, seed):
    """Level-major keys of ``corner_rows`` at 3 levels x 2^10 rows: points
    spread over the box, in a ball of radius 0.01, or beyond one corner."""
    cfg = thg.HashGridConfig(n_levels=3, n_features=2, log2_table_size=10, base_res=4,
                             max_res=32, aabb_scale=1.5)
    rng = np.random.RandomState(seed)
    if where == "typical":
        pts = rng.uniform(-1.6, 1.6, (n_pts, 3))
    elif where == "ball":
        d = rng.normal(size=(n_pts, 3))
        pts = (np.array([0.1, 0.2, 0.3]) + 0.01 * d / np.linalg.norm(d, axis=1)[:, None]
               * rng.uniform(0, 1, (n_pts, 1)))
    else:
        pts = rng.uniform(1.6, 3.0, (n_pts, 3))
    keys = thg.corner_rows(torch.from_numpy(pts.astype(np.float32)), cfg)[0].reshape(-1)
    return keys.numpy(), cfg.n_levels * cfg.table_size


@pytest.mark.parametrize("F, shift", [(1, 11), (2, 11), (3, 10), (4, 10), (5, 9), (8, 9),
                                      (16, 8), (33, 6), (2048, 1), (4096, 0)])
def test_plan_shift_from_width(F, shift):
    """A bucket's sums are 2^s rows x F floats within SUM_FLOATS (16 KB),
    F = 1 on F = 2's buckets; the stage is 8 groups of 32 pairs where the
    values ride (F <= 2), one group where the flat index does."""
    plan = hs.scatter_plan(1000, F, 1000)
    assert plan.shift == shift
    assert (plan.window, plan.windows) == (1000, 1)
    assert plan.sum_smem == (1 << shift) * F * 4 <= 16384
    assert plan.buckets == -(-1000 >> shift)
    assert plan.stage == (256 if F <= 2 else 32)


def test_plan_of_the_fine_pass():
    """The CLI's fine pass (25.2 M pairs onto 16 x 2^19 rows of 2): buckets
    of 2048 rows, 4096 of them, 1536 tiles of 16384 pairs; the scratch is
    the count matrix (24 MiB), the totals, the starts and two queues,
    a 16-byte record a pair, the done flags and the rows' lists (8 bytes
    a pair). A rank's F = 1 piece: buckets of 2048 rows, 8-byte records."""
    p = hs.scatter_plan(FINE, 2, ROWS)
    assert (p.shift, p.buckets, p.tile, p.tiles, p.stage, p.sum_smem) == (
        11, 4096, 16384, 1536, 256, 16384)
    sizes = [1536 * 4096 * 4, 4096 * 4, 4099 * 4, FINE * 16, 4096 * 4, FINE * 8]
    assert p.parts[0] == 0
    assert all(b - a >= size and b % hs.ALIGN == 0
               for a, b, size in zip(p.parts, p.parts[1:] + (p.scratch_bytes,), sizes))
    assert p.scratch_bytes - sum(sizes) < len(sizes) * hs.ALIGN
    q = hs.scatter_plan(FINE, 1, ROWS)
    assert (q.shift, q.buckets, q.sum_smem, q.windows) == (11, 4096, 8192, 1)
    assert q.parts[4] - q.parts[3] == FINE * 8 and q.scratch_bytes - q.parts[5] == FINE * 4
    # the flat index rides at F = 3: 8 bytes a pair, whatever the width; no lists
    r = hs.scatter_plan(FINE, 3, ROWS)
    assert r.parts[4] - r.parts[3] == FINE * 8 and r.scratch_bytes == r.parts[5]


@pytest.mark.parametrize("F, log2, shift, windows", [
    (2, 21, 13, 1), (2, 22, 13, 1), (2, 23, 13, 2), (2, 24, 13, 4), (1, 24, 14, 2),
    (4, 22, 12, 2), (8, 21, 11, 2), (8, 24, 11, 16)])
def test_plan_grows_buckets_for_large_tables(F, log2, shift, windows):
    """More rows than MAX_BUCKETS buckets of the width's shift hold: the
    shift grows (more shared memory a bucket) up to MAX_SUM_BYTES; beyond,
    the table is taken in windows of WINDOW_BUCKETS buckets, a pass each:
    the CLI's 16 levels at ``--hash_log2_size`` 21 to 24, Instant-NGP's
    largest tables among them."""
    n_rows = 16 * 2 ** log2
    p = hs.scatter_plan(10, F, n_rows)
    assert (p.shift, p.windows) == (shift, windows)
    assert p.sum_smem == (1 << shift) * F * 4 <= hs.MAX_SUM_BYTES
    assert p.window == min(n_rows, hs.WINDOW_BUCKETS << shift)
    assert p.window % (1 << shift) == 0
    assert p.buckets == -(-p.window >> shift) <= hs.WINDOW_BUCKETS
    assert (p.windows - 1) * p.window < n_rows <= p.windows * p.window
    assert p.parts[1] - p.parts[0] >= p.tiles * p.buckets * 4   # one pass's counts
    q = hs.scatter_plan(10, 4096, 4096 * 64)                     # the widest rows
    assert (q.shift, q.windows, q.sum_smem) == (2, 8, hs.MAX_SUM_BYTES)


def test_plan_refusals_and_empty_sizes():
    for F in (0, 4097):
        with pytest.raises(ValueError, match="1 to 4096"):
            hs.scatter_plan(10, F, 10)
    with pytest.raises(ValueError, match="pairs"):
        hs.scatter_plan(2 ** 31, 2, 10)
    with pytest.raises(ValueError, match="multiple of 32"):
        hs.scatter_plan(10, 2, 10, tile=100)
    with pytest.raises(ValueError, match="rows"):
        hs.scatter_plan(10, 2, -1)
    p = hs.scatter_plan(0, 2, 5000)
    assert (p.tiles, p.buckets, p.windows) == (0, 3, 1)
    assert (hs.scatter_plan(10, 2, 0).buckets, hs.scatter_plan(10, 2, 0).windows) == (0, 0)


def test_hot_rows_of_clamped_points_share_buckets_in_pairs():
    """Why the beyond-the-box batch is the scatter's slowest: points clamped
    onto the box's corner put every level's pairs on 8 rows (runs of a
    point count), and the corners x and x + 1 of a cell, whose rows differ
    in the low bits only (the hash's x prime is 1), fall in one bucket of
    2^s consecutive rows: at the CLI's widths the 128 hot rows fall in 64
    buckets, two runs each."""
    cfg = thg.HashGridConfig(aabb_scale=1.5)       # 16 x 2^19 x 2
    pts = np.random.RandomState(9).uniform(1.6, 3.0, (500, 3)).astype(np.float32)
    keys = thg.corner_rows(torch.from_numpy(pts), cfg)[0].numpy().reshape(-1)
    hot, runs = np.unique(keys, return_counts=True)
    assert hot.size == 16 * 8 and (runs == 500).all()
    s = hs.scatter_plan(keys.size, 2, 16 * 2 ** 19).shift
    per_bucket = np.bincount(hot >> s)
    assert per_bucket.max() == 2 and (per_bucket == 2).sum() == 64


@pytest.mark.parametrize("F", [1, 2, 3])
def test_model_spread_keys(F):
    rng = np.random.RandomState(F)
    keys = rng.randint(0, 5000, 6000)
    vals = rng.normal(size=(6000, F)).astype(np.float32)
    plan = _check(keys, vals, 5000, tile=512)     # n_rows not a multiple of 2^s
    assert plan.tiles == 12 and 5000 % (1 << plan.shift)


@pytest.mark.parametrize("where", ["typical", "ball", "beyond"])
def test_model_level_major_keys(where):
    """``corner_rows``' level-major keys; in the ball and beyond the box
    every coarse level's pairs fall on 8 rows (runs of a few hundred)."""
    keys, n_rows = _corner_keys(300, where, seed=3)
    vals = np.random.RandomState(4).normal(size=(keys.size, 2)).astype(np.float32)
    _check(keys, vals, n_rows, tile=1024)
    if where == "beyond":
        assert np.bincount(keys).max() == 300


def test_model_level_major_keys_match_jax_scatter_add():
    """The model against JAX's scatter-add on the same level-major pairs,
    the transpose XLA computes for the JAX package's table gather."""
    keys, n_rows = _corner_keys(200, "typical", seed=5)
    vals = np.random.RandomState(6).normal(size=(keys.size, 2)).astype(np.float32)
    plan = hs.scatter_plan(keys.size, 2, n_rows, tile=512)
    got, _ = model_scatter(keys, vals, n_rows, plan)
    want = np.asarray(jnp.zeros((n_rows, 2), jnp.float32).at[keys].add(vals))
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("F", [1, 2, 3])
def test_model_hot_row(F):
    """A row of 1500 pairs among 1000 spread ones, shuffled: whole groups of
    one row, the lowest lane adding 32 lanes onto the running sum."""
    rng = np.random.RandomState(10 + F)
    keys = np.concatenate([rng.randint(0, 3000, 1000), np.full(1500, 7)])
    keys = keys[rng.permutation(keys.size)]
    vals = rng.normal(size=(keys.size, F)).astype(np.float32)
    _check(keys, vals, 3000, tile=256)
    sorted_keys = np.sort(keys)                   # runs in place: groups all one row
    _check(sorted_keys, vals, 3000, tile=256)


def test_model_skips_keys_out_of_range():
    rng = np.random.RandomState(20)
    keys = np.concatenate([rng.randint(0, 64, 500), [-1] * 40, [64] * 3, [69] * 30])
    keys = keys[rng.permutation(keys.size)]
    vals = rng.normal(size=(keys.size, 2)).astype(np.float32)
    plan = _check(keys, vals, 64, tile=128)
    assert plan.buckets == 1


@pytest.mark.parametrize("m", [31, 32, 33, 255, 256, 257, 511, 513])
def test_model_stage_and_tile_boundaries(m):
    """A bucket of m pairs (across the group of 32 and the stage of 256)
    and n one off a tile boundary."""
    rng = np.random.RandomState(m)
    hot = rng.randint(0, 40, m)                   # bucket 0, 40 rows: repeats in groups
    rest = rng.randint(2048, 6000, 3 * 128 + 1 - m % 128)
    keys = np.concatenate([hot, rest])
    keys = keys[rng.permutation(keys.size)]
    vals = rng.normal(size=(keys.size, 2)).astype(np.float32)
    plan = _check(keys, vals, 6000, tile=128)
    assert plan.tiles == -(-keys.size // 128)


@pytest.mark.parametrize("F, window_buckets", [(1, 1), (2, 2), (3, 4)])
def test_model_table_in_windows(F, window_buckets):
    """A table of several windows (``window_buckets`` buckets a pass):
    spread keys, hot rows on either side of each window's first row, and
    keys out of range, each pass keeping the keys in its window."""
    plan = hs.scatter_plan(1, F, 10 ** 6, window_buckets=window_buckets)
    n_rows = 3 * plan.window + 777                 # the last window a part one
    rng = np.random.RandomState(40 + F)
    edges = np.arange(1, 4) * plan.window
    keys = np.concatenate([rng.randint(0, n_rows, 3000),
                           np.repeat(np.concatenate([edges - 1, edges]), 70),
                           [-5, n_rows, n_rows + 9] * 20])
    keys = keys[rng.permutation(keys.size)]
    vals = rng.normal(size=(keys.size, F)).astype(np.float32)
    plan = _check(keys, vals, n_rows, tile=512, window_buckets=window_buckets)
    assert plan.windows == 4 and plan.buckets == window_buckets
