"""The hash tables' gradient: a deterministic scatter-add (``csrc/hash_scatter.cu``).

Replaces no TPU kernel. The JAX package trains hash tables through XLA,
whose scatter-add (the transpose of ``models/hashgrid.py``'s table gather)
sums each row's contributions in a fixed order. PyTorch's scatter on CUDA
(``index_add_``, and ``index_put_(accumulate=True)`` unless the process sets
``torch.use_deterministic_algorithms``) adds with atomics, in an order that
changes from run to run, so a captured train chunk could not be bit-equal to
the same eager steps. This module computes the same sum in one fixed order:

* :func:`hash_scatter_plain` (any device; the CPU path): ``index_add_`` into
  zeros, which on the CPU adds the rows in the order of ``keys``, as XLA's
  CPU scatter does;
* on the card: six hand-written kernels (:func:`scatter_plan` sizes them).
  The pairs are counted per bucket of 2^s consecutive rows, tile by tile;
  the counts are scanned into each (bucket, tile)'s place; one warp a tile
  moves its pairs into their buckets in flat order (no atomic decides an
  order); one warp a bucket adds each row's pairs in that order onto the
  row's sum in shared memory, then writes every row of the bucket, and a
  hot bucket (many pairs on few rows) is split by row across a block,
  each row's values summed in order by one warp. A table of more rows
  than one pass's buckets hold is taken in windows of rows, a pass of the
  kernels each. The sum
  is the CPU's sequential one, so the card's result on given (keys, values)
  is bit-equal to the plain version on CPU copies of them.

No host sync, no data-dependent size, no library kernel: a CUDA graph
captures it (``train/step.py:build_train_chunk``). Bound on the H100: the
bytes of the keys, the values and the table written once (HBM); the
count reads the keys once more, and the partition writes a record a pair
that the sum reads back, about 1.3 GB at 25 M pairs of F = 2.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from nerf_sandbox_tpu_torch.ops import cuda_build

SUM_FLOATS = 4096           # a bucket's sums: 2^s rows x max(F, 2) floats (16 KB)
MAX_SUM_BYTES = 64 * 1024   # s grows past SUM_FLOATS for a large table up to this
MAX_BUCKETS = 4096          # buckets past which s grows
WINDOW_BUCKETS = 8192       # a pass's buckets at most: a partition warp's destinations
TILE = 16384                # pairs a count block and a partition warp take
UNROLL = 8                  # csrc/hash_scatter.cu:HS_UNROLL, groups of 32 a stage
MAX_PAIRS = 2 ** 31 - 1     # flat indices and offsets are 32-bit
ALIGN = 256                 # bytes; each part of the scratch starts on it


class ScatterPlan(NamedTuple):
    """The kernels' sizes for ``n`` pairs of ``F`` features onto ``n_rows``
    rows (:func:`scatter_plan`)."""

    n: int
    F: int
    n_rows: int
    shift: int          # s: a bucket is 2^s consecutive rows
    window: int         # rows a pass of the kernels takes (a multiple of 2^s)
    windows: int        # passes
    buckets: int        # a pass's
    tile: int           # pairs a count block and a partition warp take
    tiles: int
    stage: int          # pairs a warp holds at once in the partition and the sum
    sum_smem: int       # bytes of shared memory a sum warp holds (its bucket's sums)
    parts: tuple        # byte offsets of counts, totals, starts, records, done, lists
    scratch_bytes: int


def _aligned(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


def scatter_plan(n: int, F: int, n_rows: int, tile: int = TILE,
                 window_buckets: int = WINDOW_BUCKETS) -> ScatterPlan:
    """The plan of :func:`hash_scatter` as a pure function of its sizes.

    s is the largest shift whose bucket of 2^s rows x max(F, 2) floats fits
    :data:`SUM_FLOATS` (F = 1, 2: 11, F = 3: 10, F = 4096: 0; F = 1 keeps
    F = 2's buckets, since one warp walks each of the hot coarse-level
    buckets), raised while the table has more than :data:`MAX_BUCKETS`
    buckets and a bucket of 2^(s + 1) rows fits :data:`MAX_SUM_BYTES` (bucket
    k >> s holds rows k of 2^s consecutive ones). A table of more than
    ``window_buckets`` buckets is taken in windows of that many, one pass of
    the kernels each, which keeps the keys in its window. The scratch, one
    pass's: the tile-major count matrix (tiles x buckets), the buckets' totals,
    their starts and two bucket queues (uint32), a record a pair in its
    bucket (its row within the bucket and its F values, 16 bytes at F = 2,
    8 at F = 1; for a wider row its flat index, 8 bytes), a done flag a
    bucket, and for F <= 2 the rows' lists of the buckets split by row
    (F floats a pair), each part aligned to :data:`ALIGN` bytes. Raises
    ValueError for a width outside 1..4096, more than :data:`MAX_PAIRS`
    pairs, or a tile that is not a positive multiple of 32."""
    n, F, n_rows, tile = int(n), int(F), int(n_rows), int(tile)
    if not 1 <= F <= 4096:
        raise ValueError(f"hash_scatter: {F} features a row; the kernels take 1 to 4096")
    if not 0 <= n <= MAX_PAIRS:
        raise ValueError(f"hash_scatter: {n} pairs; the kernels take up to {MAX_PAIRS}")
    if n_rows < 0:
        raise ValueError(f"hash_scatter: {n_rows} rows")
    if tile <= 0 or tile % 32:
        raise ValueError(f"hash_scatter: a tile of {tile} pairs is not a multiple of 32")
    s = (SUM_FLOATS // max(F, 2)).bit_length() - 1
    while -(-n_rows >> s) > MAX_BUCKETS and (2 << s) * F * 4 <= MAX_SUM_BYTES:
        s += 1
    window = min(n_rows, window_buckets << s)
    buckets = -(-window >> s)
    tiles = -(-n // tile)
    sizes = (tiles * buckets * 4, buckets * 4, (buckets + 3) * 4,
             n * (16 if F == 2 else 8), buckets * 4, n * F * 4 if F <= 2 else 0)
    parts, at = [], 0
    for size in sizes:
        parts.append(at)
        at += _aligned(size)
    return ScatterPlan(n=n, F=F, n_rows=n_rows, shift=s, window=window,
                       windows=-(-n_rows // window) if n_rows else 0, buckets=buckets,
                       tile=tile, tiles=tiles, stage=32 * UNROLL if F <= 2 else 32,
                       sum_smem=(1 << s) * F * 4, parts=tuple(parts), scratch_bytes=at)


def hash_scatter_plain(keys: torch.Tensor, values: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """(n,) int row keys, (n, F) fp32 values → (n_rows, F) fp32 row sums, by
    ``index_add_`` into zeros on ``values``' device."""
    out = torch.zeros((int(n_rows), values.shape[1]), dtype=torch.float32,
                      device=values.device)
    return out.index_add_(0, keys.reshape(-1), values.to(torch.float32))


@functools.cache
def _scatter_fn():
    """The C entry, its argument types set once."""
    fn = cuda_build.load("hash_scatter").nerf_hash_scatter
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 8)
    fn.restype = ctypes.c_int
    return fn


def _launch(keys: torch.Tensor, values: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plan, allocate and launch the kernels on the current stream."""
    if keys.dtype != torch.int32:
        raise ValueError(f"hash_scatter: keys must be int32, got {keys.dtype}")
    if values.dtype != torch.float32 or values.ndim != 2:
        raise ValueError("hash_scatter: values must be (n, F) float32")
    if keys.numel() != values.shape[0]:
        raise ValueError(f"hash_scatter: {keys.numel()} keys for "
                         f"{values.shape[0]} value rows")
    if keys.device != values.device or values.device.type != "cuda":
        raise ValueError("hash_scatter: keys and values must be on one CUDA device")
    n, F = values.shape
    plan = scatter_plan(n, F, n_rows)
    keys = keys.reshape(-1).contiguous()
    out = torch.empty((plan.n_rows, F), dtype=torch.float32, device=values.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=values.device)
    base = scratch.data_ptr()
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = _scatter_fn()(keys.data_ptr(), values.data_ptr(), n, F, plan.n_rows,
                        plan.shift, plan.window, plan.tile,
                        *(base + at for at in plan.parts), out.data_ptr(),
                        ctypes.c_void_p(stream))
    cuda_build.check(cuda_build.load("hash_scatter"), err, "hash_scatter kernel launch")
    hash_scatter.launches += 1
    return out


def hash_scatter(keys: torch.Tensor, values: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Row sums of ``values`` by ``keys`` (int32, each in [0, n_rows)) →
    (n_rows, F) fp32, each row's values added in the order of ``keys``.

    On the CPU the plain version; on a CUDA tensor the kernels, or it raises.
    Keys outside [0, n_rows) are the caller's error: the plain version raises
    on them, the kernels skip them without a word (they cannot raise without
    a host sync, which a graph capture refuses). :func:`hash_encode
    <nerf_sandbox_tpu_torch.models.hashgrid.hash_encode>` makes only keys in
    range."""
    if values.device.type == "cpu":
        return hash_scatter_plain(keys, values, n_rows)
    return _launch(keys, values.contiguous(), n_rows)


hash_scatter.launches = 0
