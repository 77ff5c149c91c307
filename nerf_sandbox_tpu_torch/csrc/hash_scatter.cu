// The hash tables' gradient: row sums of (key, value) pairs, each row's
// values added in the keys' flat order (ops/hash_scatter.py).
//
// Replaces no TPU kernel: the JAX package leaves this scatter-add (the
// transpose of models/hashgrid.py's table gather) to XLA, which adds each
// row's values in a fixed order. PyTorch's CUDA scatter adds with atomics,
// in an order that changes from run to run; these kernels make the port's
// table gradient bit-identical from run to run, and bit-equal to the CPU's
// sequential index_add_ on the same pairs, so that a CUDA graph of train
// steps stays bit-equal to the same steps run eagerly.
// Bound on the H100: HBM bytes, the keys and values read once and the table
// written once.
// Design: a stable partition of the pairs into buckets of 2^s consecutive
// rows, then one warp a bucket summing its rows in shared memory, a hot
// bucket split by row across a block; six kernels, all named
// hash_scatter_*, about 1.3 GB moved at 25 M pairs of F = 2 (keys read
// twice, a 16-byte record a pair written and read back):
// 1. count: one block a tile of pairs counts its keys per bucket in shared
//    counters and writes its row of the tile-major count matrix.
// 2. scan: scan_tiles turns each bucket's column of counts into exclusive
//    offsets over the tiles, and its total; scan_buckets the totals into the
//    buckets' starts and zeroes the sum's bucket queue. A fixed order.
// 3. partition: one warp a tile, the destination of every bucket in shared
//    memory (the bucket's start plus the tile's offset), walks its tile in
//    flat order 32 pairs at a time: ballots, one a bit of the bucket's
//    index, group the lanes of one bucket, a lane's rank is the number of
//    its group's lanes below it, the group's lowest lane advances the
//    destination. No atomic decides an order, so each bucket's region holds
//    its pairs in flat order. A pair goes as one record (one store; a row
//    array and a value array took three times as long): its row within the
//    bucket and, for F <= 2, its values, for a wider row its flat index.
//    The stores land scattered, a transaction a pair: they are the
//    partition's cost.
// 4. sum: warps taking buckets from a queue, a bucket's 2^s rows' sums in
//    shared memory from 0.0f, its region walked in order 256 pairs (a
//    stage) at a time: a stage of few rows (hot rows) by owner lanes that
//    keep their rows' sums in registers; else 32 pairs at a time, each lane
//    onto its row where the group's rows are distinct, else the lowest lane
//    of each row adding the row's lanes in lane order. A wider row goes pair
//    by pair, the lanes over its features. Then all 2^s rows are written,
//    zeros included: the table needs no fill. Before it, sum_big takes the
//    buckets of more than HS_BIG pairs and at most HS_BIG_ROWS rows (hot
//    rows: clamped samples, the coarse levels; a clamped cell's corners x
//    and x + 1 share a bucket): a block copies each row's values out in
//    flat order and sums each row's list with one warp, so the rows of a
//    hot bucket add side by side instead of one warp walking them all.
// Each row's values are added in their flat order from 0.0f, as the CPU's
// index_add_ adds them, so the result is bit-equal to it. A table of more
// rows than a pass's buckets hold (2^s rows each, the partition's
// destinations in shared memory) is taken in windows of that many rows, one
// pass of the six kernels a window, each pass keeping the keys in its
// window: every row lies in one window, so its sum is the same. Grid sizes
// follow from n, F, n_rows and the plan only, and nothing is allocated
// here: a CUDA graph captures the launches.
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_ROW = 0xffffu;   // the row or bucket of a lane without a pair
constexpr int HS_UNROLL = 8;         // groups of 32 pairs a warp loads at once (a stage)
constexpr int HS_COUNT_THREADS = 256;
constexpr int HS_SCAN_WARPS = 8;
constexpr int HS_SCAN_THREADS = 1024;
constexpr int HS_MAX_SHIFT = 15;     // rows of a bucket: 2^s, s < 16
constexpr int HS_SUM_WARPS = 2048;   // sum warps, each taking buckets from a queue
constexpr unsigned HS_BIG = 1u << 15;  // pairs above which a bucket may go to sum_big
constexpr int HS_BIG_WARPS = 8;
constexpr int HS_BIG_BLOCKS = 128;
constexpr int HS_BIG_ROWS = 32;      // rows a bucket holds at most for sum_big
constexpr int HS_BIG_BATCH = 512;    // pairs a sum_big warp stages at once
constexpr int HS_MAX_SUM_BYTES = 64 * 1024;   // ops/hash_scatter.py:MAX_SUM_BYTES
constexpr int HS_SMALL_F = 8;        // widths above 2 up to this: a lane a pair in the sum

// Buckets: bucket k >> s holds the 2^s consecutive rows from its first; a
// row's place in it is k & (2^s - 1).
__device__ __forceinline__ unsigned bucket_of(unsigned k, int s) { return k >> s; }
__device__ __forceinline__ unsigned place_of(unsigned k, int s) {
  return k & ((1u << s) - 1u);
}
__host__ __device__ __forceinline__ long long buckets_of(long long n_rows, int s) {
  return (n_rows + (1LL << s) - 1) >> s;
}

// A pair in its bucket, one 8- or 16-byte store: the row within the bucket,
// then for F = VF = 1, 2 the values' bits, for any other width (VF = 0) the
// pair's flat index (two stores, a row array and a value array, cost the
// partition three times one store: each is a transaction a lane).
template <int VF> struct Rec { using T = uint2; };
template <> struct Rec<2> { using T = uint4; };

template <int VF>
__device__ __forceinline__ typename Rec<VF>::T load_rec(const float* __restrict__ vals,
                                                        long long p, unsigned row) {
  if constexpr (VF == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(vals) + p);
    return make_uint4(row, __float_as_uint(v.x), __float_as_uint(v.y), 0u);
  } else if constexpr (VF == 1) {
    return make_uint2(row, __float_as_uint(__ldg(vals + p)));
  } else {
    return make_uint2(row, static_cast<unsigned>(p));
  }
}

__device__ __forceinline__ float rec_value(uint2 r, int) { return __uint_as_float(r.y); }
__device__ __forceinline__ float rec_value(uint4 r, int f) {
  return __uint_as_float(f ? r.z : r.y);
}

// The lanes whose 16-bit key equals this lane's: one ballot a bit.
// (__match_any_sync takes about one pass a distinct key, 32 for spread
// keys, and made the partition several times slower on them.) A lane
// without a pair passes 0xffff, above every bucket index.
__device__ __forceinline__ unsigned peers16(unsigned key) {
  unsigned peers = FULL;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const bool bit = (key >> i) & 1u;
    const unsigned on = __ballot_sync(FULL, bit);
    peers &= bit ? on : ~on;
  }
  return peers;
}

// A key in the window of `rows` rows from row0.
__device__ __forceinline__ bool in_window(int k, long long row0, long long rows) {
  return k >= row0 && k < row0 + rows;
}

// 1. One block a tile: the tile's pairs in the window counted per bucket
// (shared atomics; a count has no order).
__global__ void __launch_bounds__(HS_COUNT_THREADS)
hash_scatter_count(const int* __restrict__ keys, long long n, int s, long long row0,
                   long long rows, int buckets, int tile, unsigned* __restrict__ counts) {
  extern __shared__ unsigned hist[];
  for (int b = threadIdx.x; b < buckets; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const long long lo = static_cast<long long>(blockIdx.x) * tile;
  const long long hi = min(n, lo + tile);
  for (long long p0 = lo + threadIdx.x; p0 < hi; p0 += HS_COUNT_THREADS * HS_UNROLL) {
    int k[HS_UNROLL];
#pragma unroll
    for (int u = 0; u < HS_UNROLL; ++u) {
      const long long p = p0 + u * HS_COUNT_THREADS;
      k[u] = p < hi ? __ldg(keys + p) : -1;
    }
#pragma unroll
    for (int u = 0; u < HS_UNROLL; ++u)
      if (in_window(k[u], row0, rows)) atomicAdd(hist + bucket_of(k[u] - row0, s), 1u);
  }
  __syncthreads();
  unsigned* row = counts + static_cast<size_t>(blockIdx.x) * buckets;
  for (int b = threadIdx.x; b < buckets; b += blockDim.x) row[b] = hist[b];
}

// 2a. One block 32 buckets (a lane each), its warps contiguous ranges of
// tiles: the counts become exclusive offsets over the tiles in place, and
// the last warp writes each bucket's total.
__global__ void __launch_bounds__(HS_SCAN_WARPS * 32)
hash_scatter_scan_tiles(unsigned* __restrict__ counts, int tiles, int buckets,
                        unsigned* __restrict__ totals) {
  __shared__ unsigned part[HS_SCAN_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const int per = (tiles + HS_SCAN_WARPS - 1) / HS_SCAN_WARPS;
  const int t0 = min(tiles, warp * per), t1 = min(tiles, t0 + per);
  unsigned own = 0;
  if (b < buckets) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) own += counts[static_cast<size_t>(t) * buckets + b];
  }
  part[warp][lane] = own;
  __syncthreads();
  unsigned run = 0;
  for (int w = 0; w < warp; ++w) run += part[w][lane];
  if (b >= buckets) return;
  for (int t = t0; t < t1; t += 8) {
    unsigned c[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      c[u] = t + u < t1 ? counts[static_cast<size_t>(t + u) * buckets + b] : 0u;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (t + u < t1) {
        counts[static_cast<size_t>(t + u) * buckets + b] = run;
        run += c[u];
      }
    }
  }
  if (warp == HS_SCAN_WARPS - 1) totals[b] = run;
}

// 2b. One block: the buckets' totals → their exclusive starts, starts[buckets]
// the number of pairs in range; starts[buckets + 1] and [buckets + 2], the
// sum's and sum_big's queues, and sum_big's done flags zeroed.
__global__ void __launch_bounds__(HS_SCAN_THREADS)
hash_scatter_scan_buckets(const unsigned* __restrict__ totals, int buckets,
                          unsigned* __restrict__ starts, unsigned* __restrict__ done) {
  for (int b = threadIdx.x; b < buckets; b += HS_SCAN_THREADS) done[b] = 0u;
  __shared__ unsigned warp_sum[HS_SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (buckets + HS_SCAN_THREADS - 1) / HS_SCAN_THREADS;
  const int b0 = min(buckets, static_cast<int>(threadIdx.x) * per);
  const int b1 = min(buckets, b0 + per);
  unsigned own = 0;
  for (int b = b0; b < b1; ++b) own += totals[b];
  unsigned x = own;   // inclusive over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  unsigned run = x - own + (warp ? warp_sum[warp - 1] : 0u);
  for (int b = b0; b < b1; ++b) {
    starts[b] = run;
    run += totals[b];
  }
  if (threadIdx.x == HS_SCAN_THREADS - 1) {
    starts[buckets] = run;
    starts[buckets + 1] = 0u;   // the sum's bucket queue
    starts[buckets + 2] = 0u;   // sum_big's
  }
}

// 3. One warp a tile: its pairs in the window into their buckets' regions,
// in flat order within each bucket. A stage of HS_UNROLL groups is loaded
// while the one before is placed. (row0 is a multiple of 2^s, so a row's
// place in its bucket is that of its key.)
template <int VF>
__global__ void __launch_bounds__(32)
hash_scatter_partition(const int* __restrict__ keys, const float* __restrict__ vals,
                       long long n, int s, long long row0, long long rows, int buckets,
                       int tile,
                       const unsigned* __restrict__ offsets,
                       const unsigned* __restrict__ starts,
                       typename Rec<VF>::T* __restrict__ recs) {
  using R = typename Rec<VF>::T;
  extern __shared__ unsigned dest[];
  const int lane = threadIdx.x;
  const unsigned* off = offsets + static_cast<size_t>(blockIdx.x) * buckets;
  for (int b = lane; b < buckets; b += 32) dest[b] = __ldg(starts + b) + __ldg(off + b);
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  const long long lo = static_cast<long long>(blockIdx.x) * tile;
  const long long hi = min(n, lo + tile);
  int k[HS_UNROLL], kn[HS_UNROLL];
  R v[HS_UNROLL], vn[HS_UNROLL];
#pragma unroll
  for (int u = 0; u < HS_UNROLL; ++u) {
    const long long p = lo + u * 32 + lane;
    k[u] = p < hi ? __ldg(keys + p) : -1;
    v[u] = p < hi ? load_rec<VF>(vals, p, place_of(k[u], s)) : R{};
  }
  for (long long g = lo; g < hi; g += 32 * HS_UNROLL) {
    const long long gn = g + 32 * HS_UNROLL;
#pragma unroll
    for (int u = 0; u < HS_UNROLL; ++u) {
      const long long p = gn + u * 32 + lane;
      kn[u] = p < hi ? __ldg(keys + p) : -1;
      vn[u] = p < hi ? load_rec<VF>(vals, p, place_of(kn[u], s)) : R{};
    }
#pragma unroll
    for (int u = 0; u < HS_UNROLL; ++u) {
      const bool valid = in_window(k[u], row0, rows);
      const unsigned b = valid ? bucket_of(k[u] - row0, s) : NO_ROW;
      const unsigned peers = peers16(b);
      const int leader = __ffs(peers) - 1;
      unsigned base = 0;
      if (valid && leader == lane) {
        base = dest[b];
        dest[b] = base + __popc(peers);
      }
      base = __shfl_sync(FULL, base, leader);
      if (valid) recs[base + __popc(peers & below)] = v[u];
      __syncwarp();
    }
#pragma unroll
    for (int u = 0; u < HS_UNROLL; ++u) {
      k[u] = kn[u];
      v[u] = vn[u];
    }
  }
}

// The lanes whose key (below 2^bits, 0 where valid is false) equals this
// lane's, among the lanes where `valid` holds: one ballot a bit.
__device__ __forceinline__ unsigned peers_of(unsigned key, bool valid, int bits) {
  const unsigned in = __ballot_sync(FULL, valid);
  unsigned peers = valid ? in : ~in;
  for (int i = 0; i < bits; ++i) {
    const bool bit = (key >> i) & 1u;
    const unsigned on = __ballot_sync(FULL, bit);
    peers &= bit ? on : ~on;
  }
  return peers;
}

// 4, F = VF (1 or 2), a group with a repeated row: the lanes park their
// values in `slot`; the lowest lane of each row loads all 32 and adds its
// row's lanes in lane order onto the row's running sum.
template <int VF>
__device__ __forceinline__ void ordered_group(unsigned row, bool valid, float v0, float v1,
                                              int s, float* acc, float* slot) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = peers_of(row, valid, s);
  slot[lane * VF] = v0;
  if constexpr (VF == 2) slot[lane * VF + 1] = v1;
  __syncwarp();
  if (valid && (peers & ((1u << lane) - 1u)) == 0) {
    float4 q[8 * VF];
#pragma unroll
    for (int i = 0; i < 8 * VF; ++i) q[i] = reinterpret_cast<const float4*>(slot)[i];
    const float* x = reinterpret_cast<const float*>(q);
    float a0 = acc[row * VF], a1 = VF == 2 ? acc[row * VF + 1] : 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if ((peers >> j) & 1u) {
        a0 += x[j * VF];
        if constexpr (VF == 2) a1 += x[j * VF + 1];
      }
    }
    acc[row * VF] = a0;
    if constexpr (VF == 2) acc[row * VF + 1] = a1;
  }
}

template <int VF> struct Sums { float a[VF]; };

// 4, F = VF (1 or 2), a stage by owners: lane k adds, in flat order, the
// values of the stage's m pairs of its row `mine` onto c (its row's running
// sum), and +0.0 for the other pairs. A running row sum is never -0.0 (it
// starts at +0.0, and a sum in round to nearest is -0.0 only when both
// terms are), so the +0.0 leave its bits as they are, and the select keeps
// a branch off the chain of dependent adds. 16 records are loaded before
// their 16 adds (the empty asm keeps them ahead).
template <int VF>
__device__ __forceinline__ Sums<VF> walk_stage(const typename Rec<VF>::T* stage, int m,
                                               unsigned mine, Sums<VF> c) {
  using R = typename Rec<VF>::T;
  for (int j = 0; j < m; j += 16) {   // the stage holds 32 x HS_UNROLL records
    R q[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) q[k] = stage[j + k];
    asm volatile("" ::: "memory");
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const bool take = q[k].x == mine;
#pragma unroll
      for (int f = 0; f < VF; ++f) c.a[f] += take ? rec_value(q[k], f) : 0.0f;
    }
  }
  return c;
}

// v[u].x for a u known only at run time, without moving v to local memory
template <typename R>
__device__ __forceinline__ unsigned stage_row(const R (&v)[HS_UNROLL], int u) {
  unsigned r = NO_ROW;
#pragma unroll
  for (int k = 0; k < HS_UNROLL; ++k) r = k == u ? v[k].x : r;
  return r;
}

// 4, F = VF (1 or 2): a bucket's region by groups of 32 pairs, a stage of
// HS_UNROLL groups loaded while the one before is added.
// * A stage of at most 32 distinct rows (hot rows: clamped samples, the
//   coarse levels; a clamped cell's corners x and x + 1 share a bucket,
//   the x prime being 1) goes by owners: lane k owns the k-th row seen
//   (`owner` maps a row to k + 1, `list` k to the row) and keeps its
//   running sum in registers from stage to stage; the stage's records are
//   parked in `stage` and each owner walks them (walk_stage). The rows of a
//   bucket thus share one walk, one dependent add a pair.
// * Any other stage goes group by group, the owners' sums given back
//   first: a group whose rows are all distinct (each lane writes its lane
//   into its row's tag and reads it back) adds lane by lane; one with a
//   repeated row takes ordered_group.
template <int VF>
__device__ __forceinline__ void sum_values(const typename Rec<VF>::T* __restrict__ recs,
                                           unsigned lo, unsigned hi, int s, float* acc,
                                           float* slot, unsigned char* tag,
                                           unsigned char* owner, unsigned* list,
                                           typename Rec<VF>::T* stage) {
  using R = typename Rec<VF>::T;
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  int n_own = 0;               // rows owned (the same on every lane)
  unsigned mine = NO_ROW;      // this lane's row, and its running sum
  Sums<VF> c = {};
  R v[HS_UNROLL], vn[HS_UNROLL];
#pragma unroll
  for (int u = 0; u < HS_UNROLL; ++u) {
    const unsigned p = lo + u * 32 + lane;
    v[u] = p < hi ? __ldg(recs + p) : R{};
    if (p >= hi) v[u].x = NO_ROW;
  }
  for (unsigned g = lo; g < hi; g += 32 * HS_UNROLL) {
    const unsigned gn = g + 32 * HS_UNROLL;
#pragma unroll
    for (int u = 0; u < HS_UNROLL; ++u) {
      const unsigned p = gn + u * 32 + lane;
      vn[u] = p < hi ? __ldg(recs + p) : R{};
      if (p >= hi) vn[u].x = NO_ROW;
    }
    bool by_owners = n_own > 0;
    if (!by_owners) {            // a hot stage shows in its first group
      const unsigned p0 = peers16(v[0].x);
      by_owners = __popc(__ballot_sync(FULL, v[0].x != NO_ROW && (p0 & below) == 0)) <= 16;
    }
    if (by_owners) {             // own the stage's new rows, up to 32
      const int before = n_own;
      bool fresh_any = false;
#pragma unroll
      for (int u = 0; u < HS_UNROLL; ++u)
        fresh_any |= v[u].x != NO_ROW && owner[v[u].x] == 0;
      const int claim = __any_sync(FULL, fresh_any) ? HS_UNROLL : 0;
#pragma unroll 1
      for (int u = 0; u < claim; ++u) {
        const unsigned r = stage_row(v, u);
        const bool fresh = r != NO_ROW && owner[r] == 0;
        if (n_own <= 32 && __any_sync(FULL, fresh)) {
          const unsigned peers = peers16(fresh ? r : NO_ROW);
          const unsigned fb = __ballot_sync(FULL, fresh && (peers & below) == 0);
          const int k = n_own + __popc(fb & below);
          if (((fb >> lane) & 1u) && k < 32) {
            owner[r] = static_cast<unsigned char>(k + 1);
            list[k] = r;
          }
          n_own += __popc(fb);
          __syncwarp();
        }
      }
      if (n_own <= 32) {
        if (lane >= before && lane < n_own) {
          mine = list[lane];
#pragma unroll
          for (int f = 0; f < VF; ++f) c.a[f] = acc[mine * VF + f];
        }
#pragma unroll
        for (int u = 0; u < HS_UNROLL; ++u) stage[u * 32 + lane] = v[u];
        __syncwarp();
        c = walk_stage<VF>(stage, static_cast<int>(min(32u * HS_UNROLL, hi - g)), mine, c);
        __syncwarp();
#pragma unroll
        for (int u = 0; u < HS_UNROLL; ++u) v[u] = vn[u];
        continue;
      }
      // too many rows: the owners give their sums back, the table is cleared
      if (lane < before) {
#pragma unroll
        for (int f = 0; f < VF; ++f) acc[mine * VF + f] = c.a[f];
      }
      if (lane < n_own) owner[list[lane]] = 0;
      n_own = 0;
      mine = NO_ROW;
      __syncwarp();
    }
#pragma unroll
    for (int u = 0; u < HS_UNROLL; ++u) {
      if (g + u * 32 >= hi) break;   // the same for every lane
      const bool valid = v[u].x != NO_ROW;
      const unsigned row = valid ? v[u].x : 0u;
      if (valid) tag[row] = static_cast<unsigned char>(lane);
      __syncwarp();
      const bool clash = valid && tag[row] != lane;
      if (!__any_sync(FULL, clash)) {
        if (valid) {
#pragma unroll
          for (int f = 0; f < VF; ++f) acc[row * VF + f] += rec_value(v[u], f);
        }
      } else {
        ordered_group<VF>(row, valid, rec_value(v[u], 0), rec_value(v[u], VF - 1), s, acc,
                          slot);
      }
      __syncwarp();
    }
#pragma unroll
    for (int u = 0; u < HS_UNROLL; ++u) v[u] = vn[u];
  }
  if (lane < n_own) {
#pragma unroll
    for (int f = 0; f < VF; ++f) acc[mine * VF + f] = c.a[f];
    owner[mine] = 0;
  }
  __syncwarp();
}

// 4, F > HS_SMALL_F: pair by pair in order, lane f (mod 32) adding feature f,
// each group's 32 pairs of a 32-feature slice loaded before they are added.
// (Inlined beside sum_rows_small, it made ptxas spill the kernel.)
__device__ __noinline__ void sum_rows_any(const uint2* __restrict__ recs,
                                             const float* __restrict__ vals, int F,
                                             unsigned lo, unsigned hi, float* acc) {
  const int lane = threadIdx.x;
  for (unsigned g = lo; g < hi; g += 32) {
    const unsigned p = g + lane;
    const uint2 rq = p < hi ? __ldg(recs + p) : make_uint2(0u, 0u);
    const int m = static_cast<int>(min(32u, hi - g));
    for (int f0 = 0; f0 < F; f0 += 32) {
      const int f = f0 + lane;
      float x[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const unsigned qj = __shfl_sync(FULL, rq.y, j);
        x[j] = j < m && f < F ? __ldg(vals + static_cast<long long>(qj) * F + f) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const unsigned rj = __shfl_sync(FULL, rq.x, j);
        if (j < m && f < F) acc[rj * F + f] += x[j];
      }
    }
  }
}

// 4, 2 < F <= HS_SMALL_F: as for F <= 2, a lane a pair, 32 pairs at a
// time, a stage of HS_UNROLL groups' records and their values (loaded by
// flat index) loaded before the stage is added: a group whose rows are all
// distinct (tags, as in sum_values) adds lane by lane; in one with a
// repeated row the lanes park their values in `slot` and the lowest lane of
// each row adds its row's lanes' values in lane order.
__device__ __forceinline__ void sum_rows_small(const uint2* __restrict__ recs,
                                               const float* __restrict__ vals, int F,
                                               unsigned lo, unsigned hi, int s, float* acc,
                                               float* slot, unsigned char* tag) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  for (unsigned g0 = lo; g0 < hi; g0 += 32 * HS_UNROLL) {
    uint2 rq[HS_UNROLL];
    float x[HS_UNROLL][HS_SMALL_F];
#pragma unroll
    for (int u = 0; u < HS_UNROLL; ++u) {
      const unsigned p = g0 + u * 32 + lane;
      rq[u] = p < hi ? __ldg(recs + p) : make_uint2(NO_ROW, 0u);
    }
#pragma unroll
    for (int u = 0; u < HS_UNROLL; ++u) {
      const float* src = vals + static_cast<long long>(rq[u].y) * F;
#pragma unroll
      for (int f = 0; f < HS_SMALL_F; ++f)
        x[u][f] = rq[u].x != NO_ROW && f < F ? __ldg(src + f) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < HS_UNROLL; ++u) {
      if (g0 + u * 32 >= hi) break;   // the same for every lane
      const bool valid = rq[u].x != NO_ROW;
      const unsigned row = valid ? rq[u].x : 0u;
      if (valid) tag[row] = static_cast<unsigned char>(lane);
      __syncwarp();
      const bool clash = valid && tag[row] != lane;
      if (!__any_sync(FULL, clash)) {
        if (valid) {
#pragma unroll
          for (int f = 0; f < HS_SMALL_F; ++f)
            if (f < F) acc[row * F + f] += x[u][f];
        }
      } else {
        const unsigned peers = peers_of(row, valid, s);
#pragma unroll
        for (int f = 0; f < HS_SMALL_F; ++f) slot[lane * HS_SMALL_F + f] = x[u][f];
        __syncwarp();
        if (valid && (peers & below) == 0) {
          float a[HS_SMALL_F];
#pragma unroll
          for (int f = 0; f < HS_SMALL_F; ++f) a[f] = f < F ? acc[row * F + f] : 0.0f;
          for (unsigned m = peers; m; m &= m - 1u) {   // the row's lanes, in order
            const float* y = slot + (__ffs(m) - 1) * HS_SMALL_F;
#pragma unroll
            for (int f = 0; f < HS_SMALL_F; ++f) a[f] += y[f];
          }
#pragma unroll
          for (int f = 0; f < HS_SMALL_F; ++f)
            if (f < F) acc[row * F + f] = a[f];
        }
      }
      __syncwarp();
    }
  }
}

// The sum's slots: floats a group parks for its repeated rows.
__host__ __device__ constexpr int sum_slots(int vf) { return 32 * (vf ? vf : HS_SMALL_F); }

// 4. Warps that take buckets from a queue (`next`, zeroed by scan_buckets),
// so that the buckets' unequal sizes spread over the card: a bucket's sums
// from 0.0f, then all its rows written.
template <int VF>
__global__ void __launch_bounds__(32)
hash_scatter_sum(const typename Rec<VF>::T* __restrict__ recs,
                 const float* __restrict__ vals, int F,
                 const unsigned* __restrict__ starts, int s, long long n_rows, int buckets,
                 unsigned* __restrict__ next, const unsigned* __restrict__ done,
                 float* __restrict__ out) {
  // the bucket's sums, then (F <= 2) a stage of records, the slots (32 x
  // F floats, 32 x HS_SMALL_F for a wider row), (F <= 2) the owners' rows,
  // and two bytes a row: (F <= 2) the owner table (zeroed once) and the tags
  extern __shared__ float acc[];
  const int lane = threadIdx.x;
  const int W = VF ? VF : F;
  const int n_acc = (1 << s) * W;
  auto* stage = reinterpret_cast<typename Rec<VF>::T*>(acc + n_acc);
  float* slot = reinterpret_cast<float*>(stage + (VF ? 32 * HS_UNROLL : 0));
  auto* list = reinterpret_cast<unsigned*>(slot + sum_slots(VF));
  auto* owner = reinterpret_cast<unsigned char*>(list + (VF ? 32 : 0));
  unsigned char* tag = owner + (1 << s);
  if constexpr (VF != 0) {
    for (int i = lane; i < (1 << s); i += 32) owner[i] = 0;
  }
  for (;;) {
    unsigned b = 0;
    if (lane == 0) b = atomicAdd(next, 1u);
    b = __shfl_sync(FULL, b, 0);
    if (b >= static_cast<unsigned>(buckets)) return;
    if (done[b]) continue;       // sum_big wrote it
    for (int i = lane; i < n_acc; i += 32) acc[i] = 0.0f;
    __syncwarp();
    const unsigned lo = __ldg(starts + b), hi = __ldg(starts + b + 1);
    if constexpr (VF == 0) {
      if (F <= HS_SMALL_F) {
        sum_rows_small(recs, vals, F, lo, hi, s, acc, slot, tag);
      } else {
        sum_rows_any(recs, vals, F, lo, hi, acc);
      }
    } else {
      sum_values<VF>(recs, lo, hi, s, acc, slot, tag, owner, list, stage);
    }
    __syncwarp();
    const long long r0 = static_cast<long long>(b) << s;
    const long long m = min(static_cast<long long>(1 << s), n_rows - r0) * W;
    float* o = out + r0 * W;
    for (long long i = lane; i < m; i += 32) o[i] = acc[i];
    __syncwarp();
  }
}

// 4b. sum_big, before the sum: blocks take buckets from a queue and keep
// those of more than HS_BIG pairs. One of at most HS_BIG_ROWS distinct rows (hot rows:
// clamped samples; a clamped cell's corners x and x + 1 share a bucket, the
// hash's x prime being 1) is split by row across the block: the warps claim
// its rows (owner: 0 none, k + 1 row k, FULL while claiming), count their
// chunk's pairs per row, and place each pair's values in its row's list in
// flat order (ballots rank a group's lanes of one row); then each row's list
// is summed in order from 0.0f by one warp, the bucket's rows are written,
// zeros included, and done[b] set. Where one warp walked both of two hot
// rows pair by pair, each row is now a warp's chain of adds alone. A bucket
// of more rows is left to the sum.
template <int VF>
__global__ void __launch_bounds__(HS_BIG_WARPS * 32, 1)   // (F = 1 spilled at 64 registers)
hash_scatter_sum_big(const typename Rec<VF>::T* __restrict__ recs,
                     const unsigned* __restrict__ starts, int s, long long n_rows,
                     int buckets, unsigned* __restrict__ next, float* __restrict__ lists,
                     unsigned* __restrict__ done, float* __restrict__ out) {
  using R = typename Rec<VF>::T;
  constexpr int STAGE = (HS_BIG_BATCH + 16) * VF;   // floats a warp stages
  extern __shared__ unsigned big[];
  unsigned* owner = big;                           // 2^s
  unsigned* rows = owner + (1 << s);               // HS_BIG_ROWS
  unsigned* place = rows + HS_BIG_ROWS;            // [warp][row]: counts, then places
  unsigned* total = place + HS_BIG_WARPS * HS_BIG_ROWS;
  unsigned* first = total + HS_BIG_ROWS;
  unsigned* n_rows_owned = first + HS_BIG_ROWS;
  unsigned* taken = n_rows_owned + 1;
  float* stage = reinterpret_cast<float*>(n_rows_owned + 4);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int i = t; i < (1 << s); i += blockDim.x) owner[i] = 0u;
  for (;;) {   // buckets from a queue (zeroed by scan_buckets): big ones spread
    __syncthreads();
    if (t == 0) *taken = atomicAdd(next, 1u);
    __syncthreads();
    const unsigned b = *taken;
    if (b >= static_cast<unsigned>(buckets)) return;
    const unsigned lo = __ldg(starts + b), hi = __ldg(starts + b + 1);
    if (hi - lo <= HS_BIG) continue;               // the same for the whole block
    if (t == 0) *n_rows_owned = 0u;
    for (int i = t; i < HS_BIG_WARPS * HS_BIG_ROWS; i += blockDim.x) place[i] = 0u;
    __syncthreads();
    for (unsigned p0 = lo + t; p0 < hi; p0 += blockDim.x * 8) {   // claim the rows
      unsigned r[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const unsigned p = p0 + u * blockDim.x;
        r[u] = p < hi ? __ldg(reinterpret_cast<const unsigned*>(recs + p)) : NO_ROW;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (r[u] != NO_ROW && owner[r[u]] == 0u && atomicCAS(owner + r[u], 0u, FULL) == 0u) {
          const unsigned k = atomicAdd(n_rows_owned, 1u);
          if (k < HS_BIG_ROWS) {
            rows[k] = r[u];
            atomicExch(owner + r[u], k + 1u);
          }
        }
      }
      if (*reinterpret_cast<volatile unsigned*>(n_rows_owned) > HS_BIG_ROWS) break;
    }
    __syncthreads();
    const unsigned n_own = *n_rows_owned;
    if (n_own <= HS_BIG_ROWS) {
      const unsigned size = hi - lo;
      const unsigned chunk = (size + HS_BIG_WARPS * 32 - 1) / (HS_BIG_WARPS * 32) * 32;
      const unsigned c_lo = lo + min(size, warp * chunk);
      const unsigned c_hi = lo + min(size, (warp + 1) * chunk);
      for (unsigned p0 = c_lo + lane; p0 < c_hi; p0 += 32 * 8) {   // count per warp and row
        unsigned r[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const unsigned p = p0 + u * 32;
          r[u] = p < c_hi ? __ldg(reinterpret_cast<const unsigned*>(recs + p)) : NO_ROW;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (r[u] != NO_ROW) atomicAdd(place + warp * HS_BIG_ROWS + owner[r[u]] - 1u, 1u);
      }
      __syncthreads();
      if (warp == 0) {   // each row's list at lists[lo + first, ...), each warp's part in it
        unsigned tot = 0;
        if (lane < HS_BIG_ROWS) {
          for (int w = 0; w < HS_BIG_WARPS; ++w) tot += place[w * HS_BIG_ROWS + lane];
        }
        unsigned x = tot;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned y = __shfl_up_sync(FULL, x, d);
          if (lane >= d) x += y;
        }
        if (lane < HS_BIG_ROWS) {
          total[lane] = tot;
          first[lane] = x - tot;
          unsigned run = x - tot;
          for (int w = 0; w < HS_BIG_WARPS; ++w) {
            const unsigned c = place[w * HS_BIG_ROWS + lane];
            place[w * HS_BIG_ROWS + lane] = run;
            run += c;
          }
        }
      }
      __syncthreads();
      for (unsigned g0 = c_lo; g0 < c_hi; g0 += 32 * 8) {   // each pair's values onto its row's list
        R rec[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const unsigned p = g0 + u * 32 + lane;
          rec[u] = p < c_hi ? __ldg(recs + p) : R{};
          if (p >= c_hi) rec[u].x = NO_ROW;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const bool valid = rec[u].x != NO_ROW;
          const unsigned k = valid ? owner[rec[u].x] - 1u : NO_ROW;
          const unsigned peers = peers16(k);
          const unsigned at = valid ? place[warp * HS_BIG_ROWS + k] : 0u;
          if (valid) {
            const unsigned q = lo + at + __popc(peers & below);
#pragma unroll
            for (int f = 0; f < VF; ++f)
              lists[static_cast<size_t>(q) * VF + f] = rec_value(rec[u], f);
          }
          __syncwarp();
          if (valid && (peers & below) == 0) place[warp * HS_BIG_ROWS + k] = at + __popc(peers);
          __syncwarp();
        }
      }
      const long long r0 = static_cast<long long>(b) << s;
      const long long m = min(static_cast<long long>(1 << s), n_rows - r0) * VF;
      for (long long i = t; i < m; i += blockDim.x) out[r0 * VF + i] = 0.0f;
      __syncthreads();
      // each row's list summed in order by one warp: staged 512 pairs at a
      // time, 16 loaded from the stage before their 16 adds. The sum starts at +0.0 and so
      // is never -0.0 (in round to nearest a sum is -0.0 only when both
      // terms are): the +0.0 added past the list's end keep its bits.
      // The next batch loads into registers while this one is added.
      constexpr int PER_LANE = HS_BIG_BATCH * VF / 32;
      float* st = stage + warp * STAGE;
      for (unsigned k = warp; k < n_own; k += HS_BIG_WARPS) {
        const unsigned n_k = total[k];
        const float* src = lists + static_cast<size_t>(lo + first[k]) * VF;
        float a[VF] = {};
        float nx[PER_LANE];
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i) {
          const unsigned e = i * 32 + lane;
          nx[i] = e < n_k * VF ? src[e] : 0.0f;
        }
        for (unsigned j0 = 0; j0 < n_k; j0 += HS_BIG_BATCH) {
          const int mk = static_cast<int>(min(static_cast<unsigned>(HS_BIG_BATCH), n_k - j0));
#pragma unroll
          for (int i = 0; i < PER_LANE; ++i) st[i * 32 + lane] = nx[i];
          __syncwarp();
#pragma unroll
          for (int i = 0; i < PER_LANE; ++i) {
            const unsigned e = (j0 + HS_BIG_BATCH) * VF + i * 32 + lane;
            nx[i] = e < n_k * VF ? src[e] : 0.0f;
          }
          for (int j = 0; j < mk; j += 16) {
            float4 x4[4 * VF];   // 16 pairs' values, in order
#pragma unroll
            for (int q = 0; q < 4 * VF; ++q)
              x4[q] = reinterpret_cast<const float4*>(st + j * VF)[q];
            asm volatile("" ::: "memory");
            const float* x = reinterpret_cast<const float*>(x4);
            if (j + 16 <= mk) {
#pragma unroll
              for (int q = 0; q < 16; ++q) {
#pragma unroll
                for (int f = 0; f < VF; ++f) a[f] += x[q * VF + f];
              }
            } else {
#pragma unroll
              for (int q = 0; q < 16; ++q) {
#pragma unroll
                for (int f = 0; f < VF; ++f) a[f] += j + q < mk ? x[q * VF + f] : 0.0f;
              }
            }
          }
          __syncwarp();
        }
        if (lane == 0) {
#pragma unroll
          for (int f = 0; f < VF; ++f) out[(r0 + rows[k]) * VF + f] = a[f];
        }
      }
      if (t == 0) done[b] = 1u;
    }
    __syncthreads();
    for (int i = t; i < (1 << s); i += blockDim.x) owner[i] = 0u;
  }
}

// One pass: the six kernels on the window of `rows` rows from row0 (out
// offset to its first row).
template <int VF>
int run_window(const int* keys, const float* vals, long long n, int F, long long row0,
               long long rows, int s, int tile, int tiles, unsigned* counts,
               unsigned* totals, unsigned* starts, typename Rec<VF>::T* recs, unsigned* done,
               float* lists, float* out, int sum_bytes, int big_bytes, cudaStream_t stream) {
  const int buckets = static_cast<int>(buckets_of(rows, s));
  const size_t dest_bytes = static_cast<size_t>(buckets) * sizeof(unsigned);
  cudaError_t e;
  if (tiles > 0) {
    hash_scatter_count<<<tiles, HS_COUNT_THREADS, dest_bytes, stream>>>(
        keys, n, s, row0, rows, buckets, tile, counts);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  hash_scatter_scan_tiles<<<(buckets + 31) / 32, HS_SCAN_WARPS * 32, 0, stream>>>(
      counts, tiles, buckets, totals);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  hash_scatter_scan_buckets<<<1, HS_SCAN_THREADS, 0, stream>>>(totals, buckets, starts,
                                                               done);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (tiles > 0) {
    hash_scatter_partition<VF><<<tiles, 32, dest_bytes, stream>>>(
        keys, vals, n, s, row0, rows, buckets, tile, counts, starts, recs);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  float* o = out + row0 * (VF ? VF : F);
  if constexpr (VF != 0) {
    hash_scatter_sum_big<VF><<<HS_BIG_BLOCKS, HS_BIG_WARPS * 32, big_bytes, stream>>>(
        recs, starts, s, rows, buckets, starts + buckets + 2, lists, done, o);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  hash_scatter_sum<VF><<<min(buckets, HS_SUM_WARPS), 32, sum_bytes, stream>>>(
      recs, vals, F, starts, s, rows, buckets, starts + buckets + 1, done, o);
  return static_cast<int>(cudaGetLastError());
}

template <int VF>
int run(const int* keys, const float* vals, long long n, int F, long long n_rows, int s,
        long long window, int tile, unsigned* counts, unsigned* totals, unsigned* starts,
        void* recs, unsigned* done, float* lists, float* out, cudaStream_t stream) {
  using R = typename Rec<VF>::T;
  const long long tiles_ll = (n + tile - 1) / tile;
  if (tiles_ll > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int sum_bytes =
      ((1 << s) * (VF ? VF : F) + sum_slots(VF) + (VF ? 32 : 0)) *
          static_cast<int>(sizeof(float)) +
      (VF ? 32 * HS_UNROLL * static_cast<int>(sizeof(R)) : 0) + 2 * (1 << s);
  if (sum_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hash_scatter_sum<VF>, cudaFuncAttributeMaxDynamicSharedMemorySize, sum_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int big_bytes = ((1 << s) + (HS_BIG_WARPS + 3) * HS_BIG_ROWS + 4 +
                         HS_BIG_WARPS * (HS_BIG_BATCH + 16) * VF) *
                        static_cast<int>(sizeof(unsigned));
  if constexpr (VF != 0) {
    if (big_bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          hash_scatter_sum_big<VF>, cudaFuncAttributeMaxDynamicSharedMemorySize, big_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  for (long long row0 = 0; row0 < n_rows; row0 += window) {
    const int err = run_window<VF>(keys, vals, n, F, row0,
                                   n_rows - row0 < window ? n_rows - row0 : window, s,
                                   tile, static_cast<int>(tiles_ll), counts, totals, starts,
                                   static_cast<R*>(recs), done, lists, out, sum_bytes,
                                   big_bytes, stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// keys (n,) int32, vals (n, F) fp32 row-major, out (n_rows, F) fp32 (every
// row written); 1 <= F <= 4096. The plan (ops/hash_scatter.py:scatter_plan):
// buckets of 2^s rows, windows of `window` rows (a multiple of 2^s; one
// pass of the kernels each), tiles of `tile` pairs (a multiple of 32), and
// the scratch, one pass's: counts (tiles x a window's buckets), totals
// (buckets), starts (buckets + 3) uint32, a record a pair, done flags
// (buckets) and, for F <= 2, sum_big's lists (n x F fp32) (16 bytes for F =
// 2, else 8). Keys outside [0, n_rows) are skipped (no write out of bounds;
// nothing reports them). Returns a cudaError_t.
extern "C" int nerf_hash_scatter(const int* keys, const float* vals, long long n, int F,
                                 long long n_rows, int s, long long window, int tile,
                                 void* counts, void* totals, void* starts, void* recs,
                                 void* done, void* lists, float* out, cudaStream_t stream) {
  if (n_rows <= 0) return 0;
  if (F <= 0 || F > 4096 || s < 0 || s > HS_MAX_SHIFT || tile <= 0 || tile % 32 != 0 ||
      n < 0 || n > 0x7fffffffLL || window <= 0 || (window < n_rows && window % (1LL << s)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (buckets_of(window, s) > 12288 ||   // a warp's destinations in 48 KB
      (1LL << s) * F * static_cast<long long>(sizeof(float)) > HS_MAX_SUM_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* c = static_cast<unsigned*>(counts);
  auto* t = static_cast<unsigned*>(totals);
  auto* st = static_cast<unsigned*>(starts);
  auto* dn = static_cast<unsigned*>(done);
  auto* ls = static_cast<float*>(lists);
  if (F == 1) return run<1>(keys, vals, n, F, n_rows, s, window, tile, c, t, st, recs, dn, ls,
                             out, stream);
  if (F == 2) return run<2>(keys, vals, n, F, n_rows, s, window, tile, c, t, st, recs, dn, ls,
                             out, stream);
  return run<0>(keys, vals, n, F, n_rows, s, window, tile, c, t, st, recs, dn, ls, out,
                stream);
}
