// K3 on its own: the k-planes encode of the fused ray-march (the __device__
// function of kplanes_encode.cuh) over Q points, rows written to device
// memory as (Q, EP) bf16.
//
// Replaces the TPU kernel's k-planes branch,
// nerf_sandbox_tpu/ops/fused_raymarch.py:_kp_encode_body (inside the
// pl.pallas_call at :667), so that the encode can be held against its plain
// version alone and feed the K1 MLP (models/forward.py, use_kernel=True).
// Bound on the H100: the EP*2 bytes written per row (256 B at full width)
// against 12 B read and ~1.5 kFLOP, so HBM writes set the bound; the 576 B
// of table texels a row come from L2 and L1.
// Design: a persistent grid (the SM count x the blocks the occupancy API
// fits) of 128-thread blocks walking tiles of KP_ROWS = 64 rows. Per tile the
// block keeps its points' x01 in shared memory (the coordinates were loaded,
// coalesced, while the last tile ran), runs K3's work list into a row-major
// staging tile (rows at EP + 8 columns, so that a quarter warp's 16-byte
// stores fall on distinct banks), then sends whole rows out: the staged
// columns and the zero padding from the first 8-aligned column past the row
// (not staged: 16-byte stores of zeros from registers) in one pass of
// 16-byte stores, neighbouring threads on neighbouring addresses, so that
// each line of the output is written at once. Zeros written at the start of
// a tile, the rest of their line at its end, cost 0.2 ms of 0.66 at full
// width; cp.async.bulk copies of the staged rows, 0.07 ms more than these
// stores (probe_kplanes_encode.py). One instantiation per group width (8-
// feature planes and lines, 4-feature planes, any), so that each holds one
// width's code: the 4-feature one fits 64 registers and 8 blocks an SM.
#include <map>
#include <mutex>
#include <tuple>

#include "kplanes_encode.cuh"

using namespace nerf;

constexpr int KP_THREADS = 128;
constexpr int KP_ROW_PAD = 8;      // bf16 pad per staged row (16 B)

// Steps i = i0, i0 + step, ... over units of width `units` as (row, unit)
// pairs without a division per step.
struct UnitWalk {
  int q, u, dq, du, units;
  __device__ UnitWalk(int i0, int step, int units_)
      : q(i0 / units_), u(i0 % units_), dq(step / units_), du(step % units_),
        units(units_) {}
  __device__ void next() {
    q += dq;
    u += du;
    if (u >= units) {
      u -= units;
      ++q;
    }
  }
};

// This thread's share of tile `tile`'s KP_ROWS x 3 point coordinates:
// elements tid and tid + KP_THREADS (0 past the points or past the tile).
__device__ __forceinline__ void load_points(const float* __restrict__ pts, int Q,
                                            int tile, int tid, float (&v)[2]) {
  const size_t base = size_t(tile) * KP_ROWS * 3, end = size_t(Q) * 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = tid + e * KP_THREADS;
    v[e] = i < KP_ROWS * 3 && base + i < end ? __ldg(pts + base + i) : 0.0f;
  }
}

// VF, VL: the plane and line group widths (kplanes_encode_rows), 0 for any.
// Registers held to 72, 7 blocks an SM: left to itself ptxas gives the
// 8-feature instantiation 64 and spills 8 bytes; the 4-feature one takes 64
// within the bound, so 8 blocks fit.
template <int VF, int VL>
__global__ void __launch_bounds__(KP_THREADS, 7)
kplanes_encode_kernel(const float* __restrict__ pts, int Q,
                      const __grid_constant__ KpArgs k,
                      int EP, bf16* __restrict__ out) {
  static_assert(2 * KP_THREADS >= KP_ROWS * 3, "two coordinates a thread");
  extern __shared__ __align__(128) unsigned char smem[];
  float* x01 = reinterpret_cast<float*>(smem);                          // (64, 3)
  bf16* rows = reinterpret_cast<bf16*>(smem + KP_ROWS * 3 * sizeof(float));
  const int lde = EP + KP_ROW_PAD, tid = threadIdx.x;
  const int staged = k.c_zero >> 3;     // 16-byte units of a row from rows
  const int n_tiles = (Q + KP_ROWS - 1) / KP_ROWS;
  const UnitWalk row_walk(tid, KP_THREADS, EP >> 3);
  float pv[2];
  load_points(pts, Q, blockIdx.x, tid, pv);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * KP_ROWS, n = min(KP_ROWS, Q - row0);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (tid + e * KP_THREADS < KP_ROWS * 3) x01[tid + e * KP_THREADS] = kp_unit(pv[e], k.box);
    __syncthreads();   // x01 in place; the last tile's rows have left
    load_points(pts, Q, tile + gridDim.x, tid, pv);   // in flight during the tasks
    kplanes_encode_rows<VF, VL>(k, x01, n, tid, KP_THREADS, RowMajorRows{rows, lde});
    __syncthreads();   // the tile's rows are staged
    for (UnitWalk w = row_walk; w.q < n; w.next()) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (w.u < staged) v = *reinterpret_cast<const uint4*>(rows + w.q * lde + 8 * w.u);
      *reinterpret_cast<uint4*>(out + size_t(row0 + w.q) * EP + 8 * w.u) = v;
    }
  }
}

static size_t kp_smem(int EP) {
  return KP_ROWS * 3 * sizeof(float) + size_t(KP_ROWS) * (EP + KP_ROW_PAD) * sizeof(bf16);
}

// The instantiations: planes and lines in groups of 8 features (the 360
// configuration, static or 4-D), 4-feature planes beside 8-wide line
// groups, and one that takes the widths from k at run time.
static const decltype(&kplanes_encode_kernel<0, 0>) KP_KERNELS[] = {
    kplanes_encode_kernel<8, 8>, kplanes_encode_kernel<4, 8>,
    kplanes_encode_kernel<0, 0>};

// The instantiation for k's group widths, an index into KP_KERNELS.
static int kp_which(const KpArgs& k) {
  return k.vl != 8 ? 2 : k.vf == 8 ? 0 : k.vf == 4 ? 1 : 2;
}

// The persistent grid of instantiation `which` at EP on the current device:
// SMs x resident blocks, or 0; the kernel's shared memory set for EP. The
// occupancy query costs more host time than a launch, so it is made once
// per device, instantiation and EP.
static int kp_grid(int which, int EP, cudaError_t& err) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, int> grids;
  const auto kern = KP_KERNELS[which];
  const size_t smem = kp_smem(EP);
  int dev = 0;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess)
    return 0;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, which, EP);
  const auto hit = grids.find(key);
  if (hit != grids.end()) return hit->second;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, KP_THREADS,
                                                           smem)) != cudaSuccess)
    return 0;
  return grids[key] = sms * per_sm;
}

extern "C" int nerf_kplanes_encode(const void* pts, int Q, const void* kp_pack,
                                   const long long* kp_offsets,
                                   const int* kp_res, int n_scales, int F,
                                   int L, int Fl, int tfold, float box,
                                   const float* bands, int n_bands, int EP,
                                   void* out, void* stream) {
  KpArgs k;
  if (Q < 0 || EP % 8 != 0 ||
      !make_kp_args(k, kp_pack, kp_offsets, kp_res, n_scales, F, L, Fl, tfold,
                    box, bands, n_bands) ||
      kp_row_dim(k) > EP)
    return static_cast<int>(cudaErrorInvalidValue);
  const int which = kp_which(k);
  cudaError_t err;
  const int blocks = kp_grid(which, EP, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (Q == 0) return 0;
  const int tiles = (Q + KP_ROWS - 1) / KP_ROWS, grid = tiles < blocks ? tiles : blocks;
  KP_KERNELS[which]<<<grid, KP_THREADS, kp_smem(EP), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), Q, k, EP, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}
