// K3 on its own: the k-planes encode of the fused ray-march (the __device__
// function of kplanes_encode.cuh) over Q points, rows written to device
// memory as (Q, EP) bf16.
//
// Replaces the TPU kernel's k-planes branch,
// nerf_sandbox_tpu/ops/fused_raymarch.py:_kp_encode_body (inside the
// pl.pallas_call at :667), so that the encode can be held against its plain
// version alone and feed the K1 MLP (models/forward.py, use_kernel=True).
// One block of 128 threads per 64 rows, points read straight from device
// memory; the rows are built in shared memory, as inside K2, then written
// out as 16-byte stores with neighbouring threads on neighbouring addresses.
// Bound on the H100: the EP*2 bytes written per row (256 B at full width)
// against 12 B read and ~1.5 kFLOP, so HBM writes set the bound.
#include "kplanes_encode.cuh"

using namespace nerf;

constexpr int KP_TILE_M = 64;      // rows per block
constexpr int KP_THREADS = 128;
constexpr int KP_ROW_PAD = 8;      // bf16 pad per staged row (16 B)

__global__ void __launch_bounds__(KP_THREADS)
kplanes_encode_kernel(const float* __restrict__ pts, int Q,
                      const __grid_constant__ KpArgs k,
                      int EP, bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* rows = reinterpret_cast<bf16*>(smem);
  const int lde = EP + KP_ROW_PAD;
  const int row0 = blockIdx.x * KP_TILE_M, n = min(KP_TILE_M, Q - row0);
  kplanes_encode_rows(k, pts + size_t(row0) * 3, n, KP_TILE_M, threadIdx.x,
                      KP_THREADS, RowMajorRows{rows, lde}, EP);
  __syncthreads();
  const int chunks = EP / 8;
  for (int i = threadIdx.x; i < n * chunks; i += KP_THREADS) {
    const int q = i / chunks, c = (i % chunks) * 8;
    *reinterpret_cast<uint4*>(out + size_t(row0 + q) * EP + c) =
        *reinterpret_cast<const uint4*>(rows + q * lde + c);
  }
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
  const size_t smem = size_t(KP_TILE_M) * (EP + KP_ROW_PAD) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      kplanes_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q == 0) return 0;
  const dim3 grid((Q + KP_TILE_M - 1) / KP_TILE_M);
  kplanes_encode_kernel<<<grid, KP_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), Q, k, EP, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}
