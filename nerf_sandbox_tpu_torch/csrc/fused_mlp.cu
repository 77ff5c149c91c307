// K1: the whole NeRF MLP fused into one kernel, raw [r, g, b, sigma] logits.
//
// Replaces the TPU kernel nerf_sandbox_tpu/ops/fused_mlp.py:fused_nerf_apply
// (body _kernel, pl.pallas_call at :188). One block of 128 threads per tile of
// 64 sample rows: it stages the tile's bf16 encodings in shared memory (zero
// padding 63->64 and 27->32 columns and the ragged last tile), runs the MLP
// of mlp_tile.cuh, and writes only the 4 real output columns (the TPU's
// 128-lane output padding is gone). Tensor-core bound; see mlp_tile.cuh.
#include "mlp_tile.cuh"

using namespace nerf;

__global__ void __launch_bounds__(N_THREADS)
fused_mlp_kernel(const bf16* __restrict__ enc_pos,
                 const bf16* __restrict__ enc_dir, int Q, int P_dim, int D_dim,
                 MlpArgs P, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpSmemLayout L(P.H, P.EP, P.ED);
  const MlpSmem S = carve(smem, L);
  const int row0 = blockIdx.x * TILE_M, tid = threadIdx.x;
  const int lde = P.EP + ROW_PAD, ldd = P.ED + ROW_PAD;
  const bf16 zero = __float2bfloat16(0.0f);

  for (int i = tid; i < TILE_M * P.EP; i += N_THREADS) {
    const int q = i / P.EP, c = i % P.EP, r = row0 + q;
    S.enc[q * lde + c] =
        (r < Q && c < P_dim) ? enc_pos[size_t(r) * P_dim + c] : zero;
  }
  for (int i = tid; i < TILE_M * P.ED; i += N_THREADS) {
    const int q = i / P.ED, c = i % P.ED, r = row0 + q;
    S.ed[q * ldd + c] =
        (r < Q && c < D_dim) ? enc_dir[size_t(r) * D_dim + c] : zero;
  }
  __syncthreads();

  mlp_tile(P, S);

  for (int i = tid; i < TILE_M * 4; i += N_THREADS) {
    const int q = i >> 2, c = i & 3, r = row0 + q;
    if (r < Q) out[size_t(r) * 4 + c] = c < 3 ? S.rgb[q * 3 + c] : S.sigma[q];
  }
}

extern "C" int nerf_fused_mlp(const void* enc_pos, const void* enc_dir,
                              const void* wpack, const long long* offsets,
                              int Q, int P_dim, int D_dim, int H, int EP,
                              int ED, int n_layers, int skip_pos, void* out,
                              void* stream) {
  if (!mlp_shape_ok(H, EP, ED, n_layers, skip_pos) || P_dim > EP ||
      D_dim > ED || Q < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const MlpArgs P = make_mlp_args(wpack, offsets, H, EP, ED, n_layers, skip_pos);
  const MlpSmemLayout L(H, EP, ED);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q == 0) return 0;
  const dim3 grid((Q + TILE_M - 1) / TILE_M);
  fused_mlp_kernel<<<grid, N_THREADS, L.total,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(enc_pos), static_cast<const bf16*>(enc_dir), Q,
      P_dim, D_dim, P, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
