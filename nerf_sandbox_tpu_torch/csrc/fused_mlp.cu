// K1: the whole NeRF MLP fused into one kernel, raw [r, g, b, sigma] logits.
//
// Replaces the TPU kernel nerf_sandbox_tpu/ops/fused_mlp.py:fused_nerf_apply
// (body _kernel, pl.pallas_call at :188). Bound on the H100: the tensor cores,
// 1.19 MFLOP of bf16 work per row at the vanilla widths against ~190 bytes of
// HBM traffic (1.258 ms at 2^20 rows).
//
// Design: mlp_tile.cuh's block of two consumer warpgroups and one producer
// warp, one persistent block per SM walking tiles of TILE_M = 128 rows (R =
// 128 rows per weight fetch from L2, through a ring of up to 8 stages). Each
// consumer warpgroup stages its 64 rows' bf16 encodings in shared memory in
// wgmma's swizzled layout (zero padding 63->64 and 27->64 columns and the
// ragged last tile), runs the MLP with the activations in registers (hidden
// width 128 or 256), in shared memory (384 or 512: the wide path of
// mlp_tile.cuh) or in global scratch (any multiple of 128 above 512: the
// large route, one instantiation for every such width), and writes only the
// 4 real output columns (the TPU's 128-lane output padding is gone).
#include "mlp_tile.cuh"

using namespace nerf;

// H: the hidden width, or 0 for the large route (H > 512 at run time).
template <int H>
__global__ void __launch_bounds__(N_THREADS, 1)
fused_mlp_kernel(const bf16* __restrict__ enc_pos,
                 const bf16* __restrict__ enc_dir, int Q, int P_dim, int D_dim,
                 const MlpArgsOf<H> P, float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int R = route_of(H);
  mlp_setup<R>(smem, P);
  const int wg = warpgroup(), t = threadIdx.x % WG_THREADS;
  if (wg == N_CONSUMERS) {
    mlp_produce<R>(smem, P);
    return;
  }
  consumer_regs();
  const MlpSmem S = mlp_carve<R>(smem, P);
  const bf16 zero = __float2bfloat16(0.0f);
  bf16* enc = S.enc[wg];
  bf16* ed = S.ed[wg];
  const float* res = S.out[wg];
  Pipe pipe(S, P, R != ROUTE_REGS);
  const int n_tiles = (Q + TILE_M - 1) / TILE_M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_M + wg * WG_ROWS;
    wg_sync(wg);   // the last pass's reads of enc, ed and out are done
    for (int i = t; i < WG_ROWS * P.EP; i += WG_THREADS) {
      const int q = i / P.EP, c = i % P.EP, r = row0 + q;
      enc[swz(q, c)] = (r < Q && c < P_dim) ? enc_pos[size_t(r) * P_dim + c] : zero;
    }
    for (int i = t; i < WG_ROWS * P.EDP; i += WG_THREADS) {
      const int q = i / P.EDP, c = i % P.EDP, r = row0 + q;
      ed[swz(q, c)] = (r < Q && c < D_dim) ? enc_dir[size_t(r) * D_dim + c] : zero;
    }
    fence_async_smem();
    wg_sync(wg);
    mlp_pass_any<H>(P, S, wg, pipe);
    wg_sync(wg);
    for (int i = t; i < WG_ROWS * 4; i += WG_THREADS) {
      const int r = row0 + (i >> 2);
      if (r < Q) out[size_t(r) * 4 + (i & 3)] = res[i];
    }
  }
  mlp_drain(S, pipe);
}

template <int H>
static int launch_mlp(const bf16* ep, const bf16* ed, int Q, int P_dim, int D_dim,
                      MlpArgsOf<H> P, float* out, cudaStream_t stream) {
  const size_t smem = plan_stages(P, 0);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare_kernel(fused_mlp_kernel<H>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q == 0) return 0;
  const int grid = grid_blocks((Q + TILE_M - 1) / TILE_M, P);
  fused_mlp_kernel<H><<<grid, N_THREADS, smem, stream>>>(ep, ed, Q, P_dim, D_dim,
                                                         P, out);
  return static_cast<int>(cudaGetLastError());
}

static int fused_mlp_entry(const void* enc_pos, const void* enc_dir,
                           const void* wpack, const long long* offsets,
                           const void* staged, int Q, int P_dim, int D_dim, int H,
                           int EP, int ED, int n_layers, int skip_pos, void* scratch,
                           int scratch_blocks, void* out, void* stream) {
  const bool large = scratch != nullptr && scratch_blocks > 0;
  if (!mlp_shape_ok(H, EP, ED, n_layers, skip_pos, large) || P_dim > EP ||
      D_dim > ED || Q < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const MlpArgs P = make_mlp_args(wpack, offsets, staged, H, EP, ED, n_layers,
                                  skip_pos);
  const bf16* ep = static_cast<const bf16*>(enc_pos);
  const bf16* ed = static_cast<const bf16*>(enc_dir);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H > 512)
    return launch_mlp<0>(ep, ed, Q, P_dim, D_dim,
                         make_large_args(P, scratch, scratch_blocks), o, st);
  if (H == 512) return launch_mlp<512>(ep, ed, Q, P_dim, D_dim, P, o, st);
  if (H == 384) return launch_mlp<384>(ep, ed, Q, P_dim, D_dim, P, o, st);
  return H == 256 ? launch_mlp<256>(ep, ed, Q, P_dim, D_dim, P, o, st)
                  : launch_mlp<128>(ep, ed, Q, P_dim, D_dim, P, o, st);
}

// Hidden widths 128, 256, 384 and 512.
extern "C" int nerf_fused_mlp(const void* enc_pos, const void* enc_dir,
                              const void* wpack, const long long* offsets,
                              const void* staged, int Q, int P_dim, int D_dim,
                              int H, int EP, int ED, int n_layers, int skip_pos,
                              void* out, void* stream) {
  return fused_mlp_entry(enc_pos, enc_dir, wpack, offsets, staged, Q, P_dim, D_dim, H,
                         EP, ED, n_layers, skip_pos, nullptr, 0, out, stream);
}

// Every hidden width, with the large route's scratch: 2 x 2 x 64 x H bf16 for
// each of at most scratch_blocks persistent blocks.
extern "C" int nerf_fused_mlp_large(const void* enc_pos, const void* enc_dir,
                                    const void* wpack, const long long* offsets,
                                    const void* staged, int Q, int P_dim, int D_dim,
                                    int H, int EP, int ED, int n_layers, int skip_pos,
                                    void* scratch, int scratch_blocks, void* out,
                                    void* stream) {
  return fused_mlp_entry(enc_pos, enc_dir, wpack, offsets, staged, Q, P_dim, D_dim, H,
                         EP, ED, n_layers, skip_pos, scratch, scratch_blocks, out,
                         stream);
}
