// The NeRF skip MLP over one tile of TILE_M sample rows, as a block-level
// __device__ function shared by the K1 (fused_mlp.cu) and K2
// (fused_raymarch.cu) kernels.
//
// Replaces the body of the TPU kernel nerf_sandbox_tpu/ops/fused_mlp.py:_kernel
// with the same rounding points: bf16 operands, fp32 accumulation, an fp32
// add of the bf16 bias, relu, then a cast to bf16 between layers; the skip
// layer as h@W_h + enc@W_e; sigma from the last trunk activation (the TPU's
// column H of the feature matmul); the feature cast to bf16 before the
// colour head on [feature, enc_dir].
//
// Bound on the H100: 1.19 MFLOP of bf16 work per row against ~180 input
// bytes, so the tensor cores, not HBM, set the bound. Design: the tile's
// activations live in shared memory as bf16 (ping-pong buffers of
// TILE_M x (H+8)); each of the 4 warps owns a column slice of every layer and
// runs nvcuda::wmma bf16 16x16x16 products with fp32 accumulators over the
// whole tile height, reading weight fragments straight from global memory
// (all weights are ~1.2 MB and stay in L2). The epilogue goes through a
// per-warp 16x16 fp32 staging tile because wmma's accumulator layout is
// opaque. wgmma/TMA and shared-memory weight staging are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

namespace nerf {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int TILE_M = 64;                 // sample rows per MLP tile
constexpr int N_WARPS = 4;
constexpr int N_THREADS = N_WARPS * 32;
constexpr int ROW_PAD = 8;                 // bf16 pad per shared row (16 B)
constexpr int M_FRAGS = TILE_M / 16;

// Packed weight arrays, in the order of PACK_FIELDS in ops/fused_mlp.py;
// the host passes each array's element offset into one bf16 buffer.
enum PackField {
  W0, B0, W_MID, B_MID, WSKIP_H, WSKIP_E, BSKIP, W_FEAT, B_FEAT, W_SIG, B_SIG,
  WC1, BC1, WC2T, BC2, N_FIELDS
};

struct MlpArgs {
  const bf16* p[N_FIELDS];
  int H, EP, ED, n_layers, skip_pos;
};

struct MlpSmem {
  bf16 *h0, *h1, *enc, *ed;
  float *scratch, *sigma, *rgb;
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

// Byte offsets of the MLP's shared-memory buffers (all 128-byte aligned, as
// wmma needs 32-byte aligned fragment pointers).
struct MlpSmemLayout {
  size_t h0, h1, enc, ed, scratch, sigma, rgb, total;
  __host__ __device__ MlpSmemLayout(int H, int EP, int ED) {
    size_t o = 0;
    h0 = o;      o = align128(o + size_t(TILE_M) * (H + ROW_PAD) * sizeof(bf16));
    h1 = o;      o = align128(o + size_t(TILE_M) * (H + ROW_PAD) * sizeof(bf16));
    enc = o;     o = align128(o + size_t(TILE_M) * (EP + ROW_PAD) * sizeof(bf16));
    ed = o;      o = align128(o + size_t(TILE_M) * (ED + ROW_PAD) * sizeof(bf16));
    scratch = o; o = align128(o + size_t(N_WARPS) * 256 * sizeof(float));
    sigma = o;   o = align128(o + size_t(TILE_M) * sizeof(float));
    rgb = o;     o = align128(o + size_t(TILE_M) * 3 * sizeof(float));
    total = o;
  }
};

__device__ inline MlpSmem carve(unsigned char* base, const MlpSmemLayout& L) {
  MlpSmem s;
  s.h0 = reinterpret_cast<bf16*>(base + L.h0);
  s.h1 = reinterpret_cast<bf16*>(base + L.h1);
  s.enc = reinterpret_cast<bf16*>(base + L.enc);
  s.ed = reinterpret_cast<bf16*>(base + L.ed);
  s.scratch = reinterpret_cast<float*>(base + L.scratch);
  s.sigma = reinterpret_cast<float*>(base + L.sigma);
  s.rgb = reinterpret_cast<float*>(base + L.rgb);
  return s;
}

inline MlpArgs make_mlp_args(const void* wpack, const long long* offsets, int H,
                             int EP, int ED, int n_layers, int skip_pos) {
  MlpArgs a;
  const bf16* base = static_cast<const bf16*>(wpack);
  for (int i = 0; i < N_FIELDS; ++i) a.p[i] = base + offsets[i];
  a.H = H; a.EP = EP; a.ED = ED; a.n_layers = n_layers; a.skip_pos = skip_pos;
  return a;
}

// The layers wmma can run: H a multiple of 64, EP and ED multiples of 16
// (ops/fused_mlp.py:fusable and _enc_pads guarantee both).
inline bool mlp_shape_ok(int H, int EP, int ED, int n_layers, int skip_pos) {
  return H > 0 && H % 64 == 0 && EP % 16 == 0 && ED % 16 == 0 &&
         n_layers >= 3 && skip_pos > 0 && skip_pos < n_layers;
}

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;

// acc[TILE_M x 16*CF] += A[TILE_M x K] (shared, row stride lda) @
//                        W[K x ldw] (global, row-major) columns [c0, c0+16*CF)
template <int CF>
__device__ __forceinline__ void mma_accumulate(FragAcc (&acc)[M_FRAGS][CF],
                                               const bf16* A, int lda, int K,
                                               const bf16* __restrict__ W,
                                               int ldw, int c0) {
  for (int k = 0; k < K; k += 16) {
    FragB b[CF];
#pragma unroll
    for (int j = 0; j < CF; ++j)
      wmma::load_matrix_sync(b[j], W + size_t(k) * ldw + c0 + 16 * j, ldw);
#pragma unroll
    for (int i = 0; i < M_FRAGS; ++i) {
      FragA a;
      wmma::load_matrix_sync(a, A + size_t(16 * i) * lda + k, lda);
#pragma unroll
      for (int j = 0; j < CF; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
    }
  }
}

// out[TILE_M x N] = act(A1 @ W1 + A2 @ W2 + bias) in bf16, fp32 inside.
// Warp w owns column chunks w*CW, w*CW + 4*CW, ... (CW = 16*CF); A2/W2 is the
// optional second operand pair (K2 = 0 to skip) of the skip layer and the
// colour head. Both W1 and W2 are row-major with row length N.
template <int CF>
__device__ void tile_layer(const bf16* A1, int lda1, int K1, const bf16* W1,
                           const bf16* A2, int lda2, int K2, const bf16* W2,
                           int N, const bf16* __restrict__ bias, bool relu,
                           bf16* out, int ldo, float* scratch) {
  constexpr int CW = 16 * CF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ws = scratch + warp * 256;
  for (int c0 = warp * CW; c0 < N; c0 += N_WARPS * CW) {
    FragAcc acc[M_FRAGS][CF];
#pragma unroll
    for (int i = 0; i < M_FRAGS; ++i)
#pragma unroll
      for (int j = 0; j < CF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    mma_accumulate<CF>(acc, A1, lda1, K1, W1, N, c0);
    if (K2 > 0) mma_accumulate<CF>(acc, A2, lda2, K2, W2, N, c0);

    const int r = lane >> 1, cc = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < M_FRAGS; ++i) {
#pragma unroll
      for (int j = 0; j < CF; ++j) {
        wmma::store_matrix_sync(ws, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int col = c0 + 16 * j + cc;
        __align__(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float y = ws[r * 16 + cc + e] + __bfloat162float(bias[col + e]);
          if (relu) y = fmaxf(y, 0.0f);
          v[e] = __float2bfloat16_rn(y);
        }
        *reinterpret_cast<uint4*>(out + size_t(16 * i + r) * ldo + col) =
            *reinterpret_cast<const uint4*>(v);
        __syncwarp();
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// out[r*stride + c] = X[r, :K] . Wt[c, :K] + b[c] for c < C, fp32 accumulate:
// the sigma head (C = 1, stride 1) and the rgb head (C = 3, stride 3).
__device__ void head_dots(const bf16* X, int ldx, int K,
                          const bf16* __restrict__ Wt,
                          const bf16* __restrict__ b, int C, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int ROWS = TILE_M / N_WARPS;
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    for (int c = 0; c < C; ++c) {
      float s = 0.0f;
      for (int k = lane; k < K; k += 32)
        s += __bfloat162float(X[size_t(r) * ldx + k]) *
             __bfloat162float(Wt[size_t(c) * K + k]);
      s = warp_sum(s);
      if (lane == 0) out[r * C + c] = s + __bfloat162float(b[c]);
    }
  }
}

// The whole MLP on the tile whose encoded inputs are in S.enc / S.ed (the
// caller fills them and synchronises). Leaves raw logits in S.sigma
// (TILE_M) and S.rgb (TILE_M x 3) and synchronises before returning.
__device__ void mlp_tile(const MlpArgs& P, const MlpSmem& S) {
  const int H = P.H, ldh = H + ROW_PAD;
  const int lde = P.EP + ROW_PAD, ldd = P.ED + ROW_PAD;
  bf16* cur = S.h0;
  bf16* nxt = S.h1;

  tile_layer<4>(S.enc, lde, P.EP, P.p[W0], nullptr, 0, 0, nullptr, H, P.p[B0],
                true, cur, ldh, S.scratch);
  __syncthreads();
  int mid = 0;
  for (int l = 1; l < P.n_layers; ++l) {
    if (l == P.skip_pos) {
      tile_layer<4>(cur, ldh, H, P.p[WSKIP_H], S.enc, lde, P.EP, P.p[WSKIP_E],
                    H, P.p[BSKIP], true, nxt, ldh, S.scratch);
    } else {
      tile_layer<4>(cur, ldh, H, P.p[W_MID] + size_t(mid) * H * H, nullptr, 0,
                    0, nullptr, H, P.p[B_MID] + size_t(mid) * H, true, nxt, ldh,
                    S.scratch);
      ++mid;
    }
    __syncthreads();
    bf16* t = cur; cur = nxt; nxt = t;
  }
  // feature (no activation, rounded to bf16) and sigma, both from h = cur
  tile_layer<4>(cur, ldh, H, P.p[W_FEAT], nullptr, 0, 0, nullptr, H,
                P.p[B_FEAT], false, nxt, ldh, S.scratch);
  head_dots(cur, ldh, H, P.p[W_SIG], P.p[B_SIG], 1, S.sigma);
  __syncthreads();
  // colour head on [feature, enc_dir]: rows [0, H) and [H, H+ED) of wc1
  tile_layer<2>(nxt, ldh, H, P.p[WC1], S.ed, ldd, P.ED,
                P.p[WC1] + size_t(H) * (H / 2), H / 2, P.p[BC1], true, cur, ldh,
                S.scratch);
  __syncthreads();
  head_dots(cur, ldh, H / 2, P.p[WC2T], P.p[BC2], 3, S.rgb);
  __syncthreads();
}

}  // namespace nerf

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
