// K2: the fused eval ray-march, frequency encoder: sample points -> sin/cos
// encode -> skip MLP -> sigmoid rgb, relu/softplus sigma -> transmittance
// composite, with optional early ray termination (ERT).
//
// Replaces the TPU kernel nerf_sandbox_tpu/ops/fused_raymarch.py:fused_raymarch
// (bodies _kernel and _kernel_chunk_body, pl.pallas_call at :667), frequency
// branch. What it computes, not its TPU layout:
//  * the TPU carries per-ray state across SEQUENTIAL grid steps; CUDA blocks
//    run in no order, so one block owns RAYS rays and loops over their
//    samples itself, SPC samples of each ray per 64-row MLP tile, with
//    log T, sum w, sum w*z and sum w*rgb in registers of the ray's thread;
//  * z and dt come in the public (B, N) layout and weights go out (B, N):
//    no transposed layouts, one-hot relayouts, _dotx limb splits or
//    triangular-matmul cumsum (Mosaic workarounds);
//  * encode arguments are elementwise fp32 x*f with the accurate sinf/cosf
//    (the build has no fast math: the top band 2^9 puts arguments at
//    thousands of radians), columns [x, sin(f0 xyz).., cos(f0 xyz)..] padded;
//  * padded rays of the last block are masked out of the ERT test instead
//    of starting at log T = -80.
//
// Bound on the H100: the MLP's 1.19 MFLOP per sample against ~10 bytes of
// HBM traffic per sample, so the tensor cores set the bound (mlp_tile.cuh
// describes the MLP's design); the encode and composite are per-thread fp32
// work between the MLP tiles, and ERT removes whole tiles of work.
#include "mlp_tile.cuh"

using namespace nerf;

constexpr int SPC = 4;                 // samples of each ray per MLP tile
constexpr int RAYS = TILE_M / SPC;     // rays owned by one block
constexpr int MAX_BANDS = 32;

struct MarchArgs {
  const float *rays_o, *rays_d, *ray_norms, *enc_dir, *z, *dt;
  float bands[MAX_BANDS];
  int n_bands, include_input;
  int B, N, D;
  int softplus, white_bkgd, use_ert;
  float log_eps;
  float* out_ray;   // (B, 5): sum w*rgb (+ background), clipped acc, sum w*z
  float* out_w;     // (B, N)
};

struct MarchSmemLayout {
  size_t pts, geo, total;
  __host__ __device__ explicit MarchSmemLayout(const MlpSmemLayout& L) {
    pts = L.total;
    geo = align128(pts + size_t(TILE_M) * 3 * sizeof(float));
    total = align128(geo + size_t(RAYS) * 7 * sizeof(float));
  }
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(N_THREADS)
fused_raymarch_kernel(const MarchArgs a, const MlpArgs P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpSmemLayout L(P.H, P.EP, P.ED);
  const MarchSmemLayout M(L);
  const MlpSmem S = carve(smem, L);
  float* pts = reinterpret_cast<float*>(smem + M.pts);   // (TILE_M, 3)
  float* geo = reinterpret_cast<float*>(smem + M.geo);   // (RAYS, 7): o, d, |d|
  const int tid = threadIdx.x, ray0 = blockIdx.x * RAYS;
  const int lde = P.EP + ROW_PAD, ldd = P.ED + ROW_PAD;
  const int N = a.N;

  if (tid < RAYS) {
    const int r = ray0 + tid;
    const bool ok = r < a.B;
    for (int c = 0; c < 3; ++c) {
      geo[tid * 7 + c] = ok ? a.rays_o[size_t(r) * 3 + c] : 0.0f;
      geo[tid * 7 + 3 + c] = ok ? a.rays_d[size_t(r) * 3 + c] : 0.0f;
    }
    geo[tid * 7 + 6] = ok ? a.ray_norms[r] : 0.0f;
  }
  // Tile row q = ray (q / SPC), sample (q % SPC) of the chunk: the ray's
  // encoded direction is the same for every chunk, so stage it once.
  for (int i = tid; i < TILE_M * P.ED; i += N_THREADS) {
    const int q = i / P.ED, c = i % P.ED, r = ray0 + q / SPC;
    const float v = (r < a.B && c < a.D) ? a.enc_dir[size_t(r) * a.D + c] : 0.0f;
    S.ed[q * ldd + c] = __float2bfloat16_rn(v);
  }

  const int my_ray = ray0 + tid;
  const bool owner = tid < RAYS && my_ray < a.B;
  float logT = 0.0f, sw = 0.0f, swz = 0.0f, swr = 0.0f, swg = 0.0f, swb = 0.0f;
  const int n_id = a.include_input ? 3 : 0;
  const int half = 3 * a.n_bands;
  const int n_enc = n_id + 2 * half;
  __syncthreads();

  for (int n0 = 0; n0 < N; n0 += SPC) {
    if (a.use_ert) {
      // ERT: once every real ray of the block has T < eps, the rest of its
      // samples contribute < eps per channel; emit zero weights for them.
      const int alive = owner && logT >= a.log_eps;
      if (!__syncthreads_or(alive)) {
        const int rest = N - n0;
        for (int i = tid; i < RAYS * rest; i += N_THREADS) {
          const int r = ray0 + i / rest, n = n0 + i % rest;
          if (r < a.B) a.out_w[size_t(r) * N + n] = 0.0f;
        }
        break;
      }
    }
    if (tid < TILE_M) {
      const int rl = tid / SPC, n = n0 + tid % SPC, r = ray0 + rl;
      const float z = (r < a.B && n < N) ? a.z[size_t(r) * N + n] : 0.0f;
      const float zm = z * geo[rl * 7 + 6];
      for (int c = 0; c < 3; ++c)
        pts[tid * 3 + c] = geo[rl * 7 + c] + geo[rl * 7 + 3 + c] * zm;
    }
    __syncthreads();
    for (int i = tid; i < TILE_M * P.EP; i += N_THREADS) {
      const int q = i / P.EP, c = i % P.EP;
      float v = 0.0f;
      if (c < n_id) {
        v = pts[q * 3 + c];
      } else if (c < n_enc) {
        const int j = c - n_id;
        const int jj = j < half ? j : j - half;
        const float arg = pts[q * 3 + jj % 3] * a.bands[jj / 3];
        v = j < half ? sinf(arg) : cosf(arg);
      }
      S.enc[q * lde + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();

    mlp_tile(P, S);

    if (owner) {
      for (int s = 0; s < SPC && n0 + s < N; ++s) {
        const int q = tid * SPC + s;
        const size_t idx = size_t(my_ray) * N + n0 + s;
        const float raw = S.sigma[q];
        const float sig = a.softplus
                              ? fmaxf(raw, 0.0f) + log1pf(expf(-fabsf(raw)))
                              : fmaxf(raw, 0.0f);
        const float sdt = fminf(fmaxf(sig * a.dt[idx], 0.0f), 60.0f);
        const float one_m_alpha = expf(-sdt);
        const float w = expf(logT) * (1.0f - one_m_alpha);
        a.out_w[idx] = w;
        logT += logf(one_m_alpha + 1e-10f);
        sw += w;
        swz += w * a.z[idx];
        swr += w * sigmoidf(S.rgb[q * 3 + 0]);
        swg += w * sigmoidf(S.rgb[q * 3 + 1]);
        swb += w * sigmoidf(S.rgb[q * 3 + 2]);
      }
    }
    __syncthreads();
  }

  if (owner) {
    const float acc = fminf(fmaxf(sw, 0.0f), 1.0f);
    const float bg = a.white_bkgd ? 1.0f - acc : 0.0f;
    float* o = a.out_ray + size_t(my_ray) * 5;
    o[0] = swr + bg;
    o[1] = swg + bg;
    o[2] = swb + bg;
    o[3] = acc;
    o[4] = swz;
  }
}

extern "C" int nerf_fused_raymarch(
    const void* rays_o, const void* rays_d, const void* ray_norms,
    const void* enc_dir, const void* z, const void* dt, const float* bands,
    int n_bands, int include_input, const void* wpack,
    const long long* offsets, int B, int N, int D, int H, int EP, int ED,
    int n_layers, int skip_pos, int softplus, int white_bkgd, int use_ert,
    float log_eps, void* out_ray, void* out_w, void* stream) {
  if (!mlp_shape_ok(H, EP, ED, n_layers, skip_pos) || n_bands < 0 ||
      n_bands > MAX_BANDS || (include_input ? 3 : 0) + 6 * n_bands > EP ||
      D > ED || B < 0 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  MarchArgs a;
  a.rays_o = static_cast<const float*>(rays_o);
  a.rays_d = static_cast<const float*>(rays_d);
  a.ray_norms = static_cast<const float*>(ray_norms);
  a.enc_dir = static_cast<const float*>(enc_dir);
  a.z = static_cast<const float*>(z);
  a.dt = static_cast<const float*>(dt);
  for (int i = 0; i < MAX_BANDS; ++i) a.bands[i] = i < n_bands ? bands[i] : 0.0f;
  a.n_bands = n_bands;
  a.include_input = include_input;
  a.B = B; a.N = N; a.D = D;
  a.softplus = softplus; a.white_bkgd = white_bkgd; a.use_ert = use_ert;
  a.log_eps = log_eps;
  a.out_ray = static_cast<float*>(out_ray);
  a.out_w = static_cast<float*>(out_w);
  const MlpArgs P = make_mlp_args(wpack, offsets, H, EP, ED, n_layers, skip_pos);
  const MlpSmemLayout L(H, EP, ED);
  const MarchSmemLayout M(L);
  cudaError_t err = cudaFuncSetAttribute(
      fused_raymarch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(M.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  const dim3 grid((B + RAYS - 1) / RAYS);
  fused_raymarch_kernel<<<grid, N_THREADS, M.total,
                          static_cast<cudaStream_t>(stream)>>>(a, P);
  return static_cast<int>(cudaGetLastError());
}
