// K2: the fused eval ray-march: sample points -> [K2c: mip-NeRF 360
// contraction] -> sin/cos encode or [K3: k-planes encode] or [K4: mip-NeRF
// integrated positional encoding] -> skip MLP -> sigmoid rgb, relu/softplus
// sigma -> transmittance composite, with optional early ray termination (ERT).
//
// Replaces the TPU kernel nerf_sandbox_tpu/ops/fused_raymarch.py:fused_raymarch
// (bodies _kernel and _kernel_chunk_body, pl.pallas_call at :667): its
// frequency branch, its contraction branch (:406-413), its k-planes branch
// (_kp_encode_body, kplanes_encode.cuh) and its IPE branch (:432-486, with
// the wrapper's interval streams :631-648). The encoder and the contraction
// are template parameters, so each of the six instantiations carries only
// its own code. What it computes, not its TPU layout:
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
//    of starting at log T = -80;
//  * K2c warps the points as they are placed, before either encoder, with
//    the branchless formula of core/encoding.py:scene_contract; z and dt
//    stay metric.
//  * K4 turns each (ray, sample) row into a conical-frustum Gaussian in the
//    pass that places the points: its interval from the neighbouring z of
//    the row (the TPU streamed the midpoint and half-width from the host
//    because a chunk cannot see its neighbours; here the row is in device
//    memory), the moments, then the mean and the diagonal variance by the
//    lift or, under contraction, the closed-form Jacobian pushforward. The
//    mean goes where the point would, the variance into a TILE_M x 3 buffer,
//    and the encode multiplies each sin/cos column by exp(-f^2 var / 2):
//    per-row fp32 arithmetic in place of the TPU's one-hot relayouts and
//    (Q,3)x(3,EP) limb-split matmuls.
//
// Bound on the H100: the MLP's 1.19 MFLOP per sample against ~10 bytes of
// HBM traffic per sample, so the tensor cores set the bound (mlp_tile.cuh
// describes the MLP's design); the encode and composite are per-thread fp32
// work between the MLP tiles, and ERT removes whole tiles of work.
#include "kplanes_encode.cuh"

using namespace nerf;

constexpr int SPC = 4;                 // samples of each ray per MLP tile
constexpr int RAYS = TILE_M / SPC;     // rays owned by one block
constexpr int MAX_BANDS = 32;

struct MarchArgs {
  const float *rays_o, *rays_d, *ray_norms, *enc_dir, *z, *dt;
  const float* radii;   // (B,) pixel-cone radii (K4), else null
  float bands[MAX_BANDS];
  int n_bands, include_input;
  int B, N, D;
  int softplus, white_bkgd, use_ert;
  float log_eps;
  float* out_ray;   // (B, 5): sum w*rgb (+ background), clipped acc, sum w*z
  float* out_w;     // (B, N)
};

constexpr int GEO = 8;   // per-ray floats in shared memory: o, d, |d|, radius

struct MarchSmemLayout {
  size_t pts, var, geo, total;
  __host__ __device__ explicit MarchSmemLayout(const MlpSmemLayout& L) {
    pts = L.total;
    var = align128(pts + size_t(TILE_M) * 3 * sizeof(float));
    geo = align128(var + size_t(TILE_M) * 3 * sizeof(float));
    total = align128(geo + size_t(RAYS) * GEO * sizeof(float));
  }
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

enum Encoder { ENC_FREQ = 0, ENC_KPLANES = 1, ENC_IPE = 2 };

// mip-NeRF 360 contraction of one point (K2c): p for |p| <= 1, else
// (2 - 1/|p|) * p/|p|, with |p| floored at 1e-9.
__device__ __forceinline__ void contract_point(float (&p)[3]) {
  const float n = fmaxf(sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(p[0], p[0]),
                                                  __fmul_rn(p[1], p[1])),
                                        __fmul_rn(p[2], p[2]))),
                        1e-9f);
  if (!(n <= 1.0f)) {
    const float s = __fsub_rn(2.0f, __fdiv_rn(1.0f, n));
#pragma unroll
    for (int c = 0; c < 3; ++c) p[c] = __fmul_rn(s, __fdiv_rn(p[c], n));
  }
}

// K4: midpoint mu and half-width hw of sample n's interval in a row zr of
// N >= 2 samples, on the metric z*|d| (core/encoding.py:z_to_intervals:
// interior edges at neighbour midpoints, the end intervals mirrored). The
// products are rounded before the sums, as the host computes z*|d| first.
__device__ __forceinline__ void frustum_interval(const float* zr, int N, int n,
                                                 float norm, float& mu,
                                                 float& hw) {
  const float zc = __fmul_rn(zr[n], norm);
  const float lower = n > 0 ? 0.5f * (zc + __fmul_rn(zr[n - 1], norm))
                            : 2.0f * zc - 0.5f * (__fmul_rn(zr[1], norm) + zc);
  const float upper = n < N - 1
                          ? 0.5f * (__fmul_rn(zr[n + 1], norm) + zc)
                          : 2.0f * zc - 0.5f * (zc + __fmul_rn(zr[n - 1], norm));
  mu = 0.5f * (lower + upper);
  hw = 0.5f * (upper - lower);
}

// K4: the frustum Gaussian of one sample of the ray g (o, d, |d|, radius):
// the moments of mip-NeRF eq. 7 (JAX order, so the two sides of t_var
// cancel alike), mean = o + d t_mean, and the diagonal variance by the lift
// t_var d^2 + r_var (1 - d^2) or, under CONTRACT, pushed through the
// contraction: J = s I + c x x^T for n = |x| > 1 (s = 2/n - 1/n^2,
// c = 2(1-n)/n^4), var = t_var (Jd)^2 + r_var max(rowsum(J o J) - (Jd)^2, 0)
// and the mean contracted; J = I inside the unit ball.
template <bool CONTRACT>
__device__ __forceinline__ void frustum_gaussian(const float* g, float mu,
                                                 float hw, float (&mean)[3],
                                                 float (&var)[3]) {
  const float hw2 = hw * hw, mu2 = mu * mu, hw4 = hw2 * hw2;
  const float denom = 3.0f * mu * mu + hw2;
  const float t_mean = mu + (2.0f * mu * hw2) / denom;
  const float t_var =
      hw2 / 3.0f - (4.0f / 15.0f) * ((hw4 * (12.0f * mu2 - hw2)) / (denom * denom));
  const float r_var = g[7] * g[7] *
                      (mu2 / 4.0f + (5.0f / 12.0f) * hw2 - (4.0f / 15.0f) * hw4 / denom);
  const float d[3] = {g[3], g[4], g[5]};
#pragma unroll
  for (int c = 0; c < 3; ++c) mean[c] = g[c] + d[c] * t_mean;
  if (CONTRACT) {
    const float n2 = fmaxf(mean[0] * mean[0] + mean[1] * mean[1] + mean[2] * mean[2],
                           1e-18f);
    const float n = sqrtf(n2);
    if (n <= 1.0f) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        var[c] = t_var * (d[c] * d[c]) + r_var * fmaxf(1.0f - d[c] * d[c], 0.0f);
    } else {
      const float s = 2.0f / n - 1.0f / n2;
      const float cj = 2.0f * (1.0f - n) / (n2 * n2);
      const float xd = mean[0] * d[0] + mean[1] * d[1] + mean[2] * d[2];
      const float k = 2.0f - 1.0f / n;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float x = mean[c];
        const float jd = s * d[c] + cj * x * xd;
        const float row2 = s * s + 2.0f * s * cj * x * x + cj * cj * x * x * n2;
        var[c] = t_var * (jd * jd) + r_var * fmaxf(row2 - jd * jd, 0.0f);
        mean[c] = k * (x / n);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      var[c] = t_var * (d[c] * d[c]) + r_var * (1.0f - d[c] * d[c]);
  }
}

template <int ENC, bool CONTRACT>
__global__ void __launch_bounds__(N_THREADS)
fused_raymarch_kernel(const MarchArgs a, const MlpArgs P,
                      const __grid_constant__ KpArgs k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpSmemLayout L(P.H, P.EP, P.ED);
  const MarchSmemLayout M(L);
  const MlpSmem S = carve(smem, L);
  float* pts = reinterpret_cast<float*>(smem + M.pts);   // (TILE_M, 3)
  float* var = reinterpret_cast<float*>(smem + M.var);   // (TILE_M, 3), K4
  float* geo = reinterpret_cast<float*>(smem + M.geo);   // (RAYS, GEO)
  const int tid = threadIdx.x, ray0 = blockIdx.x * RAYS;
  const int lde = P.EP + ROW_PAD, ldd = P.ED + ROW_PAD;
  const int N = a.N;

  if (tid < RAYS) {
    const int r = ray0 + tid;
    const bool ok = r < a.B;
    for (int c = 0; c < 3; ++c) {
      geo[tid * GEO + c] = ok ? a.rays_o[size_t(r) * 3 + c] : 0.0f;
      geo[tid * GEO + 3 + c] = ok ? a.rays_d[size_t(r) * 3 + c] : 0.0f;
    }
    geo[tid * GEO + 6] = ok ? a.ray_norms[r] : 0.0f;
    geo[tid * GEO + 7] = ok && ENC == ENC_IPE ? a.radii[r] : 0.0f;
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
      const float* g = geo + rl * GEO;
      float p[3];
      if (ENC == ENC_IPE) {
        // padded rows take (mu, hw) = (1, 0), as the TPU's streams do: finite
        // moments (denom = 3), and their samples are never composited
        float mu = 1.0f, hw = 0.0f, v[3];
        if (r < a.B && n < N) frustum_interval(a.z + size_t(r) * N, N, n, g[6], mu, hw);
        frustum_gaussian<CONTRACT>(g, mu, hw, p, v);
        for (int c = 0; c < 3; ++c) var[tid * 3 + c] = v[c];
      } else {
        const float z = (r < a.B && n < N) ? a.z[size_t(r) * N + n] : 0.0f;
        const float zm = z * g[6];
        for (int c = 0; c < 3; ++c) p[c] = g[c] + g[3 + c] * zm;
        if (CONTRACT) contract_point(p);
      }
      for (int c = 0; c < 3; ++c) pts[tid * 3 + c] = p[c];
    }
    __syncthreads();
    if (ENC == ENC_KPLANES) {
      kplanes_encode_rows(k, pts, TILE_M, S.enc, lde, P.EP);
    } else {
      for (int i = tid; i < TILE_M * P.EP; i += N_THREADS) {
        const int q = i / P.EP, c = i % P.EP;
        float v = 0.0f;
        if (c < n_id) {
          v = pts[q * 3 + c];
        } else if (c < n_enc) {
          const int j = c - n_id;
          const int jj = j < half ? j : j - half;
          const float f = a.bands[jj / 3];
          const float arg = pts[q * 3 + jj % 3] * f;
          v = j < half ? sinf(arg) : cosf(arg);
          // K4: E[sin(f x)] = sin(f mean) exp(-f^2 var / 2), the same for cos
          if (ENC == ENC_IPE) v *= expf(-0.5f * var[q * 3 + jj % 3] * (f * f));
        }
        S.enc[q * lde + c] = __float2bfloat16_rn(v);
      }
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

template <int ENC, bool CONTRACT>
static int launch_march(const MarchArgs& a, const MlpArgs& P, const KpArgs& k,
                        size_t smem, int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_raymarch_kernel<ENC, CONTRACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks == 0) return 0;
  fused_raymarch_kernel<ENC, CONTRACT><<<blocks, N_THREADS, smem, stream>>>(a, P, k);
  return static_cast<int>(cudaGetLastError());
}

// kp_pack null: the frequency encoder with bands/include_input, or with
// ipe_radii (B,) its integrated form (K4; N >= 2). Otherwise the k-planes
// encoder of the packed tables (kplanes_encode.cuh: make_kp_args), its
// hybrid channels from kp_bands; bands are unused.
extern "C" int nerf_fused_raymarch(
    const void* rays_o, const void* rays_d, const void* ray_norms,
    const void* enc_dir, const void* z, const void* dt, const float* bands,
    int n_bands, int include_input, const void* wpack,
    const long long* offsets, int B, int N, int D, int H, int EP, int ED,
    int n_layers, int skip_pos, int softplus, int white_bkgd, int use_ert,
    float log_eps, int contract, const void* ipe_radii, const void* kp_pack,
    const long long* kp_offsets, const int* kp_res, int kp_scales, int kp_F,
    int kp_L, int kp_Fl, int kp_tfold, float kp_box, const float* kp_bands,
    int kp_n_bands, void* out_ray, void* out_w, void* stream) {
  const bool kp = kp_pack != nullptr, ipe = ipe_radii != nullptr;
  KpArgs k{};
  if (!mlp_shape_ok(H, EP, ED, n_layers, skip_pos) || D > ED || B < 0 || N < 1 ||
      (ipe && (kp || N < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kp) {
    if (!make_kp_args(k, kp_pack, kp_offsets, kp_res, kp_scales, kp_F, kp_L,
                      kp_Fl, kp_tfold, kp_box, kp_bands, kp_n_bands) ||
        kp_row_dim(k) > EP)
      return static_cast<int>(cudaErrorInvalidValue);
    n_bands = 0;
  } else if (n_bands < 0 || n_bands > MAX_BANDS ||
             (include_input ? 3 : 0) + 6 * n_bands > EP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MarchArgs a;
  a.rays_o = static_cast<const float*>(rays_o);
  a.rays_d = static_cast<const float*>(rays_d);
  a.ray_norms = static_cast<const float*>(ray_norms);
  a.enc_dir = static_cast<const float*>(enc_dir);
  a.z = static_cast<const float*>(z);
  a.dt = static_cast<const float*>(dt);
  a.radii = static_cast<const float*>(ipe_radii);
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
  const int blocks = (B + RAYS - 1) / RAYS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kp)
    return contract ? launch_march<ENC_KPLANES, true>(a, P, k, M.total, blocks, st)
                    : launch_march<ENC_KPLANES, false>(a, P, k, M.total, blocks, st);
  if (ipe)
    return contract ? launch_march<ENC_IPE, true>(a, P, k, M.total, blocks, st)
                    : launch_march<ENC_IPE, false>(a, P, k, M.total, blocks, st);
  return contract ? launch_march<ENC_FREQ, true>(a, P, k, M.total, blocks, st)
                  : launch_march<ENC_FREQ, false>(a, P, k, M.total, blocks, st);
}
