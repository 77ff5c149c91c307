// K2: the fused eval ray-march: sample points -> [K2c: mip-NeRF 360
// contraction] -> sin/cos encode or [K3: k-planes encode] or [K4: mip-NeRF
// integrated positional encoding] -> skip MLP -> sigmoid rgb, relu/softplus
// sigma -> transmittance composite, with optional early ray termination (ERT).
//
// Replaces the TPU kernel nerf_sandbox_tpu/ops/fused_raymarch.py:fused_raymarch
// (bodies _kernel and _kernel_chunk_body, pl.pallas_call at :667): its
// frequency branch, its contraction branch (:406-413), its k-planes branch
// (_kp_encode_body, kplanes_encode.cuh) and its IPE branch (:432-486, with
// the wrapper's interval streams :631-648). The encoder, the contraction and
// the hidden width (128, 256, 384 or 512, or 0 for the large route of
// mlp_tile.cuh, which takes any multiple of 128 above 512 at run time) are
// template parameters, so each of the thirty instantiations carries only its
// own code. What it computes, not its TPU layout:
//  * the TPU carries per-ray state across SEQUENTIAL grid steps; CUDA blocks
//    run in no order, so a block owns a group of RAYS rays at a time and
//    loops over their samples itself, SPC samples of each ray per pass of
//    the MLP, with log T, sum w, sum w*z and sum w*rgb kept for the ray's
//    thread in shared memory (the registers belong to the MLP);
//  * z comes in the public (B, N) layout and weights go out (B, N), and each
//    sample's delta (z[n+1] - z[n]) |d|, the last one 1e10 |d| or 0, is
//    formed where the point is placed (the wrapper's _deltas, op for op):
//    no transposed layouts, one-hot relayouts, _dotx limb splits or
//    triangular-matmul cumsum (Mosaic workarounds);
//  * encode arguments are elementwise fp32 x*f with the accurate sincosf
//    (the build has no fast math: the top band 2^9 puts arguments at
//    thousands of radians), columns [x, sin(f0 xyz).., cos(f0 xyz)..] padded;
//  * padded rays of the last group are masked out of the ERT test instead
//    of starting at log T = -80;
//  * K2c warps the points as they are placed, before either encoder, with
//    the branchless formula of core/encoding.py:scene_contract; z and the
//    deltas stay metric.
//  * K4 turns each (ray, sample) row into a conical-frustum Gaussian in the
//    pass that places the points: its interval from the neighbouring z of
//    the row (the TPU streamed the midpoint and half-width from the host
//    because a chunk cannot see its neighbours; here the row is in device
//    memory), the moments, then the mean and the diagonal variance by the
//    lift or, under contraction, the closed-form Jacobian pushforward. The
//    mean goes where the point would, the variance into a 64 x 3 buffer,
//    and the encode multiplies each sin/cos column by exp(-f^2 var / 2):
//    per-row fp32 arithmetic in place of the TPU's one-hot relayouts and
//    (Q,3)x(3,EP) limb-split matmuls.
//
// Bound on the H100: the MLP's 1.19 MFLOP per sample against ~10 bytes of
// HBM traffic per sample, so the tensor cores set the bound: 3.775 ms for a
// 16384 x 192 fine tile, 1.258 ms for a 16384 x 64 coarse one.
//
// Design: the block of mlp_tile.cuh (two consumer warpgroups of 64 rows, so
// R = 128 rows per weight fetch, and one producer warp streaming the weights
// through a ring of up to 8 stages), one persistent block per SM walking ray
// groups. A group is RAYS = 32 rays, 16 per consumer warpgroup; each pass of
// the MLP takes SPC = 4 samples of each ray (64 rows a warpgroup). Each
// warpgroup places, encodes and composites its own rows, synchronised by its
// own named barrier only: while one warpgroup runs that fp32 work, the other
// can run its wgmmas on the stages in the ring (up to NS chunks ahead), so the
// two drift into a ping-pong over the tensor cores. ERT is decided for the
// whole group (a barrier-reduction over the 256 consumer threads), so both
// warpgroups keep consuming the same weight stream; a stopped group ends only
// that group, the block goes on with its next one.
#include "kplanes_encode.cuh"
#include "mlp_tile.cuh"

using namespace nerf;

constexpr int SPC = 4;                         // samples of each ray per pass
constexpr int WG_RAYS = WG_ROWS / SPC;         // rays of one consumer warpgroup
constexpr int RAYS = WG_RAYS * N_CONSUMERS;    // rays of a group
constexpr int MAX_BANDS = 32;

struct MarchArgs {
  const float *rays_o, *rays_d, *ray_norms, *enc_dir, *z;
  int inf_last;         // the last delta 1e10 |d| (else 0)
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
// Per-ray composite state in shared memory (registers go to the MLP):
// log T, sum w, sum w*z, sum w*rgb.
enum RayState { LOGT, SW, SWZ, SWR, SWG, SWB, N_STATE = 8 };

// Per consumer warpgroup: points (64 x 3), K4 variances (64 x 3), the rows'
// z and dt (read where the points are placed, so the composite waits on no
// global load; two buffers, by the parity of the pass, so the next pass's
// placement cannot overwrite what this pass's composite reads), geo, state.
constexpr int WG_MARCH_FLOATS = WG_ROWS * (3 * 2 + 2 * 2) + WG_RAYS * (GEO + N_STATE);
constexpr size_t MARCH_EXTRA = N_CONSUMERS * WG_MARCH_FLOATS * sizeof(float);

// Rows written straight into wgmma's swizzled A layout (K3's accessor).
struct SwizzledRows {
  bf16* base;
  __device__ __forceinline__ bf16* at(int q, int c) const { return base + swz(q, c); }
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

template <int ENC, bool CONTRACT, int H>
__global__ void __launch_bounds__(N_THREADS, 1)
fused_raymarch_kernel(const MarchArgs a, const MlpArgsOf<H> P,
                      const __grid_constant__ KpArgs k) {
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
  float* pts = reinterpret_cast<float*>(S.extra) + wg * WG_MARCH_FLOATS;  // (64, 3)
  float* var = pts + WG_ROWS * 3;                                          // (64, 3), K4
  float* zdt = var + WG_ROWS * 3;                                          // (2, 2, 64)
  float* geo = zdt + 4 * WG_ROWS;                                          // (16, GEO)
  float* state = geo + WG_RAYS * GEO;                                      // (16, N_STATE)
  bf16* enc = S.enc[wg];
  bf16* ed = S.ed[wg];
  const float* res = S.out[wg];
  const int N = a.N, EP = P.EP, EDP = P.EDP;
  const int n_id = a.include_input ? 3 : 0;
  const int half = 3 * a.n_bands;
  const int n_enc = n_id + 2 * half;
  const int n_groups = (a.B + RAYS - 1) / RAYS;
  Pipe pipe(S, P, R != ROUTE_REGS);

  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int ray0 = grp * RAYS + wg * WG_RAYS;
    wg_sync(wg);   // the last group's reads of geo, ed and out are done
    if (t < WG_RAYS) {
      const int r = ray0 + t;
      const bool ok = r < a.B;
      for (int c = 0; c < 3; ++c) {
        geo[t * GEO + c] = ok ? a.rays_o[size_t(r) * 3 + c] : 0.0f;
        geo[t * GEO + 3 + c] = ok ? a.rays_d[size_t(r) * 3 + c] : 0.0f;
      }
      geo[t * GEO + 6] = ok ? a.ray_norms[r] : 0.0f;
      geo[t * GEO + 7] = ok && ENC == ENC_IPE ? a.radii[r] : 0.0f;
      for (int i = 0; i < N_STATE; ++i) state[t * N_STATE + i] = 0.0f;
    }
    // Row q = ray (q / SPC), sample (q % SPC) of the pass: the ray's encoded
    // direction is the same for every pass, so stage it once per group.
    for (int i = t; i < WG_ROWS * EDP; i += WG_THREADS) {
      const int q = i / EDP, c = i % EDP, r = ray0 + q / SPC;
      const float v = (r < a.B && c < a.D) ? a.enc_dir[size_t(r) * a.D + c] : 0.0f;
      ed[swz(q, c)] = __float2bfloat16_rn(v);
    }
    float* st = state + (t < WG_RAYS ? t : 0) * N_STATE;
    wg_sync(wg);

    for (int n0 = 0; n0 < N; n0 += SPC) {
      float* zrow = zdt + ((n0 / SPC) & 1) * 2 * WG_ROWS;
      float* dtrow = zrow + WG_ROWS;
      if (a.use_ert) {
        // ERT: once every real ray of the group has T < eps, the rest of its
        // samples contribute < eps per channel; emit zero weights for them.
        const bool alive = t < WG_RAYS && ray0 + t < a.B && st[LOGT] >= a.log_eps;
        if (!consumers_any(alive)) {
          const int rest = N - n0;
          for (int i = t; i < WG_RAYS * rest; i += WG_THREADS) {
            const int r = ray0 + i / rest, n = n0 + i % rest;
            if (r < a.B) a.out_w[size_t(r) * N + n] = 0.0f;
          }
          break;
        }
      }
      // the last 64 threads place the rows, so the first 16 can still be
      // compositing the last pass
      if (t >= WG_THREADS - WG_ROWS) {
        const int q = t - (WG_THREADS - WG_ROWS);
        const int rl = q / SPC, n = n0 + q % SPC, r = ray0 + rl;
        const float* g = geo + rl * GEO;
        const bool real = r < a.B && n < N;
        const float zn = real ? a.z[size_t(r) * N + n] : 0.0f;
        const float gap = !real ? 0.0f
                          : n + 1 < N ? __fsub_rn(a.z[size_t(r) * N + n + 1], zn)
                          : a.inf_last ? 1e10f : 0.0f;
        zrow[q] = zn;
        dtrow[q] = __fmul_rn(gap, g[6]);
        float p[3];
        if (ENC == ENC_IPE) {
          // padded rows take (mu, hw) = (1, 0), as the TPU's streams do: finite
          // moments (denom = 3), and their samples are never composited
          float mu = 1.0f, hw = 0.0f, v[3];
          if (real) frustum_interval(a.z + size_t(r) * N, N, n, g[6], mu, hw);
          frustum_gaussian<CONTRACT>(g, mu, hw, p, v);
          for (int c = 0; c < 3; ++c) var[q * 3 + c] = v[c];
        } else {
          const float zm = zrow[q] * g[6];
          for (int c = 0; c < 3; ++c) p[c] = g[c] + g[3 + c] * zm;
          if (CONTRACT) contract_point(p);
        }
        for (int c = 0; c < 3; ++c) pts[q * 3 + c] = p[c];
      }
      wg_sync(wg);
      if (ENC == ENC_KPLANES) {
        kplanes_encode_rows(k, pts, WG_ROWS, WG_ROWS, t, WG_THREADS,
                            SwizzledRows{enc}, EP);
      } else {
        // per row: the identity columns, one task per (band, coordinate) that
        // writes its sin and its cos column, then the zero padding
        const int per_row = n_id + half + (EP - n_enc);
        for (int i = t; i < WG_ROWS * per_row; i += WG_THREADS) {
          const int q = i / per_row, k = i % per_row;
          if (k < n_id) {
            enc[swz(q, k)] = __float2bfloat16_rn(pts[q * 3 + k]);
          } else if (k < n_id + half) {
            const int j = k - n_id;
            const float f = a.bands[j / 3];
            const float arg = pts[q * 3 + j % 3] * f;
            float sv, cv;
            sincosf(arg, &sv, &cv);
            if (ENC == ENC_IPE) {
              // K4: E[sin(f x)] = sin(f mean) exp(-f^2 var / 2), the same for cos
              const float att = expf(-0.5f * var[q * 3 + j % 3] * (f * f));
              sv *= att;
              cv *= att;
            }
            enc[swz(q, n_id + j)] = __float2bfloat16_rn(sv);
            enc[swz(q, n_id + half + j)] = __float2bfloat16_rn(cv);
          } else {
            enc[swz(q, n_enc + k - n_id - half)] = __float2bfloat16_rn(0.0f);
          }
        }
      }
      fence_async_smem();
      wg_sync(wg);

      mlp_pass_any<H>(P, S, wg, pipe);
      wg_sync(wg);

      if (t < WG_RAYS && ray0 + t < a.B) {
        float logT = st[LOGT], sw = st[SW], swz_ = st[SWZ];
        float swr = st[SWR], swg = st[SWG], swb = st[SWB];
        for (int s = 0; s < SPC && n0 + s < N; ++s) {
          const int q = t * SPC + s;
          const float* o = res + q * 4;
          const float raw = o[3];
          const float sig = a.softplus
                                ? fmaxf(raw, 0.0f) + log1pf(expf(-fabsf(raw)))
                                : fmaxf(raw, 0.0f);
          const float sdt = fminf(fmaxf(sig * dtrow[q], 0.0f), 60.0f);
          const float one_m_alpha = expf(-sdt);
          const float w = expf(logT) * (1.0f - one_m_alpha);
          a.out_w[size_t(ray0 + t) * N + n0 + s] = w;
          logT += logf(one_m_alpha + 1e-10f);
          sw += w;
          swz_ += w * zrow[q];
          swr += w * sigmoidf(o[0]);
          swg += w * sigmoidf(o[1]);
          swb += w * sigmoidf(o[2]);
        }
        st[LOGT] = logT; st[SW] = sw; st[SWZ] = swz_;
        st[SWR] = swr; st[SWG] = swg; st[SWB] = swb;
      }
    }

    if (t < WG_RAYS && ray0 + t < a.B) {
      const float acc = fminf(fmaxf(st[SW], 0.0f), 1.0f);
      const float bg = a.white_bkgd ? 1.0f - acc : 0.0f;
      float* o = a.out_ray + size_t(ray0 + t) * 5;
      o[0] = st[SWR] + bg;
      o[1] = st[SWG] + bg;
      o[2] = st[SWB] + bg;
      o[3] = acc;
      o[4] = st[SWZ];
    }
  }
  mlp_drain(S, pipe);
}

template <int ENC, bool CONTRACT, int H>
static int launch_march(const MarchArgs& a, MlpArgsOf<H> P, const KpArgs& k,
                        cudaStream_t stream) {
  const size_t smem = plan_stages(P, MARCH_EXTRA);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare_kernel(fused_raymarch_kernel<ENC, CONTRACT, H>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (a.B + RAYS - 1) / RAYS;
  if (groups == 0) return 0;
  const int grid = grid_blocks(groups, P);
  fused_raymarch_kernel<ENC, CONTRACT, H><<<grid, N_THREADS, smem, stream>>>(a, P, k);
  return static_cast<int>(cudaGetLastError());
}

// The launches of one encoder and contraction on one MLP route (mlp_tile.cuh:
// MlpRoute): hidden width 128 / 256 (ROUTE_REGS) or 384 / 512 (ROUTE_WIDE), a
// group of two instantiations, or the large route's one (P is then the
// LargeMlpArgs the entry made).
template <int ENC, bool CONTRACT, int ROUTE>
int launch_group(const MarchArgs& a, const MlpArgs& P, const KpArgs& k,
                 cudaStream_t stream) {
  if constexpr (ROUTE == ROUTE_LARGE)
    return launch_march<ENC, CONTRACT, 0>(a, static_cast<const LargeMlpArgs&>(P), k,
                                          stream);
  else if constexpr (ROUTE == ROUTE_WIDE)
    return P.H == 512 ? launch_march<ENC, CONTRACT, 512>(a, P, k, stream)
                      : launch_march<ENC, CONTRACT, 384>(a, P, k, stream);
  else
    return P.H == 256 ? launch_march<ENC, CONTRACT, 256>(a, P, k, stream)
                      : launch_march<ENC, CONTRACT, 128>(a, P, k, stream);
}

// ops/cuda_build.py compiles this file once per group, all at once, with
// -DNERF_PART=p (p = 3 * (2 * encoder + contraction) + route), and links the
// eighteen objects into one library: part p instantiates group p only, part 0
// also holds the C entry. Built without NERF_PART, one object holds all.
#ifdef NERF_PART
#define GROUP(E, C, R) launch_group<E, C, R>(const MarchArgs&, const MlpArgs&, \
                                             const KpArgs&, cudaStream_t)
extern template int GROUP(ENC_FREQ, false, ROUTE_REGS);
extern template int GROUP(ENC_FREQ, false, ROUTE_WIDE);
extern template int GROUP(ENC_FREQ, false, ROUTE_LARGE);
extern template int GROUP(ENC_FREQ, true, ROUTE_REGS);
extern template int GROUP(ENC_FREQ, true, ROUTE_WIDE);
extern template int GROUP(ENC_FREQ, true, ROUTE_LARGE);
extern template int GROUP(ENC_KPLANES, false, ROUTE_REGS);
extern template int GROUP(ENC_KPLANES, false, ROUTE_WIDE);
extern template int GROUP(ENC_KPLANES, false, ROUTE_LARGE);
extern template int GROUP(ENC_KPLANES, true, ROUTE_REGS);
extern template int GROUP(ENC_KPLANES, true, ROUTE_WIDE);
extern template int GROUP(ENC_KPLANES, true, ROUTE_LARGE);
extern template int GROUP(ENC_IPE, false, ROUTE_REGS);
extern template int GROUP(ENC_IPE, false, ROUTE_WIDE);
extern template int GROUP(ENC_IPE, false, ROUTE_LARGE);
extern template int GROUP(ENC_IPE, true, ROUTE_REGS);
extern template int GROUP(ENC_IPE, true, ROUTE_WIDE);
extern template int GROUP(ENC_IPE, true, ROUTE_LARGE);
#if NERF_PART == 0
template int GROUP(ENC_FREQ, false, ROUTE_REGS);
#elif NERF_PART == 1
template int GROUP(ENC_FREQ, false, ROUTE_WIDE);
#elif NERF_PART == 2
template int GROUP(ENC_FREQ, false, ROUTE_LARGE);
#elif NERF_PART == 3
template int GROUP(ENC_FREQ, true, ROUTE_REGS);
#elif NERF_PART == 4
template int GROUP(ENC_FREQ, true, ROUTE_WIDE);
#elif NERF_PART == 5
template int GROUP(ENC_FREQ, true, ROUTE_LARGE);
#elif NERF_PART == 6
template int GROUP(ENC_KPLANES, false, ROUTE_REGS);
#elif NERF_PART == 7
template int GROUP(ENC_KPLANES, false, ROUTE_WIDE);
#elif NERF_PART == 8
template int GROUP(ENC_KPLANES, false, ROUTE_LARGE);
#elif NERF_PART == 9
template int GROUP(ENC_KPLANES, true, ROUTE_REGS);
#elif NERF_PART == 10
template int GROUP(ENC_KPLANES, true, ROUTE_WIDE);
#elif NERF_PART == 11
template int GROUP(ENC_KPLANES, true, ROUTE_LARGE);
#elif NERF_PART == 12
template int GROUP(ENC_IPE, false, ROUTE_REGS);
#elif NERF_PART == 13
template int GROUP(ENC_IPE, false, ROUTE_WIDE);
#elif NERF_PART == 14
template int GROUP(ENC_IPE, false, ROUTE_LARGE);
#elif NERF_PART == 15
template int GROUP(ENC_IPE, true, ROUTE_REGS);
#elif NERF_PART == 16
template int GROUP(ENC_IPE, true, ROUTE_WIDE);
#elif NERF_PART == 17
template int GROUP(ENC_IPE, true, ROUTE_LARGE);
#endif
#endif

template <int ENC, bool CONTRACT>
static int launch_c(const MarchArgs& a, const MlpArgs& P, const KpArgs& k,
                    cudaStream_t stream) {
  switch (mlp_route(P.H)) {
    case ROUTE_LARGE: return launch_group<ENC, CONTRACT, ROUTE_LARGE>(a, P, k, stream);
    case ROUTE_WIDE: return launch_group<ENC, CONTRACT, ROUTE_WIDE>(a, P, k, stream);
    default: return launch_group<ENC, CONTRACT, ROUTE_REGS>(a, P, k, stream);
  }
}

template <int ENC>
static int launch_enc(const MarchArgs& a, const MlpArgs& P, const KpArgs& k,
                      bool contract, cudaStream_t stream) {
  return contract ? launch_c<ENC, true>(a, P, k, stream)
                  : launch_c<ENC, false>(a, P, k, stream);
}

#if !defined(NERF_PART) || NERF_PART == 0
// kp_pack null: the frequency encoder with bands/include_input, or with
// ipe_radii (B,) its integrated form (K4; N >= 2). Otherwise the k-planes
// encoder of the packed tables (kplanes_encode.cuh: make_kp_args), its
// hybrid channels from kp_bands; bands are unused. staged: the weight stream
// (ops/fused_mlp.py:stage_weights). scratch: the large route's (hidden widths
// above 512), 2 x 2 x 64 x H bf16 for each of at most scratch_blocks blocks.
#define MARCH_PARAMS                                                              \
  const void *rays_o, const void *rays_d, const void *ray_norms,                \
      const void *enc_dir, const void *z, int infinite_last_bin,                \
      const float *bands, int n_bands, int include_input, const void *wpack,    \
      const long long *offsets, const void *staged, int B, int N, int D, int H, \
      int EP, int ED, int n_layers, int skip_pos, int softplus, int white_bkgd, \
      int use_ert, float log_eps, int contract, const void *ipe_radii,          \
      const void *kp_pack, const long long *kp_offsets, const int *kp_res,      \
      int kp_scales, int kp_F, int kp_L, int kp_Fl, int kp_tfold, float kp_box, \
      const float *kp_bands, int kp_n_bands
#define MARCH_ARGS                                                              \
  rays_o, rays_d, ray_norms, enc_dir, z, infinite_last_bin, bands, n_bands,     \
      include_input, wpack, offsets, staged, B, N, D, H, EP, ED, n_layers,      \
      skip_pos, softplus, white_bkgd, use_ert, log_eps, contract, ipe_radii,    \
      kp_pack, kp_offsets, kp_res, kp_scales, kp_F, kp_L, kp_Fl, kp_tfold,      \
      kp_box, kp_bands, kp_n_bands

static int raymarch_entry(MARCH_PARAMS, void* scratch, int scratch_blocks,
                          void* out_ray, void* out_w, void* stream) {
  const bool kp = kp_pack != nullptr, ipe = ipe_radii != nullptr;
  const bool large = scratch != nullptr && scratch_blocks > 0;
  KpArgs k{};
  if (!mlp_shape_ok(H, EP, ED, n_layers, skip_pos, large) || D > ED || B < 0 || N < 1 ||
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
  a.inf_last = infinite_last_bin;
  a.radii = static_cast<const float*>(ipe_radii);
  for (int i = 0; i < MAX_BANDS; ++i) a.bands[i] = i < n_bands ? bands[i] : 0.0f;
  a.n_bands = n_bands;
  a.include_input = include_input;
  a.B = B; a.N = N; a.D = D;
  a.softplus = softplus; a.white_bkgd = white_bkgd; a.use_ert = use_ert;
  a.log_eps = log_eps;
  a.out_ray = static_cast<float*>(out_ray);
  a.out_w = static_cast<float*>(out_w);
  const LargeMlpArgs P = make_large_args(
      make_mlp_args(wpack, offsets, staged, H, EP, ED, n_layers, skip_pos), scratch,
      scratch_blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kp) return launch_enc<ENC_KPLANES>(a, P, k, contract, st);
  if (ipe) return launch_enc<ENC_IPE>(a, P, k, contract, st);
  return launch_enc<ENC_FREQ>(a, P, k, contract, st);
}

// Hidden widths 128, 256, 384 and 512.
extern "C" int nerf_fused_raymarch(MARCH_PARAMS, void* out_ray, void* out_w,
                                   void* stream) {
  return raymarch_entry(MARCH_ARGS, nullptr, 0, out_ray, out_w, stream);
}

// Every hidden width, with the large route's scratch.
extern "C" int nerf_fused_raymarch_large(MARCH_PARAMS, void* scratch,
                                         int scratch_blocks, void* out_ray,
                                         void* out_w, void* stream) {
  return raymarch_entry(MARCH_ARGS, scratch, scratch_blocks, out_ray, out_w, stream);
}
#endif
