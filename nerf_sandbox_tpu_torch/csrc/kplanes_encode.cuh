// K3: the k-planes encode of the fused eval kernel, as a block-level
// __device__ function over a tile of sample rows, shared by the K2 ray-march
// (fused_raymarch.cu, k-planes instantiation) and the encode-only entry
// (kplanes_encode.cu).
//
// Replaces the TPU kernel's k-planes branch,
// nerf_sandbox_tpu/ops/fused_raymarch.py:_kp_encode_body (with the tables of
// _kp_pack_tables), static and 4-D folded: world point -> bf16 row
// [scale0 F, scale1 F, .., line Fl, hybrid 3+6L, zeros up to EP].
// What it computes, not its TPU layout: the TPU builds (Q, R) hat-weight rows
// from iota and runs one (Q,R)x(R,R) MXU product per feature, because Mosaic
// has no gathers. Here a bilinear lookup is four texel reads:
//   u = x01*(R-1), i0 = min(floor(u), R-2), weights 1-|u-i0| and 1-|u-i0-1|
//   each rounded to bf16 (the TPU's hat rows are bf16), so u = 1 gives (0, 1)
//   at R-2 and R-1 as the hat does.
// Rounding points are the Pallas ones: bf16 weight x bf16 texel products and
// their sums in fp32 (the MXU's dot with fp32 accumulation), the second
// contraction, the plane/fold/line products and the hybrid sin/cos in fp32,
// and one cast to bf16 per output. The weight arithmetic uses explicit _rn
// intrinsics so that nvcc cannot contract it into an fma the TPU does not do.
//
// Bound on the H100: per sample 2 scales x 3 planes x 4 corners x 16 B plus
// 3 lines x 2 corners x 32 B = 576 B of table reads from L2 (the bf16 tables
// are 1.03 MB at full width and stay there) and ~1.5 kFLOP of fp32; inside K2
// the rows go to shared memory, so the MLP's tensor cores stay the bound.
// Design: tables in the JAX (R, R, F) layout, so one 8-feature texel is one
// 16-byte __ldg; one thread per (row, scale), one per (row, lines) and one per
// (row, hybrid channels + zero padding), so a warp's 32 threads take one kind
// of task; features in groups of V to bound registers, V = 8 when F is a
// multiple of 8, else the widest of 4, 2, 1 that F (and, for the lines, their
// first column) allows, so every texel read and row write of a group is one
// aligned load or store of V bf16 values; the arithmetic per feature is the
// same for every V. Rows are written through an accessor (row-major for the
// encode-only entry, wgmma's swizzled layout inside K2) that keeps each
// 8-column group contiguous.
#pragma once

#include "common.cuh"

namespace nerf {

// Row-major rows at stride ld: the encode-only entry's staging buffer.
struct RowMajorRows {
  bf16* base;
  int ld;
  __device__ __forceinline__ bf16* at(int q, int c) const {
    return base + size_t(q) * ld + c;
  }
};

constexpr int KP_MAX_SCALES = 4;
constexpr int KP_MAX_BANDS = 32;

struct KpArgs {
  const bf16* plane[KP_MAX_SCALES][3];   // xy, xz, yz: (R, R, F)
  const bf16* fold[KP_MAX_SCALES][3];    // x, y, z time folds: (R, F)
  const bf16* line[3];                   // x, y, z: (L, Fl)
  int res[KP_MAX_SCALES];
  int n_scales, F, L, Fl, tfold;
  int vf, vl;                            // features per load: planes, lines
  float box;                             // 2 * aabb_scale
  float bands[KP_MAX_BANDS];             // hybrid bands
  int n_bands;                           // 0: no hybrid channels
};

// The most bf16 values (8, 4, 2 or 1) that divide n: the width of one load
// or store of a feature group.
__host__ __device__ inline int vec_width(int n) {
  return (n & 7) == 0 ? 8 : (n & 3) == 0 ? 4 : (n & 1) == 0 ? 2 : 1;
}

// The packed tables (ops/kplanes_encode.py:pack_kplanes): element offsets
// into one bf16 buffer, planes per scale, then folds per scale (4-D only),
// then lines. False for shapes the kernels do not take.
inline bool make_kp_args(KpArgs& k, const void* pack, const long long* offsets,
                         const int* res, int n_scales, int F, int L, int Fl,
                         int tfold, float box, const float* bands,
                         int n_bands) {
  if (pack == nullptr || n_scales < 1 || n_scales > KP_MAX_SCALES || F < 1 ||
      Fl < 1 || L < 2 || n_bands < 0 || n_bands > KP_MAX_BANDS || !(box > 0.0f))
    return false;
  const bf16* base = static_cast<const bf16*>(pack);
  const int n_tables = 3 * n_scales * (tfold ? 2 : 1) + 3;
  for (int i = 0; i < n_tables; ++i)
    if (offsets[i] % 8 != 0) return false;     // up to 16-byte texel loads
  int t = 0;
  for (int s = 0; s < KP_MAX_SCALES; ++s) {
    k.res[s] = s < n_scales ? res[s] : 0;
    if (s < n_scales && res[s] < 2) return false;
    for (int p = 0; p < 3; ++p) {
      k.plane[s][p] = s < n_scales ? base + offsets[t++] : nullptr;
      k.fold[s][p] = nullptr;
    }
  }
  if (tfold)
    for (int s = 0; s < n_scales; ++s)
      for (int d = 0; d < 3; ++d) k.fold[s][d] = base + offsets[t++];
  for (int d = 0; d < 3; ++d) k.line[d] = base + offsets[t++];
  k.n_scales = n_scales; k.F = F; k.L = L; k.Fl = Fl; k.tfold = tfold;
  // a plane group starts at column s*F, a line group at n_scales*F + f0
  k.vf = vec_width(F);
  k.vl = vec_width(Fl | (n_scales * F));
  k.box = box;
  for (int i = 0; i < KP_MAX_BANDS; ++i) k.bands[i] = i < n_bands ? bands[i] : 0.0f;
  k.n_bands = n_bands;
  return true;
}

// Columns a row of the encode fills before its zero padding.
inline int kp_row_dim(const KpArgs& k) {
  return k.n_scales * k.F + k.Fl + (k.n_bands > 0 ? 3 + 6 * k.n_bands : 0);
}

struct Hat {
  int i0;
  float w0, w1;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ Hat hat(float x01, int R) {
  const float u = __fmul_rn(x01, float(R - 1));
  Hat h;
  h.i0 = min(int(floorf(u)), R - 2);
  h.w0 = bf16_round(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(u, float(h.i0))))));
  h.w1 = bf16_round(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(u, float(h.i0 + 1))))));
  return h;
}

// v[e] = features [f0, f0+V) of one texel: one read-only load of V bf16
// values (16 bytes at V = 8), p aligned to V values.
template <int V>
__device__ __forceinline__ void loadv(float (&v)[V], const bf16* __restrict__ p) {
  if constexpr (V == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else if constexpr (V == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else if constexpr (V == 2) {
    const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = __bfloat162float(
        __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
  }
}

// out = w0 * t0 + w1 * t1 over V features: the MXU dot of a bf16 hat row
// with a bf16 table column (both products exact in fp32, one rounding).
template <int V>
__device__ __forceinline__ void lerpv(float (&out)[V], const bf16* t0,
                                      const bf16* t1, float w0, float w1) {
  float a[V], b[V];
  loadv<V>(a, t0);
  loadv<V>(b, t1);
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = __fmaf_rn(w1, b[e], __fmul_rn(w0, a[e]));
}

// V values rounded to bf16, one aligned store of V bf16 values.
template <int V>
__device__ __forceinline__ void storev(bf16* dst, const float (&v)[V]) {
  __align__(16) bf16 b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) b[e] = __float2bfloat16_rn(v[e]);
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(b);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(b);
  } else if constexpr (V == 2) {
    *reinterpret_cast<unsigned int*>(dst) = *reinterpret_cast<const unsigned int*>(b);
  } else {
    *dst = b[0];
  }
}

// Scale s of row q: F features at columns [c0, c0 + F), c0 % V == 0, in
// groups of V (a divisor of F).
template <int V, class Out>
__device__ __forceinline__ void kp_scale(const KpArgs& k, int s,
                                         const float (&x01)[3], const Out& out,
                                         int q, int c0) {
  const int R = k.res[s], F = k.F;
  Hat h[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) h[d] = hat(x01[d], R);
  for (int f0 = 0; f0 < F; f0 += V) {
    float prod[V];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int da = p < 2 ? 0 : 1, db = p == 0 ? 1 : 2;
      const bf16* P = k.plane[s][p];
      const size_t r0 = size_t(h[da].i0) * R, r1 = r0 + R;
      const int j0 = h[db].i0;
      // contract axis da at columns j0 and j0+1, then axis db
      float a0[V], a1[V];
      lerpv<V>(a0, P + (r0 + j0) * F + f0, P + (r1 + j0) * F + f0, h[da].w0,
               h[da].w1);
      lerpv<V>(a1, P + (r0 + j0 + 1) * F + f0, P + (r1 + j0 + 1) * F + f0,
               h[da].w0, h[da].w1);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = __fadd_rn(__fmul_rn(h[db].w0, a0[e]),
                                  __fmul_rn(h[db].w1, a1[e]));
        prod[e] = p == 0 ? f : __fmul_rn(prod[e], f);
      }
    }
    if (k.tfold) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const bf16* T = k.fold[s][d];
        float tf[V];
        lerpv<V>(tf, T + size_t(h[d].i0) * F + f0, T + size_t(h[d].i0 + 1) * F + f0,
                 h[d].w0, h[d].w1);
#pragma unroll
        for (int e = 0; e < V; ++e) prod[e] = __fmul_rn(prod[e], tf[e]);
      }
    }
    storev<V>(out.at(q, c0 + f0), prod);
  }
}

// The CP lines of row q: Fl features at columns [c0, c0 + Fl), in groups of
// V (a divisor of Fl and of c0).
template <int V, class Out>
__device__ __forceinline__ void kp_lines(const KpArgs& k, const float (&x01)[3],
                                         const Out& out, int q, int c0) {
  const int Fl = k.Fl;
  Hat h[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) h[d] = hat(x01[d], k.L);
  for (int f0 = 0; f0 < Fl; f0 += V) {
    float prod[V];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float v[V];
      lerpv<V>(v, k.line[d] + size_t(h[d].i0) * Fl + f0,
               k.line[d] + size_t(h[d].i0 + 1) * Fl + f0, h[d].w0, h[d].w1);
#pragma unroll
      for (int e = 0; e < V; ++e) prod[e] = d == 0 ? v[e] : __fmul_rn(prod[e], v[e]);
    }
    storev<V>(out.at(q, c0 + f0), prod);
  }
}

// The group width V of a task, a template argument.
template <class Out>
__device__ __forceinline__ void kp_scale_any(const KpArgs& k, int s,
                                             const float (&x01)[3], const Out& out,
                                             int q, int c0) {
  switch (k.vf) {
    case 8: kp_scale<8>(k, s, x01, out, q, c0); break;
    case 4: kp_scale<4>(k, s, x01, out, q, c0); break;
    case 2: kp_scale<2>(k, s, x01, out, q, c0); break;
    default: kp_scale<1>(k, s, x01, out, q, c0); break;
  }
}
template <class Out>
__device__ __forceinline__ void kp_lines_any(const KpArgs& k, const float (&x01)[3],
                                             const Out& out, int q, int c0) {
  switch (k.vl) {
    case 8: kp_lines<8>(k, x01, out, q, c0); break;
    case 4: kp_lines<4>(k, x01, out, q, c0); break;
    case 2: kp_lines<2>(k, x01, out, q, c0); break;
    default: kp_lines<1>(k, x01, out, q, c0); break;
  }
}

// The hybrid channels [u, sin(f u).., cos(f u)..] of u = 2*x01-1 (the
// frequency encoder's column order), then zeros, over columns [c0, end) of
// row q (any c0; the zeros go as 16-byte stores from the first 8-aligned
// column).
template <class Out>
__device__ __forceinline__ void kp_hybrid_and_pad(const KpArgs& k,
                                                  const float (&x01)[3],
                                                  const Out& out, int q, int c0,
                                                  int end) {
  const float u[3] = {__fsub_rn(__fmul_rn(x01[0], 2.0f), 1.0f),
                      __fsub_rn(__fmul_rn(x01[1], 2.0f), 1.0f),
                      __fsub_rn(__fmul_rn(x01[2], 2.0f), 1.0f)};
  const int half = 3 * k.n_bands;
  const int n_enc = k.n_bands > 0 ? 3 + 2 * half : 0;
  for (int c = 0; c < n_enc; ++c) {
    float v;
    if (c < 3) {
      v = u[c];
    } else {
      const int j = c - 3, jj = j < half ? j : j - half;
      const float arg = __fmul_rn(u[jj % 3], k.bands[jj / 3]);
      v = j < half ? sinf(arg) : cosf(arg);
    }
    *out.at(q, c0 + c) = __float2bfloat16_rn(v);
  }
  // zero padding: 16-byte stores from the first 8-aligned column
  const bf16 zero = __float2bfloat16_rn(0.0f);
  int c = c0 + n_enc;
  for (; c < end && (c & 7); ++c) *out.at(q, c) = zero;
  for (; c + 8 <= end; c += 8) *reinterpret_cast<uint4*>(out.at(q, c)) = make_uint4(0, 0, 0, 0);
  for (; c < end; ++c) *out.at(q, c) = zero;
}

// Encode rows [0, n_rows) of a tile of tile_rows: pts (n_rows, 3) fp32 world
// points (in shared or global memory) -> rows of EP bf16 columns through the
// accessor out. Called by the nthreads threads of the tile, thread tid; the
// caller synchronises after it. k is the kernel's __grid_constant__
// parameter, indexed in place.
template <class Out>
__device__ __forceinline__ void kplanes_encode_rows(const KpArgs& k,
                                                   const float* pts, int n_rows,
                                                   int tile_rows, int tid,
                                                   int nthreads, const Out& out,
                                                   int EP) {
  const int kinds = k.n_scales + 2;
  const int c_line = k.n_scales * k.F, c_hyb = c_line + k.Fl;
  for (int task = tid; task < tile_rows * kinds; task += nthreads) {
    const int q = task % tile_rows, kind = task / tile_rows;
    if (q >= n_rows) continue;
    float x01[3];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      x01[d] = fminf(fmaxf(__fadd_rn(__fdiv_rn(pts[q * 3 + d], k.box), 0.5f),
                           0.0f), 1.0f);
    if (kind < k.n_scales)
      kp_scale_any(k, kind, x01, out, q, kind * k.F);
    else if (kind == k.n_scales)
      kp_lines_any(k, x01, out, q, c_line);
    else
      kp_hybrid_and_pad(k, x01, out, q, c_hyb, EP);
  }
}

}  // namespace nerf
