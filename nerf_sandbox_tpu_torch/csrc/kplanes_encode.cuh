// K3: the k-planes encode of the fused eval kernel, as a block-level
// __device__ function over a tile of KP_ROWS sample rows, shared by the K2
// ray-march (fused_raymarch.cu, k-planes instantiations) and the encode-only
// entry (kplanes_encode.cu).
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
// 3 lines x 2 corners x 32 B = 576 B of table reads from L2 and L1 (the bf16
// tables are 1.03 MB at full width and stay in L2) and ~1.5 kFLOP of fp32 with
// 36 accurate sin/cos; inside K2 the rows go to shared memory, so the MLP's
// tensor cores stay the bound.
//
// Design: tables in the JAX (R, R, F) layout, so one 8-feature texel is one
// 16-byte __ldg. The caller puts x01 = clip(p / box + 0.5, 0, 1) of the tile's
// rows in shared memory once (kp_unit; inside K2 in place of the points). The
// tile is then a work list of tasks of about equal cost, a kind of task at a
// time over all KP_ROWS rows, so that consecutive threads take consecutive
// rows (a warp's texel reads walk neighbouring samples) and the threads of a
// block (or of a K2 warpgroup) take the kinds in turn:
//  * (row, scale, feature group of V): the three plane lookups, the 4-D
//    folds and their product, one store of V bf16 values;
//  * (row, line group of V): the three line lookups and their product;
//  * (row): the identity columns u = 2 x01 - 1 and the zeros up to the first
//    8-aligned column past the row;
//  * (row, coordinate, group of KP_TRIG_BANDS bands): per band one argument
//    f u, its sine and its cosine (sincosf, the same bits as sinf and cosf)
//    into their two columns, three independent chains in one thread, so
//    that finding the task is paid once per three bands; at the 360 default
//    of 6 bands these are 6 tasks a row, each about as long as a plane or a
//    line task;
// the zero padding from the first 8-aligned column to EP is the caller's
// (16-byte stores: K2 writes it once per block, the encode-only entry from
// registers as it sends each row out). V = 8 when F is a multiple of 8, else the widest of 4, 2,
// 1 that F (and, for the lines, their first column) allows, so every texel
// read and row write of a group is one aligned load or store of V bf16
// values; the arithmetic per feature is the same for every V and every task
// split. Rows are written through an accessor (row-major for the encode-only
// entry, wgmma's swizzled layout inside K2) that keeps each 8-column group
// contiguous.
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
constexpr int KP_ROWS = 64;              // rows of a tile: one K2 warpgroup's
constexpr int KP_TRIG_BANDS = 3;         // bands of one (coordinate, bands) task

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
  // The work list of a row (kplanes_encode_rows): task kinds [0, k_line)
  // are (scale, plane group), [k_line, k_ident) line groups, k_ident the
  // identity columns and the unaligned zeros (if any), [k_trig, kinds) the
  // (band group, coordinate) tasks.
  int plane_groups, k_line, k_ident, k_trig, kinds;
  int c_line, c_hyb, c_end, c_zero;      // columns: lines, hybrid, end, zeros
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
  k.c_line = n_scales * F;
  k.c_hyb = k.c_line + Fl;
  k.c_end = k.c_hyb + (n_bands > 0 ? 3 + 6 * n_bands : 0);
  k.c_zero = (k.c_end + 7) & ~7;
  k.plane_groups = F / k.vf;
  k.k_line = n_scales * k.plane_groups;
  k.k_ident = k.k_line + Fl / k.vl;
  k.k_trig = k.k_ident + (n_bands > 0 || k.c_zero > k.c_end ? 1 : 0);
  k.kinds = k.k_trig + 3 * ((n_bands + KP_TRIG_BANDS - 1) / KP_TRIG_BANDS);
  return true;
}

// Columns a row of the encode fills before its zero padding.
inline int kp_row_dim(const KpArgs& k) { return k.c_end; }

// x01 of one coordinate of a world point: clip(p / box + 0.5, 0, 1).
__device__ __forceinline__ float kp_unit(float p, float box) {
  return fminf(fmaxf(__fadd_rn(__fdiv_rn(p, box), 0.5f), 0.0f), 1.0f);
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

// Features [f0, f0 + V) of scale s of row q, to column s * F + f0.
template <int V, class Out>
__device__ __forceinline__ void kp_plane_group(const KpArgs& k, int s, int f0,
                                               const float (&x01)[3],
                                               const Out& out, int q) {
  const int R = k.res[s], F = k.F;
  Hat h[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) h[d] = hat(x01[d], R);
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
  storev<V>(out.at(q, s * F + f0), prod);
}

// Line features [f0, f0 + V) of row q, to column c_line + f0.
template <int V, class Out>
__device__ __forceinline__ void kp_line_group(const KpArgs& k, int f0,
                                              const float (&x01)[3],
                                              const Out& out, int q) {
  const int Fl = k.Fl;
  Hat h[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) h[d] = hat(x01[d], k.L);
  float prod[V];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float v[V];
    lerpv<V>(v, k.line[d] + size_t(h[d].i0) * Fl + f0,
             k.line[d] + size_t(h[d].i0 + 1) * Fl + f0, h[d].w0, h[d].w1);
#pragma unroll
    for (int e = 0; e < V; ++e) prod[e] = d == 0 ? v[e] : __fmul_rn(prod[e], v[e]);
  }
  storev<V>(out.at(q, k.c_line + f0), prod);
}

// The group width V of a task, a template argument: VF (VL) when the
// caller fixes it (k.vf == VF), else chosen from k.vf (k.vl) at run time.
template <int VF, class Out>
__device__ __forceinline__ void kp_plane_any(const KpArgs& k, int s, int g,
                                             const float (&x01)[3], const Out& out,
                                             int q) {
  if constexpr (VF > 0) {
    kp_plane_group<VF>(k, s, VF * g, x01, out, q);
  } else {
    switch (k.vf) {
      case 8: kp_plane_group<8>(k, s, 8 * g, x01, out, q); break;
      case 4: kp_plane_group<4>(k, s, 4 * g, x01, out, q); break;
      case 2: kp_plane_group<2>(k, s, 2 * g, x01, out, q); break;
      default: kp_plane_group<1>(k, s, g, x01, out, q); break;
    }
  }
}
template <int VL, class Out>
__device__ __forceinline__ void kp_line_any(const KpArgs& k, int g,
                                            const float (&x01)[3], const Out& out,
                                            int q) {
  if constexpr (VL > 0) {
    kp_line_group<VL>(k, VL * g, x01, out, q);
  } else {
    switch (k.vl) {
      case 8: kp_line_group<8>(k, 8 * g, x01, out, q); break;
      case 4: kp_line_group<4>(k, 4 * g, x01, out, q); break;
      case 2: kp_line_group<2>(k, 2 * g, x01, out, q); break;
      default: kp_line_group<1>(k, g, x01, out, q); break;
    }
  }
}

__device__ __forceinline__ float kp_centered(float x01) {
  return __fsub_rn(__fmul_rn(x01, 2.0f), 1.0f);
}

// Encode rows [0, n_rows) of a tile of KP_ROWS rows from their x01 (KP_ROWS
// x 3 fp32 in shared memory, kp_unit) into columns [0, c_zero) through the
// accessor out: the work list of KpArgs, task t = kind * KP_ROWS + row, taken
// by the nthreads threads of the tile (a multiple of 32), thread tid, from
// task tid in steps of nthreads. The caller synchronises after it and writes
// the zeros of [c_zero, EP). k is the kernel's __grid_constant__ parameter,
// indexed in place. VF and VL fix the plane and line group widths (they
// must equal k.vf and k.vl), so that an instantiation holds one width's
// code; 0 takes them from k.
template <int VF = 0, int VL = 0, class Out>
__device__ __forceinline__ void kplanes_encode_rows(const KpArgs& k, const float* x01s,
                                                   int n_rows, int tid, int nthreads,
                                                   const Out& out) {
  static_assert(KP_ROWS == 64, "task decoding assumes 64-row tiles");
  const int n_tasks = k.kinds * KP_ROWS;
  for (int task = tid; task < n_tasks; task += nthreads) {
    const int kind = task >> 6, q = task & (KP_ROWS - 1);
    if (q >= n_rows) continue;
    if (kind >= k.k_trig) {
      // bands [b0, b0 + KP_TRIG_BANDS) of coordinate c: each argument f u
      // once, its sine and cosine into their two columns
      const int j = kind - k.k_trig, b0 = j / 3 * KP_TRIG_BANDS, c = j % 3;
      const float u = kp_centered(x01s[q * 3 + c]);
#pragma unroll
      for (int i = 0; i < KP_TRIG_BANDS; ++i) {
        const int b = b0 + i;
        if (b >= k.n_bands) break;
        float sv, cv;
        sincosf(__fmul_rn(u, k.bands[b]), &sv, &cv);
        const int col = k.c_hyb + 3 + 3 * b + c;
        *out.at(q, col) = __float2bfloat16_rn(sv);
        *out.at(q, col + 3 * k.n_bands) = __float2bfloat16_rn(cv);
      }
      continue;
    }
    const float x01[3] = {x01s[q * 3], x01s[q * 3 + 1], x01s[q * 3 + 2]};
    if (kind < k.k_line) {
      int s = 0, g = kind;
      while (g >= k.plane_groups) {
        g -= k.plane_groups;
        ++s;
      }
      kp_plane_any<VF>(k, s, g, x01, out, q);
    } else if (kind < k.k_ident) {
      kp_line_any<VL>(k, kind - k.k_line, x01, out, q);
    } else {
      // the identity columns, then zeros up to the first 8-aligned column
      int c = k.c_hyb;
      if (k.n_bands > 0)
        for (int d = 0; d < 3; ++d, ++c) *out.at(q, c) = __float2bfloat16_rn(kp_centered(x01[d]));
      for (c = k.c_end; c < k.c_zero; ++c) *out.at(q, c) = __float2bfloat16_rn(0.0f);
    }
  }
}

}  // namespace nerf
