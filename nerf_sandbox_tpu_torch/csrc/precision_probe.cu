// K5: the matrix-product precision probe. out = a @ b (fp32 in, fp32 out) in
// one of four modes, so that the error each mode makes against an fp64
// oracle can be read on the card:
//  * bf16:   inputs rounded to bf16 (nearest even), mma.sync m16n8k16 with
//            fp32 accumulation: the analogue of a one-pass default-precision
//            dot;
//  * tf32:   mma.sync m16n8k8 tf32 on inputs converted with cvt.rna (nearest,
//            ties away) rather than truncated by the tensor cores, the even
//            and the odd k steps in two fp32 accumulators summed at the end:
//            what an fp32 product becomes when TF32 is allowed;
//  * bf16x3: both operands split into bf16 hi + lo limbs, three products
//            hi.hi, hi.lo and lo.hi, each into its own fp32 accumulator,
//            summed as hi.hi + (hi.lo + lo.hi) at the end (the lo.lo term
//            dropped): the analogue of the TPU's _dotx(split="both");
//  * fp32:   fmaf on the CUDA cores in k order: the analogue of HIGHEST.
//
// Replaces the TPU kernel scripts/probe_mosaic_precision.py:_dot_kernel (its
// pl.pallas_call in run, at default / HIGH / HIGHEST precision). The probe's
// shapes are small ((256,8)x(8,128), (256,128)x(128,128), (16,16)x(16,128)),
// so a launch is bound by latency, not by bytes or operations: the launch,
// the global loads, the syncs and the dependent steps. The design takes as
// few of each as it can:
//  * a block of 4 warps owns a 16 x 32 output tile in the tensor-core modes
//    (each warp one m16n8 tile: 64 blocks at 256 x 128) and a 16 x 16 tile
//    in fp32 mode, whose K-long fmaf chains are its critical path (128
//    blocks, 2 outputs a thread);
//  * one global round trip per block and K chunk (K <= 128 is one chunk,
//    every probe shape): every load of the block's A strip and B strip is
//    issued into registers before any is used (16-byte loads where the rows
//    are aligned, scalar loads on the ragged edge, zeros beyond it), then each
//    thread converts the values it loaded, once, for the mode that runs only
//    (bf16: hi limbs; bf16x3: hi and lo; tf32: cvt.rna; fp32: as they are),
//    stores them to shared memory in the layout the k loop reads (B
//    transposed in the bf16 modes, each thread packing the k pair of a
//    fragment word from two rows it loaded), and one __syncthreads follows;
//  * the k loop runs without a sync and fully unrolled: each thread reads its
//    mma fragments straight from shared memory (padded rows, no bank
//    conflicts on the fragment reads); bf16x3 keeps one accumulator per limb
//    product and tf32 one per k parity, summed at the end, so that no chain
//    of dependent mma.sync is longer than 8; fp32 keeps 2 fmaf chains in k
//    order;
//  * the accumulators are stored straight to global memory from the
//    documented m16n8 fragment layout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

enum Mode { MODE_BF16 = 0, MODE_TF32 = 1, MODE_BF16X3 = 2, MODE_FP32 = 3 };
constexpr int THREADS = 128;
constexpr int KCH = 128;                 // K of one chunk
constexpr int LDH = KCH + 8;             // bf16 row stride (A and transposed B)
constexpr int LDA = KCH + 4;             // fp32 A row stride

// The output tile of a block: 16 x 32 for the tensor-core modes (each warp
// one m16n8 tile; measured faster on every probe shape than 32 x 32 with
// each warp 16 x 16), 16 x 16 in fp32 mode, whose K-long fmaf chains are the
// critical path, so that the work spreads over twice the SMs.
template <int MODE>
struct Tile {
  static constexpr int M = 16, N = MODE == MODE_FP32 ? 16 : 32;
  static constexpr int LDB = N + 8;      // fp32 B row stride
  // the warps over the tile: WM x WN, each 16 rows x 8 NJ columns
  static constexpr int WM = M / 16, WN = 4 / WM, NJ = N / 8 / WN > 0 ? N / 8 / WN : 1;
};

// Shared memory of each mode: only what its k loop reads.
template <int MODE>
struct Smem {   // fp32 and tf32: A (M x K) and B (K x N) row-major
  float a[Tile<MODE>::M * LDA], b[KCH * Tile<MODE>::LDB];
};
template <>
struct Smem<MODE_BF16> {   // bf16 hi limbs, B transposed (N x K)
  bf16 ah[Tile<MODE_BF16>::M * LDH], bh[Tile<MODE_BF16>::N * LDH];
};
template <>
struct Smem<MODE_BF16X3> {
  bf16 ah[Tile<MODE_BF16X3>::M * LDH], bh[Tile<MODE_BF16X3>::N * LDH];
  bf16 al[Tile<MODE_BF16X3>::M * LDH], bl[Tile<MODE_BF16X3>::N * LDH];
};

// x rounded to tf32 as cvt.rna.tf32.f32 rounds it (nearest, ties away from
// zero; inf and NaN as they are), in integer operations: half an ulp of tf32
// added to the magnitude bits, the 13 low bits cleared. On the H100 the cvt
// instruction cost about 1 us a launch more at 64 conversions a thread.
__device__ __forceinline__ float tf32_rna(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float(((u >> 23) & 0xFF) == 0xFF ? u : (u + 0x1000u) & 0xFFFFE000u);
}

// bf16 limbs of x and y (x in the low half): hi, and in x3 mode lo.
__device__ __forceinline__ uint32_t pack_hi(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack_lo(float x, float y, uint32_t hi) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return pack_hi(x - h.x, y - h.y);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four values of row r, columns c..c+3 of p (rows x cols, row-major at
// stride ld), zero outside it: one 16-byte load when vec (rows 16-byte
// aligned) and the four are inside, else scalar loads.
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int rows,
                                        int cols, int ld, int r, int c, bool vec) {
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (r >= rows || c >= cols) return z;
  const float* q = p + size_t(r) * ld + c;
  if (vec && c + 3 < cols) return __ldg(reinterpret_cast<const float4*>(q));
  float4 v = z;
  v.x = __ldg(q);
  if (c + 1 < cols) v.y = __ldg(q + 1);
  if (c + 2 < cols) v.z = __ldg(q + 2);
  if (c + 3 < cols) v.w = __ldg(q + 3);
  return v;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
precision_dot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out, int M, int K, int N) {
  using T = Tile<MODE>;
  constexpr bool BF = MODE == MODE_BF16 || MODE == MODE_BF16X3;
  constexpr bool X3 = MODE == MODE_BF16X3;
  // A as (row, 4 columns) items: thread tid takes column group tid % AQ of
  // rows tid / AQ + AR i; B as (row, 4 columns) items in fp32 modes, as
  // (row pair, 4 columns) items in bf16 modes (so that the two k of a
  // fragment word come from one thread)
  constexpr int AQ = KCH / 4;                        // 4-column groups of an A row
  constexpr int AR = THREADS / AQ;                   // A rows a step covers
  constexpr int NA = T::M / AR;
  constexpr int BQ = T::N / 4;                       // 4-column groups of a B row
  constexpr int BR = THREADS / BQ;                   // B rows a step covers
  constexpr int NB = BF ? KCH / 2 / (THREADS / BQ) : KCH / BR;
  __shared__ __align__(16) Smem<MODE> s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * T::M, n0 = blockIdx.x * T::N;
  const int g = lane >> 2, t = lane & 3;                  // fragment row, column pair
  const int wm = (warp / T::WN) * 16, wn = (warp % T::WN) * 8 * T::NJ;
  const bool vec_a = (K & 3) == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool vec_b = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  // tensor-core modes: accumulators of the two n8 tiles, by limb product
  // (bf16x3: hi.hi, hi.lo, lo.hi) or by k parity (tf32), summed at the end
  float acc[3][T::NJ][4] = {};
  float facc[2] = {0.0f, 0.0f};
  const int fr = tid >> 3, fc = (tid & 7) * 2;            // fp32 mode: 2 outputs
  const int ca = (tid % AQ) * 4, ra = tid / AQ;            // A item columns, first row
  const int cb = (tid % BQ) * 4, rb = tid / BQ;            // B item columns, first row

  for (int k0 = 0; k0 < K; k0 += KCH) {
    const int kc = min(KCH, K - k0);
    const int kp = (kc + 15) & ~15;                        // zero-filled to k16 steps
    // the one global round trip: every load first
    float4 va[NA], vb[NB][BF ? 2 : 1];
#pragma unroll
    for (int i = 0; i < NA; ++i)
      va[i] = load4(a + k0, M, kc, K, m0 + ra + AR * i, ca, vec_a);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if constexpr (BF) {
        const int r = 2 * (rb + BR * i);
        vb[i][0] = load4(b + size_t(k0) * N + n0, kc, N - n0, N, r, cb, vec_b);
        vb[i][1] = load4(b + size_t(k0) * N + n0, kc, N - n0, N, r + 1, cb, vec_b);
      } else {
        vb[i][0] = load4(b + size_t(k0) * N + n0, kc, N - n0, N, rb + BR * i, cb,
                         vec_b);
      }
    }
    if (k0 > 0) __syncthreads();   // the last chunk's k loop is done with s
    // each value converted once, for this mode only, into the k loop's layout
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int r = ra + AR * i;
      if (ca >= kp) continue;
      const float4 v = va[i];
      if constexpr (BF) {
        const uint32_t h0 = pack_hi(v.x, v.y), h1 = pack_hi(v.z, v.w);
        *reinterpret_cast<uint2*>(&s.ah[r * LDH + ca]) = make_uint2(h0, h1);
        if constexpr (X3)
          *reinterpret_cast<uint2*>(&s.al[r * LDH + ca]) =
              make_uint2(pack_lo(v.x, v.y, h0), pack_lo(v.z, v.w, h1));
      } else if constexpr (MODE == MODE_TF32) {
        *reinterpret_cast<float4*>(&s.a[r * LDA + ca]) =
            make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
      } else {
        *reinterpret_cast<float4*>(&s.a[r * LDA + ca]) = v;
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if constexpr (BF) {
        const int p = rb + BR * i;                        // rows 2p, 2p + 1
        if (2 * p >= kp) continue;
        const float x0[4] = {vb[i][0].x, vb[i][0].y, vb[i][0].z, vb[i][0].w};
        const float x1[4] = {vb[i][1].x, vb[i][1].y, vb[i][1].z, vb[i][1].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = (cb + e) * LDH + 2 * p;
          const uint32_t h = pack_hi(x0[e], x1[e]);
          *reinterpret_cast<uint32_t*>(&s.bh[o]) = h;
          if constexpr (X3)
            *reinterpret_cast<uint32_t*>(&s.bl[o]) = pack_lo(x0[e], x1[e], h);
        }
      } else {
        const int r = rb + BR * i;
        if (r >= kp) continue;
        const float4 v = vb[i][0];
        *reinterpret_cast<float4*>(&s.b[r * T::LDB + cb]) =
            MODE == MODE_TF32 ? make_float4(tf32_rna(v.x), tf32_rna(v.y),
                                            tf32_rna(v.z), tf32_rna(v.w))
                              : v;
      }
    }
    __syncthreads();

    // the k loop: no sync, fragments read straight from shared memory
    if constexpr (MODE == MODE_FP32) {
      for (int kb = 0; kb < kp; kb += 16) {
#pragma unroll
        for (int k = kb; k < kb + 16; ++k) {   // zero padding adds exact zeros
          const float x = s.a[fr * LDA + k];
          const float2 y = *reinterpret_cast<const float2*>(&s.b[k * T::LDB + fc]);
          facc[0] = fmaf(x, y.x, facc[0]);
          facc[1] = fmaf(x, y.y, facc[1]);
        }
      }
    } else if constexpr (MODE == MODE_TF32) {
#pragma unroll
      for (int ks = 0; ks < KCH / 8; ++ks) {
        const int k = 8 * ks;
        if (k < kp) {
          const float* ar = s.a + (wm + g) * LDA + k + t;
          const uint32_t af[4] = {__float_as_uint(ar[0]), __float_as_uint(ar[8 * LDA]),
                                  __float_as_uint(ar[4]), __float_as_uint(ar[8 * LDA + 4])};
#pragma unroll
          for (int j = 0; j < T::NJ; ++j) {
            const float* br = s.b + (k + t) * T::LDB + wn + 8 * j + g;
            mma_tf32(acc[ks & 1][j], af, __float_as_uint(br[0]),
                     __float_as_uint(br[4 * T::LDB]));
          }
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < KCH / 16; ++ks) {
        const int k = 16 * ks;
        if (k < kp) {
          const int ao = (wm + g) * LDH + k + 2 * t;
          const uint32_t* ah = reinterpret_cast<const uint32_t*>(s.ah + ao);
          const uint32_t fh[4] = {ah[0], ah[4 * LDH], ah[4], ah[4 * LDH + 4]};
          uint32_t fl[4] = {0u, 0u, 0u, 0u};
          if constexpr (X3) {
            const uint32_t* al = reinterpret_cast<const uint32_t*>(s.al + ao);
            fl[0] = al[0]; fl[1] = al[4 * LDH]; fl[2] = al[4]; fl[3] = al[4 * LDH + 4];
          }
#pragma unroll
          for (int j = 0; j < T::NJ; ++j) {
            const int bo = (wn + 8 * j + g) * LDH + k + 2 * t;
            const uint32_t* bh = reinterpret_cast<const uint32_t*>(s.bh + bo);
            mma_bf16(acc[0][j], fh, bh[0], bh[4]);
            if constexpr (X3) {
              const uint32_t* bl = reinterpret_cast<const uint32_t*>(s.bl + bo);
              mma_bf16(acc[1][j], fh, bl[0], bl[4]);
              mma_bf16(acc[2][j], fl, bh[0], bh[4]);
            }
          }
        }
      }
    }
  }

  if constexpr (MODE == MODE_FP32) {
    const int r = m0 + fr, c = n0 + fc;
    if (r < M) {
      if (c < N) out[size_t(r) * N + c] = facc[0];
      if (c + 1 < N) out[size_t(r) * N + c + 1] = facc[1];
    }
  } else {
    // c0, c1 at (row g, columns 2t, 2t+1) of each m16n8 tile, c2, c3 at row g+8
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) {
      const int c = n0 + wn + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + g + 8 * h;
        if (r >= M) continue;
        float v0 = acc[0][j][2 * h], v1 = acc[0][j][2 * h + 1];
        if constexpr (X3) {
          v0 += acc[1][j][2 * h] + acc[2][j][2 * h];
          v1 += acc[1][j][2 * h + 1] + acc[2][j][2 * h + 1];
        } else if constexpr (MODE == MODE_TF32) {
          v0 += acc[1][j][2 * h];
          v1 += acc[1][j][2 * h + 1];
        }
        if (c < N) out[size_t(r) * N + c] = v0;
        if (c + 1 < N) out[size_t(r) * N + c + 1] = v1;
      }
    }
  }
}

template <int MODE>
int launch(const float* a, const float* b, float* out, int M, int K, int N,
           cudaStream_t stream) {
  using T = Tile<MODE>;
  const dim3 grid((N + T::N - 1) / T::N, (M + T::M - 1) / T::M);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  precision_dot_kernel<MODE><<<grid, THREADS, 0, stream>>>(a, b, out, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K), b (K, N), out (M, N): fp32, row-major, on the card. mode: 0 bf16,
// 1 tf32, 2 bf16x3, 3 fp32. Returns a CUDA error code (0 on success).
extern "C" int nerf_precision_dot(const void* a, const void* b, void* out,
                                  int M, int K, int N, int mode, void* stream) {
  if (M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_BF16: return launch<MODE_BF16>(pa, pb, po, M, K, N, st);
    case MODE_TF32: return launch<MODE_TF32>(pa, pb, po, M, K, N, st);
    case MODE_BF16X3: return launch<MODE_BF16X3>(pa, pb, po, M, K, N, st);
    case MODE_FP32: return launch<MODE_FP32>(pa, pb, po, M, K, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
