// K5: the matrix-product precision probe. out = a @ b (fp32 in, fp32 out) in
// one of four modes, so that the error each mode makes against an fp64
// oracle can be read on the card:
//  * bf16:   inputs rounded to bf16 (nearest even), wmma m16n16k16 with fp32
//            accumulation: the analogue of a one-pass default-precision dot;
//  * tf32:   wmma m16n16k8 tf32, inputs converted with __float_to_tf32
//            (cvt.rna: nearest, ties away) rather than truncated by the
//            fragment: what an fp32 product becomes when TF32 is allowed;
//  * bf16x3: both operands split into bf16 hi + lo limbs, three passes
//            hi.hi + hi.lo + lo.hi into one fp32 accumulator (the lo.lo term
//            dropped): the analogue of the TPU's _dotx(split="both");
//  * fp32:   fmaf on the CUDA cores in k order: the analogue of HIGHEST.
//
// Replaces the TPU kernel scripts/probe_mosaic_precision.py:_dot_kernel (its
// pl.pallas_call in run, at default / HIGH / HIGHEST precision). The probe's
// shapes are small ((256,8)x(8,128), (256,128)x(128,128), (16,16)x(16,128)),
// so a launch is bound by its own latency, not by bytes or operations;
// the design is the plainest correct one: one warp per 16x16 output tile,
// both 16x16 input tiles staged in shared memory per k step with the ragged
// edge and K padded with zeros (exact), the wmma accumulator stored through
// a shared tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

enum Mode { MODE_BF16 = 0, MODE_TF32 = 1, MODE_BF16X3 = 2, MODE_FP32 = 3 };
constexpr int T = 16;   // output tile edge and k step

template <int MODE>
__global__ void __launch_bounds__(32)
precision_dot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(128) float as[T * T], bs[T * T], cs[T * T];
  __shared__ __align__(128) bf16 ah[T * T], al[T * T], bh[T * T], bl[T * T];
  const int lane = threadIdx.x, m0 = blockIdx.y * T, n0 = blockIdx.x * T;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc8;
  wmma::fill_fragment(acc, 0.0f);
  wmma::fill_fragment(acc8, 0.0f);
  const int fr = lane >> 1, fc = (lane & 1) * 8;   // fp32 mode: 8 outputs a lane
  float facc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  for (int k0 = 0; k0 < K; k0 += T) {
    for (int i = lane; i < T * T; i += 32) {
      const int r = i / T, c = i % T;
      const float va = (m0 + r < M && k0 + c < K) ? a[size_t(m0 + r) * K + k0 + c] : 0.0f;
      const float vb = (k0 + r < K && n0 + c < N) ? b[size_t(k0 + r) * N + n0 + c] : 0.0f;
      as[i] = va;
      bs[i] = vb;
      const bf16 ha = __float2bfloat16_rn(va), hb = __float2bfloat16_rn(vb);
      ah[i] = ha;
      bh[i] = hb;
      al[i] = __float2bfloat16_rn(va - __bfloat162float(ha));
      bl[i] = __float2bfloat16_rn(vb - __bfloat162float(hb));
    }
    __syncwarp();
    if (MODE == MODE_BF16 || MODE == MODE_BF16X3) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, ah, T);
      wmma::load_matrix_sync(fb, bh, T);
      wmma::mma_sync(acc, fa, fb, acc);
      if (MODE == MODE_BF16X3) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fbl;
        wmma::load_matrix_sync(fbl, bl, T);
        wmma::mma_sync(acc, fa, fbl, acc);
        wmma::load_matrix_sync(fa, al, T);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    } else if (MODE == MODE_TF32) {
      for (int kk = 0; kk < T; kk += 8) {
        wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, as + kk, T);
        wmma::load_matrix_sync(fb, bs + kk * T, T);
        for (int t = 0; t < fa.num_elements; ++t) fa.x[t] = wmma::__float_to_tf32(fa.x[t]);
        for (int t = 0; t < fb.num_elements; ++t) fb.x[t] = wmma::__float_to_tf32(fb.x[t]);
        wmma::mma_sync(acc8, fa, fb, acc8);
      }
    } else {
      for (int k = 0; k < T; ++k) {
        const float x = as[fr * T + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) facc[j] = fmaf(x, bs[k * T + fc + j], facc[j]);
      }
    }
    __syncwarp();
  }

  if (MODE == MODE_FP32) {
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[fr * T + fc + j] = facc[j];
  } else if (MODE == MODE_TF32) {
    wmma::store_matrix_sync(cs, acc8, T, wmma::mem_row_major);
  } else {
    wmma::store_matrix_sync(cs, acc, T, wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < T * T; i += 32) {
    const int r = i / T, c = i % T;
    if (m0 + r < M && n0 + c < N) out[size_t(m0 + r) * N + n0 + c] = cs[i];
  }
}

template <int MODE>
int launch(const float* a, const float* b, float* out, int M, int K, int N,
           cudaStream_t stream) {
  const dim3 grid((N + T - 1) / T, (M + T - 1) / T);
  precision_dot_kernel<MODE><<<grid, 32, 0, stream>>>(a, b, out, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K), b (K, N), out (M, N): fp32, row-major, on the card. mode: 0 bf16,
// 1 tf32, 2 bf16x3, 3 fp32. Returns a CUDA error code (0 on success).
extern "C" int nerf_precision_dot(const void* a, const void* b, void* out,
                                  int M, int K, int N, int mode, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (M + T - 1) / T > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
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
