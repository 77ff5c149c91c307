// The NeRF skip MLP over tiles of sample rows, for Hopper: the pieces that
// the K1 (fused_mlp.cu) and K2 (fused_raymarch.cu) kernels are built from.
//
// Replaces the body of the TPU kernel nerf_sandbox_tpu/ops/fused_mlp.py:_kernel
// (pl.pallas_call at :188) with the same rounding points: bf16 operands, fp32
// accumulation, an fp32 add of the bf16 bias, relu, then a cast to bf16
// between layers; the skip layer as h@W_h + enc@W_e; sigma from the bf16 last
// trunk activation (the TPU's column H of the feature matmul); the feature
// cast to bf16 before the colour head on [feature, enc_dir].
//
// Bound on the H100: 1.19 MFLOP of bf16 work per row at the vanilla widths
// (8x256, skip 4) against ~180 bytes of HBM traffic, so the tensor cores set
// the bound (989 TFLOP/s dense bf16): 1.258 ms per 2^20 rows. The ~1.2 MB of
// weights are read again for every tile of rows, from L2: per tile of R rows
// that stream must come at 989e12 / R bytes/s for the tensor cores to run at
// peak (7.7 TB/s at R = 128). A call of Q rows pulls ceil(Q / 128) x the
// stream (1.196 MB at 8x256): 9.8 GB for 2^20 rows, ~4 TB/s at the time K1
// takes on an H100 80GB HBM3, and K1 takes that time within 1% with the
// copies removed (probe_weight_stream.py, PERF.md), so the stream is not
// what holds the tile back and blocks are not paired for TMA multicast.
//
// Design (a block of N_THREADS = 384 threads, one block per SM, persistent):
//  * two consumer warpgroups own 64 rows each, so every weight stage in shared
//    memory feeds R = TILE_M = 128 rows; they run wgmma m64nNk16 (N = H, or
//    H/2 for the colour head) with fp32 accumulators in registers;
//  * one producer warp (the first of a third warpgroup, whose other three
//    warps only hand their registers back) streams the weights through a
//    ring of NS stages (up to 8; 5 at H = 256, 8 at H = 128: as many as
//    shared memory holds), each a 64 (K) x N slice, transposed and 128-byte
//    swizzled on the host
//    (ops/fused_mlp.py:stage_weights) so that a stage is one contiguous
//    cp.async.bulk, completed on the stage's "full" mbarrier; every consumer
//    warp arrives on the stage's "empty" mbarrier once its wgmmas have read
//    it. The stream is the same sequence of chunks for every pass of the MLP,
//    so the producer cycles through it without knowing the tiles, and keeps
//    loading the next pass's first chunks while the consumers finish a pass;
//  * activations never leave registers between hidden layers: the epilogue
//    (bias, relu, bf16 cast) runs on the accumulator in wgmma's documented
//    layout, and two neighbouring 8-column groups of the result are exactly
//    the A fragment of the next layer's k16 step, so A comes from registers
//    (as FlashAttention-3 feeds P to its PV product). Only the encoded inputs
//    (enc, read by layer 0 and the skip layer; enc_dir, read by the colour
//    head) sit in shared memory, in the same swizzled K-major layout, and are
//    read by wgmma through descriptors;
//  * sigma and rgb are row dot products of bf16 activations held by the four
//    lanes of a quad, reduced with two shuffles;
//  * registers: the compiler gives every thread 168 (65536 / 384); setmaxnreg
//    then takes the producer warpgroup down to PRODUCER_REGS and gives each
//    consumer thread CONSUMER_REGS (its 64 x 256 fp32 accumulator is 128
//    registers, the packed activations 64). The roles are read through a
//    warp shuffle so that the compiler sees them warp-uniform and keeps the
//    wgmmas asynchronous.
//
// Hidden widths 384 and 512 (the wide path): a 64 x H accumulator would need
// H/2 registers a thread, more than CONSUMER_REGS leaves, so each consumer
// warpgroup keeps its 64 x H bf16 activations in shared memory (act,
// swizzled like enc, 64 KiB at H = 512) and every layer reads its A operand
// from there through descriptors. A
// layer runs in chunks of NCW = 32 output columns: a 64 x 32 fp32
// accumulator (16 registers); the chunk's bias/relu/bf16 epilogue keeps its
// packed result in registers (8 a chunk, up to 16 chunks held: 128
// registers at H = 512); after the layer's last wgmma every chunk is written
// back over act in place, then fence_async_smem and the warpgroup's own
// barrier (act is the warpgroup's own, so no block-wide barrier). The
// weights stream as 64 (K) x 32 (N) stages of 4 KiB, in (layer, n-chunk,
// k-chunk) order (stage_weights), so the ring holds up to 8 stages beside
// 2 x 64 KiB of activations. Sigma and the colour head read the held chunks.
// With 64-column chunks (a 32-register accumulator) the H = 512 builds
// spilled a few registers and K1's serialized its wgmmas; 32 leaves room.
// The H = 128 / 256 path does not share this code: the wide path is selected
// at compile time (H > 256), one instantiation per width.
//
// Hidden widths above 512 (the large route; any multiple of 128, H a run-time
// value, one instantiation for all): neither the 64 x H activations of both
// warpgroups (2 x 128 KiB at H = 1024) nor a layer's held output (H / 4
// registers a thread) fits, so each consumer warpgroup keeps its activations
// in a ping-pong pair of 64 x H bf16 buffers in global memory (LargeMlpArgs::
// scratch, allocated by the caller per persistent block; they stay mostly in
// L2), in the swizzled layout of act, where a 64-column slice is 8 KiB
// contiguous. Each layer runs in the wide path's 32-column output chunks on
// the same weight stream; a chunk copies its A operand from the layer's input
// buffer, one 64 x 64 slice at a time, into one of two shared slots (the
// next slice's loads are in flight while the current slice's wgmmas run), then
// fence_async_smem and the warpgroup's barrier before the wgmmas read it.
// The chunk's epilogue goes to the other buffer; sigma and the colour head
// are reduced from the epilogue's registers as the wide path does. Biases and
// head vectors are read from global memory, so shared memory does not grow
// with H. No speed aim: every chunk reads the whole 64 x H input from L2.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace nerf {

constexpr int WG_ROWS = 64;                          // rows of one consumer warpgroup
constexpr int N_CONSUMERS = 2;                       // consumer warpgroups
constexpr int TILE_M = WG_ROWS * N_CONSUMERS;        // R: rows per weight fetch
constexpr int WG_THREADS = 128;
constexpr int N_CONSUMER_THREADS = N_CONSUMERS * WG_THREADS;
constexpr int N_THREADS = N_CONSUMER_THREADS + WG_THREADS;   // + the producer's
constexpr int KC = 64;                               // K rows of a weight stage
constexpr int A_CHUNK_BYTES = WG_ROWS * KC * 2;      // a 64x64 bf16 A block
constexpr int MAX_STAGES = 8;
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
constexpr size_t SMEM_LIMIT = 232448;                // per block, after opt-in
constexpr int BAR_CONSUMERS = 3;                     // ids 1, 2: one per warpgroup

// The wide path (H = 384 or 512): the output columns of one chunk of a
// layer, and the weight stage of one chunk.
constexpr int NCW = 32;
constexpr uint32_t WIDE_STAGE_BYTES = uint32_t(KC) * NCW * 2;

// Where a layer's activations live: registers (H = 128, 256), shared memory
// (the wide path, 384, 512) or global scratch (the large route, above 512).
enum MlpRoute { ROUTE_REGS = 0, ROUTE_WIDE = 1, ROUTE_LARGE = 2 };

// The route of a kernel instantiated for hidden width H; H = 0 instantiates
// the large route, whose width is a run-time value.
__host__ __device__ constexpr int route_of(int H) {
  return H == 0 ? ROUTE_LARGE : H > 256 ? ROUTE_WIDE : ROUTE_REGS;
}

// Bytes of one weight stage: 64 K rows of the whole width H, or of NCW
// columns on the wide path.
__host__ __device__ inline uint32_t stage_bytes(int H, bool wide) {
  return wide ? WIDE_STAGE_BYTES : uint32_t(KC) * H * 2;
}

// Packed weight arrays, in the order of PACK_FIELDS in ops/fused_mlp.py;
// the host passes each array's element offset into one bf16 buffer.
enum PackField {
  W0, B0, W_MID, B_MID, WSKIP_H, WSKIP_E, BSKIP, W_FEAT, B_FEAT, W_SIG, B_SIG,
  WC1, BC1, WC2T, BC2, N_FIELDS
};

struct MlpArgs {
  const bf16* p[N_FIELDS];
  const bf16* staged;   // the weight stream, in the order the stages use it
  int H, EP, ED, EDP;   // EDP: ED rounded up to KC
  int n_layers, skip_pos, NS;
};

// The large route's arguments: the MLP's, and its activation scratch, 2 x 64
// x H bf16 for each consumer warpgroup of at most scratch_blocks blocks. A
// type of its own, so that the other routes' kernels keep their parameters.
struct LargeMlpArgs : MlpArgs {
  bf16* scratch;
  int scratch_blocks;
};

// The arguments of a kernel instantiated for hidden width H (0: large route).
template <int H>
using MlpArgsOf = std::conditional_t<H == 0, LargeMlpArgs, MlpArgs>;

// Element offsets of the small vectors copied into shared memory.
struct PrmOffsets {
  int b0, b_mid, bskip, b_feat, w_sig, bc1, wc2t, b_sig, bc2, total;
};

__host__ __device__ inline PrmOffsets prm_offsets(int H, int n_layers) {
  PrmOffsets o;
  int x = 0;
  o.b0 = x;     x += H;
  o.b_mid = x;  x += (n_layers - 2) * H;
  o.bskip = x;  x += H;
  o.b_feat = x; x += H;
  o.w_sig = x;  x += H;
  o.bc1 = x;    x += H / 2;
  o.wc2t = x;   x += 3 * (H / 2);
  o.b_sig = x;  x += 8;
  o.bc2 = x;    x += 8;
  o.total = x;
  return o;
}

// Byte offsets from the 1024-byte aligned base of dynamic shared memory. The
// stages and the A blocks are multiples of 1024 bytes (the 128-byte swizzle
// repeats every 8 rows of 128 bytes); `extra` is the calling kernel's own.
struct MlpLayout {
  size_t ring, enc[N_CONSUMERS], ed[N_CONSUMERS], out[N_CONSUMERS], act[N_CONSUMERS];
  size_t prm, bars, extra, total;
  __host__ __device__ MlpLayout(int H, int EP, int EDP, int n_layers, int NS,
                                size_t extra_bytes, int route) {
    const bool wide = route != ROUTE_REGS;
    size_t o = 0;
    ring = o;   o += NS * size_t(stage_bytes(H, wide));
    for (int w = 0; w < N_CONSUMERS; ++w) { enc[w] = o; o += (EP / KC) * A_CHUNK_BYTES; }
    for (int w = 0; w < N_CONSUMERS; ++w) { ed[w] = o; o += (EDP / KC) * A_CHUNK_BYTES; }
    for (int w = 0; w < N_CONSUMERS; ++w) { out[w] = o; o += WG_ROWS * 4 * sizeof(float); }
    for (int w = 0; w < N_CONSUMERS; ++w) {   // wide: 64 x H activations
      act[w] = o;                             // large: two 64 x 64 A slots
      if (route == ROUTE_WIDE) o += (H / KC) * A_CHUNK_BYTES;
      if (route == ROUTE_LARGE) o += 2 * A_CHUNK_BYTES;
    }
    prm = o;                                  // the large route reads global
    if (route != ROUTE_LARGE) o += ((prm_offsets(H, n_layers).total * 2 + 15) & ~size_t(15));
    bars = o;   o += (2 * MAX_STAGES + 2) * 8;
    extra = o;  o += extra_bytes;
    total = o + 1024;                       // room to align the base
  }
};

struct MlpSmem {
  uint32_t ring, bars;                      // shared-space addresses
  bf16* enc[N_CONSUMERS];
  bf16* ed[N_CONSUMERS];
  float* out[N_CONSUMERS];                  // per row: r, g, b logits, sigma logit
  bf16* act[N_CONSUMERS];                   // wide: the activations; large: A slots
  const bf16* prm;
  int* done;                                // set once the consumers are finished
  unsigned char* extra;
};

// ---- PTX helpers ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// A deadlock guard: no wait of these kernels lasts a second when they are
// right, so a wait that outlasts ~20 s of SM clock traps (an error the launch
// reports) instead of hanging the card.
constexpr long long WAIT_LIMIT_CYCLES = 40000000000LL;

// The consumers' wait. Its loop exits on a warp vote, a branch the compiler
// knows to be warp-uniform, so the wgmmas scheduled around it are not taken
// for divergent code (which would serialize them). It has no guard of its
// own: consumers that stall leave the producer waiting on a stage, and the
// producer's guard traps.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!__all_sync(0xffffffffu, mbar_try_wait(bar, parity))) {
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, completed on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Generic-proxy stores to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 128 threads of consumer warpgroup wg (barriers 1 and 2).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(WG_THREADS) : "memory");
}

// True on every consumer thread if v is true on any: a barrier of the 256
// consumer threads only, the producer does not take part.
__device__ __forceinline__ bool consumers_any(bool v) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred p, %2, %3, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r) : "r"(uint32_t(v)), "n"(BAR_CONSUMERS), "n"(N_CONSUMER_THREADS)
      : "memory");
  // the same on every lane; a shuffle tells the compiler so
  return __shfl_sync(0xffffffffu, r, 0) != 0;
}

// Keep the compiler from moving register reads or reuses across a wgmma wait.
template <int n>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int n>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// wgmma matrix descriptor of a K-major operand with the 128-byte swizzle:
// rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes apart. Adding 2 steps
// the start 32 bytes, i.e. one k16 slice.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// Element offset of (row r, column c) in a swizzled 64-row A buffer: column
// blocks of 64 are 64x64 bf16 tiles; 16-byte unit u of row r sits at u^(r%8).
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * (WG_ROWS * KC) + r * KC + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// relu then the bf16 cast of two values in one instruction (the same bits as
// fmaxf then the cast; a NaN stays NaN, as in torch.relu).
__device__ __forceinline__ uint32_t pack_bf16_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// ---- block set-up, producer, pipeline ----

// x, opaque to the compiler: values derived from it are computed where they
// are used and not carried across the role split, where every live register
// would have to fit the producer's PRODUCER_REGS.
__device__ __forceinline__ int launder(int x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

// The block's shared memory, carved from the layout of P (each role does
// this itself after the split).
template <int ROUTE>
__device__ inline MlpSmem mlp_carve(unsigned char* raw, const MlpArgs& P) {
  const MlpLayout L(launder(P.H), launder(P.EP), launder(P.EDP),
                    launder(P.n_layers), launder(P.NS), 0, ROUTE);
  const uint32_t a = launder(static_cast<int>(smem_addr(raw)));
  unsigned char* base = raw + ((1024 - (a & 1023)) & 1023);
  MlpSmem S;
  S.ring = smem_addr(base + L.ring);
  S.bars = smem_addr(base + L.bars);
  for (int w = 0; w < N_CONSUMERS; ++w) {
    S.enc[w] = reinterpret_cast<bf16*>(base + L.enc[w]);
    S.ed[w] = reinterpret_cast<bf16*>(base + L.ed[w]);
    S.out[w] = reinterpret_cast<float*>(base + L.out[w]);
    S.act[w] = reinterpret_cast<bf16*>(base + L.act[w]);
  }
  bf16* prm = reinterpret_cast<bf16*>(base + L.prm);
  S.prm = prm;
  S.done = reinterpret_cast<int*>(base + L.bars + 2 * MAX_STAGES * 8);
  S.extra = base + L.extra;
  return S;
}

// Called by all N_THREADS threads first: copies the biases and the sigma /
// rgb head vectors to shared memory (not on the large route, which reads
// them from global memory), initialises the barriers.
template <int ROUTE>
__device__ inline void mlp_setup(unsigned char* raw, const MlpArgs& P) {
  const MlpSmem S = mlp_carve<ROUTE>(raw, P);
  if constexpr (ROUTE == ROUTE_LARGE) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < MAX_STAGES; ++s) {
        mbar_init(S.bars + 8 * s, 1);                                // full
        mbar_init(S.bars + 8 * (MAX_STAGES + s), N_CONSUMER_THREADS / 32);  // empty
      }
      *S.done = 0;
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    return;
  }
  bf16* prm = const_cast<bf16*>(S.prm);
  const int H = P.H, tid = threadIdx.x;
  const PrmOffsets o = prm_offsets(H, P.n_layers);
  for (int i = tid; i < H; i += N_THREADS) {
    prm[o.b0 + i] = P.p[B0][i];
    prm[o.bskip + i] = P.p[BSKIP][i];
    prm[o.b_feat + i] = P.p[B_FEAT][i];
    prm[o.w_sig + i] = P.p[W_SIG][i];
  }
  for (int i = tid; i < (P.n_layers - 2) * H; i += N_THREADS)
    prm[o.b_mid + i] = P.p[B_MID][i];
  for (int i = tid; i < H / 2; i += N_THREADS) prm[o.bc1 + i] = P.p[BC1][i];
  for (int i = tid; i < 3 * (H / 2); i += N_THREADS) prm[o.wc2t + i] = P.p[WC2T][i];
  if (tid < 3) prm[o.bc2 + tid] = P.p[BC2][tid];
  if (tid == 0) {
    prm[o.b_sig] = P.p[B_SIG][0];
    for (int s = 0; s < MAX_STAGES; ++s) {
      mbar_init(S.bars + 8 * s, 1);                                // full
      mbar_init(S.bars + 8 * (MAX_STAGES + s), N_CONSUMER_THREADS / 32);  // empty
    }
    *S.done = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Chunks of the weight stream: the trunk's (64 x H each: W0, then per layer
// W_mid or W_skip_h + W_skip_e, then W_feat), then the colour head's
// (64 x H/2: W_c1's feature rows, then its enc_dir rows padded to EDP).
__host__ __device__ inline int trunk_chunks(int H, int EP, int n_layers) {
  return 2 * (EP / KC) + n_layers * (H / KC);
}
__host__ __device__ inline int stream_chunks(int H, int EP, int EDP, int n_layers) {
  return trunk_chunks(H, EP, n_layers) + H / KC + EDP / KC;
}
// The wide path's stream: the same weights in 64 x NCW stages, each trunk
// array cut into H / NCW column chunks and the colour head's into H / 2 / NCW.
__host__ __device__ inline int wide_stream_chunks(int H, int EP, int EDP, int n_layers) {
  return (H / NCW) * trunk_chunks(H, EP, n_layers) + (H / 2 / NCW) * ((H + EDP) / KC);
}

// The producer warpgroup: one thread refills each stage as soon as all
// consumer warps have released it, cycling through the stream, until the
// consumers are done; the other threads leave.
template <int ROUTE>
__device__ inline void mlp_produce(unsigned char* raw, const MlpArgs& P) {
  constexpr bool WIDE = ROUTE != ROUTE_REGS;   // the large route streams as the wide
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
  if (threadIdx.x != N_CONSUMER_THREADS) return;
  const MlpSmem S = mlp_carve<ROUTE>(raw, P);
  const int n_trunk = WIDE ? 0 : trunk_chunks(P.H, P.EP, P.n_layers);
  const int n_chunks = WIDE ? wide_stream_chunks(P.H, P.EP, P.EDP, P.n_layers)
                                 : stream_chunks(P.H, P.EP, P.EDP, P.n_layers);
  const uint32_t tbytes = WIDE ? WIDE_STAGE_BYTES : uint32_t(KC) * P.H * 2;
  const uint32_t cbytes = WIDE ? WIDE_STAGE_BYTES : tbytes / 2;
  const char* src = reinterpret_cast<const char*>(P.staged);
  volatile int* done = S.done;
  int c = 0, s = 0;
  uint32_t off = 0, ph = 0;
  for (;;) {
    const uint32_t empty = S.bars + 8 * (MAX_STAGES + s);
    if (!mbar_try_wait(empty, ph ^ 1)) {
      const long long t0 = clock64();
      while (!mbar_try_wait(empty, ph ^ 1)) {
        if (*done) return;
        if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
      }
    }
    const uint32_t bytes = c < n_trunk ? tbytes : cbytes;
    const uint32_t full = S.bars + 8 * s;
    mbar_expect_tx(full, bytes);
    bulk_load(S.ring + s * tbytes, src + off, bytes, full);
    off += bytes;
    if (++c == n_chunks) { c = 0; off = 0; }
    if (++s == P.NS) { s = 0; ph ^= 1; }
  }
}

// The thread's warpgroup, warp-uniform as far as the compiler can tell.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
}

// A consumer's view of the ring: the next stage to take and its phase.
struct Pipe {
  uint32_t ring, bars, sbytes;
  int NS, s;
  uint32_t ph;
  __device__ Pipe(const MlpSmem& S, const MlpArgs& P, bool wide)
      : ring(S.ring), bars(S.bars), sbytes(stage_bytes(P.H, wide)), NS(P.NS),
        s(0), ph(0) {}
  // Wait for the next stage; → its shared address (stage index in st).
  __device__ __forceinline__ uint32_t acquire(int& st) {
    mbar_wait(bars + 8 * s, ph);
    st = s;
    const uint32_t b = ring + s * sbytes;
    if (++s == NS) { s = 0; ph ^= 1; }
    return b;
  }
  // After this warp's wgmmas on stage st have completed: lane 0 arrives. A
  // predicated instruction, not a branch, so that the wgmmas around it stay
  // in warpgroup-uniform code.
  __device__ __forceinline__ void release(int st) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.eq.u32 p, %1, 0;\n"
        "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
        :: "r"(bars + 8 * (MAX_STAGES + st)), "r"(threadIdx.x & 31) : "memory");
  }
};

// Consumer thread 0, after its last pass: wait until the producer's last
// copies (the next NS stages) have landed, then let it stop.
__device__ inline void mlp_drain(const MlpSmem& S, Pipe& pipe) {
  if (threadIdx.x != 0) return;
  for (int i = 0; i < pipe.NS; ++i) {
    int st;
    pipe.acquire(st);
  }
  *reinterpret_cast<volatile int*>(S.done) = 1;
}

// ---- one warpgroup's 64 rows through the MLP ----

// acc (64 x N) = [h (64 x H, registers) if REG] @ W + A (64 x 64*n_smem,
// shared at a_smem) @ W', the weight chunks taken from the ring in order.
// acc and h point into the caller's register arrays (constant indices only).
template <int N, int H, bool REG>
__device__ __forceinline__ void mma_layer(float* acc, uint32_t* h, uint32_t a_smem,
                                          int n_smem, Pipe& P) {
  wgmma_fence();
  int prev = -1, scale = 0;
  if (REG) {
#pragma unroll
    for (int c = 0; c < H / KC; ++c) {
      int st;
      const uint64_t db = sdesc(P.acquire(st));
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        const int t = 4 * ((KC / 16) * c + kk);
        Wgmma<N>::rs(acc, h[t], h[t + 1], h[t + 2], h[t + 3], db + 2 * kk, scale);
        scale = 1;
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        P.release(prev);
      }
      prev = st;
    }
  }
  for (int c = 0; c < n_smem; ++c) {
    int st;
    const uint64_t db = sdesc(P.acquire(st));
    const uint64_t da = sdesc(a_smem + c * A_CHUNK_BYTES);
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      Wgmma<N>::ss(acc, da + 2 * kk, db + 2 * kk, scale);
      scale = 1;
    }
    wgmma_commit();
    if (REG || c > 0) {
      wgmma_wait<1>();
      P.release(prev);
    }
    prev = st;
  }
  wgmma_wait<0>();
  P.release(prev);
  fence_regs<N / 2>(acc);
  fence_regs<H / 4>(h);
}

// h = bf16(act(acc + bias)) in place of the next layer's A fragments: the
// accumulator's n8 group j holds (row r, cols 8j+2q, +1) in acc[4j], acc[4j+1]
// and (row r+8, same cols) in acc[4j+2], acc[4j+3] (r = 16*warp + lane/4,
// q = lane%4); h[4t..4t+3] is then the A fragment of k16 step t.
template <int N, bool RELU>
__device__ __forceinline__ void epilogue(const float* acc, uint32_t* h,
                                         const bf16* bias) {
  const int c2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + 8 * j + c2));
    const float y0 = acc[4 * j] + b.x, y1 = acc[4 * j + 1] + b.y;
    const float y2 = acc[4 * j + 2] + b.x, y3 = acc[4 * j + 3] + b.y;
    if (RELU) {
      h[2 * j] = pack_bf16_relu(y0, y1);
      h[2 * j + 1] = pack_bf16_relu(y2, y3);
    } else {
      h[2 * j] = pack_bf16(y0, y1);
      h[2 * j + 1] = pack_bf16(y2, y3);
    }
  }
}

// Rows r and r+8 of h (64 x N bf16, registers) dotted with w (N), fp32; the
// four lanes of a quad hold a row between them.
template <int N>
__device__ __forceinline__ void row_dots(const uint32_t* h, const bf16* w, float& s0,
                                         float& s1) {
  const int c2 = 2 * (threadIdx.x & 3);
  s0 = 0.0f;
  s1 = 0.0f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 ww =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + 8 * j + c2));
    const float2 a = unpack_bf16(h[2 * j]), b = unpack_bf16(h[2 * j + 1]);
    s0 = fmaf(a.y, ww.y, fmaf(a.x, ww.x, s0));
    s1 = fmaf(b.y, ww.y, fmaf(b.x, ww.x, s1));
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, m);
    s1 += __shfl_xor_sync(0xffffffffu, s1, m);
  }
}

// Warpgroup wg's 64 rows, whose encodings the caller has put in S.enc[wg] and
// S.ed[wg] (swizzled, then fence_async_smem and wg_sync), through the whole
// MLP: raw r, g, b and sigma logits to S.out[wg] (64 x 4). The caller
// synchronises the warpgroup before reading them.
template <int H>
__device__ __forceinline__ void mlp_pass(const MlpArgs& P, const MlpSmem& S, int wg,
                                         Pipe& pipe) {
  const PrmOffsets o = prm_offsets(H, P.n_layers);
  const bf16* prm = S.prm;
  const uint32_t enc = smem_addr(S.enc[wg]), ed = smem_addr(S.ed[wg]);
  const int ke = __shfl_sync(0xffffffffu, P.EP / KC, 0);
  const int kd = __shfl_sync(0xffffffffu, P.EDP / KC, 0);
  float acc[H / 2];
  uint32_t h[H / 4];
  mma_layer<H, H, false>(acc, h, enc, ke, pipe);
  epilogue<H, true>(acc, h, prm + o.b0);
  // One loop body for the mid layers and the skip layer (which adds the enc
  // chunks), its bounds read through shuffles: code the compiler can see is
  // warp-uniform, so that it keeps the wgmmas asynchronous.
  const int n_layers = __shfl_sync(0xffffffffu, P.n_layers, 0);
  const int skip = __shfl_sync(0xffffffffu, P.skip_pos, 0);
  for (int l = 1; l < n_layers; ++l) {
    const bool is_skip = l == skip;
    mma_layer<H, H, true>(acc, h, enc, is_skip ? ke : 0, pipe);
    epilogue<H, true>(acc, h, prm + (is_skip ? o.bskip : o.b_mid + H * (l - 1 - (l > skip))));
  }
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float* out = S.out[wg];
  {
    // sigma now, so that no register holds it through the last two layers
    float sg0, sg1;
    row_dots<H>(h, prm + o.w_sig, sg0, sg1);
    if ((lane & 3) == 0) {
      const float bs = __bfloat162float(prm[o.b_sig]);
      out[r * 4 + 3] = sg0 + bs;
      out[(r + 8) * 4 + 3] = sg1 + bs;
    }
  }
  mma_layer<H, H, true>(acc, h, 0, 0, pipe);            // feature, no activation
  epilogue<H, false>(acc, h, prm + o.b_feat);
  // the colour head (width H/2) in the first halves of the same registers
  mma_layer<H / 2, H, true>(acc, h, ed, kd, pipe);
  epilogue<H / 2, true>(acc, h, prm + o.bc1);
  float rgb[3][2];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    row_dots<H / 2>(h, prm + o.wc2t + c * (H / 2), rgb[c][0], rgb[c][1]);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float b = __bfloat162float(prm[o.bc2 + c]);
      out[r * 4 + c] = rgb[c][0] + b;
      out[(r + 8) * 4 + c] = rgb[c][1] + b;
    }
  }
}

// ---- the wide path: one warpgroup's 64 rows at H = 384 or 512 ----

// acc (64 x NCW) = A0 (64 x 64 n0, shared at a0) @ W + A1 (64 x 64 n1, shared
// at a1) @ W', the n0 + n1 weight stages of one output chunk taken from the
// ring in order (n0 + n1 >= 1, both warp-uniform).
__device__ __forceinline__ void mma_wide_chunk(float* acc, uint32_t a0, int n0,
                                               uint32_t a1, int n1, Pipe& P) {
  wgmma_fence();
  int prev = -1, scale = 0;
  for (int c = 0; c < n0; ++c) {
    int st;
    const uint64_t db = sdesc(P.acquire(st));
    const uint64_t da = sdesc(a0 + c * A_CHUNK_BYTES);
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      Wgmma<NCW>::ss(acc, da + 2 * kk, db + 2 * kk, scale);
      scale = 1;
    }
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      P.release(prev);
    }
    prev = st;
  }
  for (int c = 0; c < n1; ++c) {
    int st;
    const uint64_t db = sdesc(P.acquire(st));
    const uint64_t da = sdesc(a1 + c * A_CHUNK_BYTES);
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      Wgmma<NCW>::ss(acc, da + 2 * kk, db + 2 * kk, scale);
      scale = 1;
    }
    wgmma_commit();
    if (n0 > 0 || c > 0) {
      wgmma_wait<1>();
      P.release(prev);
    }
    prev = st;
  }
  wgmma_wait<0>();
  P.release(prev);
  fence_regs<NCW / 2>(acc);
}

// One wide layer: for each of the NCH output chunks c, held[c] =
// bf16(act(A @ W[:, chunk c] + bias)) in the epilogue's register layout.
template <bool RELU, int NCH>
__device__ __forceinline__ void wide_layer(uint32_t (&held)[NCH][NCW / 4], uint32_t a0,
                                           int n0, uint32_t a1, int n1,
                                           const bf16* bias, Pipe& P) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    float acc[NCW / 2];
    mma_wide_chunk(acc, a0, n0, a1, n1, P);
    epilogue<NCW, RELU>(acc, held[c], bias + NCW * c);
  }
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// The held chunks over the warpgroup's activations at shared address act
// (64 x H, swizzled), once every warp's wgmmas have read them; then visible
// to wgmma. Rows r and r + 8 share their swizzle: unit j of a chunk's 64
// columns sits at (j ^ (r % 8)) * 16 bytes in the row.
template <int NCH>
__device__ __forceinline__ void wide_store(uint32_t act,
                                           const uint32_t (&held)[NCH][NCW / 4], int wg) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2), c2 = 2 * (lane & 3);
  wg_sync(wg);
  const uint32_t base = uint32_t(launder(int(act) + 2 * (r * KC + c2)));
  const uint32_t rx = uint32_t(r & 7) << 4;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int j = 0; j < NCW / 8; ++j) {
      const uint32_t a = base + (NCW * c / KC) * A_CHUNK_BYTES +
                         ((uint32_t(NCW * c % KC / 8 + j) << 4) ^ rx);
      st_shared_b32(a, held[c][2 * j]);
      st_shared_b32(a + 8 * KC * 2, held[c][2 * j + 1]);
    }
  }
  fence_async_smem();
  wg_sync(wg);
}

// mlp_pass for hidden width H = NCH * NCW (384 or 512): the same layers,
// rounding points and outputs, with the activations in S.act[wg] and each
// layer in NCH chunks of NCW columns.
template <int NCH>
__device__ __forceinline__ void mlp_pass_wide(const MlpArgs& P, const MlpSmem& S,
                                              int wg, Pipe& pipe) {
  constexpr int H = NCH * NCW, kh = H / KC;
  const bf16* prm = S.prm;
  const uint32_t enc = smem_addr(S.enc[wg]), ed = smem_addr(S.ed[wg]);
  const uint32_t act = smem_addr(S.act[wg]);
  const int ke = __shfl_sync(0xffffffffu, P.EP / KC, 0);
  const int kd = __shfl_sync(0xffffffffu, P.EDP / KC, 0);
  const int n_layers = __shfl_sync(0xffffffffu, P.n_layers, 0);
  const int skip = __shfl_sync(0xffffffffu, P.skip_pos, 0);
  uint32_t held[NCH][NCW / 4];
  wide_layer<true, NCH>(held, enc, ke, 0, 0, prm + prm_offsets(H, n_layers).b0, pipe);
  wide_store<NCH>(act, held, wg);
  for (int l = 1; l < n_layers; ++l) {
    const bool is_skip = l == skip;
    const PrmOffsets o = prm_offsets(H, n_layers);
    wide_layer<true, NCH>(held, act, kh, enc, is_skip ? ke : 0,
                          prm + (is_skip ? o.bskip : o.b_mid + H * (l - 1 - (l > skip))),
                          pipe);
    wide_store<NCH>(act, held, wg);
  }
  const PrmOffsets o = prm_offsets(H, n_layers);
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float* out = S.out[wg];
  {
    // sigma from the last trunk activation, still held in registers
    float sg0 = 0.0f, sg1 = 0.0f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float a, b;
      row_dots<NCW>(held[c], prm + o.w_sig + NCW * c, a, b);
      sg0 += a;
      sg1 += b;
    }
    if ((lane & 3) == 0) {
      const float bs = __bfloat162float(prm[o.b_sig]);
      out[r * 4 + 3] = sg0 + bs;
      out[(r + 8) * 4 + 3] = sg1 + bs;
    }
  }
  wide_layer<false, NCH>(held, act, kh, 0, 0, prm + o.b_feat, pipe);  // feature
  wide_store<NCH>(act, held, wg);
  // the colour head (width H/2) on [feature, enc_dir], one chunk at a time
  float rgb[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int c = 0; c < NCH / 2; ++c) {
    float acc[NCW / 2];
    uint32_t hc[NCW / 4];
    mma_wide_chunk(acc, act, kh, ed, kd, pipe);
    epilogue<NCW, true>(acc, hc, prm + o.bc1 + NCW * c);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float a, b;
      row_dots<NCW>(hc, prm + o.wc2t + k * (H / 2) + NCW * c, a, b);
      rgb[k][0] += a;
      rgb[k][1] += b;
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float b = __bfloat162float(prm[o.bc2 + k]);
      out[r * 4 + k] = rgb[k][0] + b;
      out[(r + 8) * 4 + k] = rgb[k][1] + b;
    }
  }
}

// ---- the large route: one warpgroup's 64 rows at any H > 512 ----

// The calling thread's four 16-byte units of the 8 KiB slice at g (global).
// .cg: from L2, where the warpgroup's own stores of the last layer are.
__device__ __forceinline__ void load_slice(uint4 (&v)[4], const bf16* g) {
  const uint4* src = reinterpret_cast<const uint4*>(g) + threadIdx.x % WG_THREADS;
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __ldcg(src + WG_THREADS * i);
}

// ... into the shared slot at slot, in the same order (the slice is already
// in the swizzled layout).
__device__ __forceinline__ void store_slice(uint32_t slot, const uint4 (&v)[4]) {
  const uint32_t a = slot + 16 * (threadIdx.x % WG_THREADS);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(a + 16 * WG_THREADS * i), "r"(v[i].x), "r"(v[i].y),
                    "r"(v[i].z), "r"(v[i].w) : "memory");
}

// mma_wide_chunk with A0 in global memory: acc (64 x NCW) = A0 (64 x 64 n0,
// global at g0, 8 KiB a slice) @ W + A1 (64 x 64 n1, shared at a1) @ W'. The
// slices of A0 pass through the two A slots at slots (warp-uniform n0, n1;
// n0 + n1 >= 1).
__device__ __forceinline__ void mma_large_chunk(float* acc, const bf16* g0, int n0,
                                                uint32_t a1, int n1, uint32_t slots,
                                                int wg, Pipe& P) {
  uint4 v[4];
  if (n0 > 0) {
    load_slice(v, g0);
    wg_sync(wg);   // every warp's last wgmmas on the slots are done
    store_slice(slots, v);
    fence_async_smem();
    wg_sync(wg);
  }
  wgmma_fence();
  int prev = -1, scale = 0;
  for (int c = 0; c < n0; ++c) {
    int st;
    const uint64_t db = sdesc(P.acquire(st));
    if (c + 1 < n0) load_slice(v, g0 + (c + 1) * (WG_ROWS * KC));
    const uint64_t da = sdesc(slots + (c & 1) * A_CHUNK_BYTES);
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      Wgmma<NCW>::ss(acc, da + 2 * kk, db + 2 * kk, scale);
      scale = 1;
    }
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      P.release(prev);
    }
    prev = st;
    if (c + 1 < n0) {
      wg_sync(wg);   // every warp has waited out slice c - 1, the other slot's
      store_slice(slots + ((c + 1) & 1) * A_CHUNK_BYTES, v);
      fence_async_smem();
      wg_sync(wg);
    }
  }
  for (int c = 0; c < n1; ++c) {
    int st;
    const uint64_t db = sdesc(P.acquire(st));
    const uint64_t da = sdesc(a1 + c * A_CHUNK_BYTES);
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      Wgmma<NCW>::ss(acc, da + 2 * kk, db + 2 * kk, scale);
      scale = 1;
    }
    wgmma_commit();
    if (n0 > 0 || c > 0) {
      wgmma_wait<1>();
      P.release(prev);
    }
    prev = st;
  }
  wgmma_wait<0>();
  P.release(prev);
  fence_regs<NCW / 2>(acc);
}

// Chunk c of a layer's output (the epilogue's registers) into the 64 x H
// buffer g (global, swizzled as act; wide_store's addressing).
__device__ __forceinline__ void store_chunk_global(bf16* g, const uint32_t (&hc)[NCW / 4],
                                                   int c) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2), c2 = 2 * (lane & 3);
  bf16* row = g + (NCW * c / KC) * (WG_ROWS * KC) + r * KC + c2;
#pragma unroll
  for (int j = 0; j < NCW / 8; ++j) {
    const int u = ((NCW * c % KC / 8 + j) ^ (r & 7)) << 3;
    *reinterpret_cast<uint32_t*>(row + u) = hc[2 * j];
    *reinterpret_cast<uint32_t*>(row + 8 * KC + u) = hc[2 * j + 1];
  }
}

// mlp_pass for any hidden width H = P.H above 512 (a multiple of 128): the
// same layers, rounding points and outputs as mlp_pass_wide, with layer l
// reading its input from buffer (l + 1) % 2 of the warpgroup's scratch pair
// and writing buffer l % 2.
__device__ inline void mlp_pass_large(const LargeMlpArgs& P, const MlpSmem& S,
                                      int wg, Pipe& pipe) {
  const int H = __shfl_sync(0xffffffffu, P.H, 0);
  const int kh = H / KC, nch = H / NCW;
  const int ke = __shfl_sync(0xffffffffu, P.EP / KC, 0);
  const int kd = __shfl_sync(0xffffffffu, P.EDP / KC, 0);
  const int n_layers = __shfl_sync(0xffffffffu, P.n_layers, 0);
  const int skip = __shfl_sync(0xffffffffu, P.skip_pos, 0);
  const uint32_t enc = smem_addr(S.enc[wg]), ed = smem_addr(S.ed[wg]);
  const uint32_t slots = smem_addr(S.act[wg]);
  bf16* buf[2];
  buf[0] = P.scratch + size_t(blockIdx.x * N_CONSUMERS + wg) * 2 * WG_ROWS * H;
  buf[1] = buf[0] + size_t(WG_ROWS) * H;
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float sg0 = 0.0f, sg1 = 0.0f;
  // the trunk, then the feature layer (l = n_layers, no activation)
  for (int l = 0; l <= n_layers; ++l) {
    const bool first = l == 0, feat = l == n_layers;
    const bf16* bias = first ? P.p[B0]
                       : feat ? P.p[B_FEAT]
                       : l == skip ? P.p[BSKIP]
                                   : P.p[B_MID] + H * (l - 1 - (l > skip));
    const int n_enc = first || l == skip ? ke : 0;
    for (int c = 0; c < nch; ++c) {
      float acc[NCW / 2];
      uint32_t hc[NCW / 4];
      mma_large_chunk(acc, buf[(l + 1) & 1], first ? 0 : kh, enc, n_enc, slots, wg,
                      pipe);
      if (feat) {
        epilogue<NCW, false>(acc, hc, bias + NCW * c);
      } else {
        epilogue<NCW, true>(acc, hc, bias + NCW * c);
        if (l == n_layers - 1) {   // sigma from the last trunk activation
          float a, b;
          row_dots<NCW>(hc, P.p[W_SIG] + NCW * c, a, b);
          sg0 += a;
          sg1 += b;
        }
      }
      store_chunk_global(buf[l & 1], hc, c);
    }
    wg_sync(wg);   // the layer's output is in place before the next reads it
  }
  float* out = S.out[wg];
  if ((lane & 3) == 0) {
    const float bs = __bfloat162float(P.p[B_SIG][0]);
    out[r * 4 + 3] = sg0 + bs;
    out[(r + 8) * 4 + 3] = sg1 + bs;
  }
  // the colour head (width H/2) on [feature, enc_dir], one chunk at a time
  const bf16* feature = buf[n_layers & 1];
  float rgb[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int c = 0; c < nch / 2; ++c) {
    float acc[NCW / 2];
    uint32_t hc[NCW / 4];
    mma_large_chunk(acc, feature, kh, ed, kd, slots, wg, pipe);
    epilogue<NCW, true>(acc, hc, P.p[BC1] + NCW * c);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float a, b;
      row_dots<NCW>(hc, P.p[WC2T] + k * (H / 2) + NCW * c, a, b);
      rgb[k][0] += a;
      rgb[k][1] += b;
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float b = __bfloat162float(P.p[BC2][k]);
      out[r * 4 + k] = rgb[k][0] + b;
      out[(r + 8) * 4 + k] = rgb[k][1] + b;
    }
  }
}

// The pass of a kernel instantiated for hidden width H (0: the large route).
template <int H>
__device__ __forceinline__ void mlp_pass_any(const MlpArgs& P, const MlpSmem& S,
                                             int wg, Pipe& pipe) {
  if constexpr (H == 0)
    mlp_pass_large(static_cast<const LargeMlpArgs&>(P), S, wg, pipe);
  else if constexpr (H > 256)
    mlp_pass_wide<H / NCW>(P, S, wg, pipe);
  else
    mlp_pass<H>(P, S, wg, pipe);
}

// ---- host side ----

// The shapes the kernels take: hidden width 128 or 256 (one accumulator in
// registers), 384 or 512 (the wide path) or, with scratch, any multiple of
// 128 above 512 (the large route), EP a multiple of 64, ED of 16, one skip
// layer inside the trunk.
inline bool mlp_shape_ok(int H, int EP, int ED, int n_layers, int skip_pos,
                         bool scratch) {
  const bool h_ok = H > 512 ? scratch && H % 128 == 0
                            : H == 128 || H == 256 || H == 384 || H == 512;
  return h_ok && EP > 0 && EP % KC == 0 && ED > 0 && ED % 16 == 0 && n_layers >= 3 &&
         skip_pos > 0 && skip_pos < n_layers;
}

// The route of hidden width H at run time.
inline int mlp_route(int H) {
  return H > 512 ? ROUTE_LARGE : H > 256 ? ROUTE_WIDE : ROUTE_REGS;
}

inline MlpArgs make_mlp_args(const void* wpack, const long long* offsets,
                             const void* staged, int H, int EP, int ED,
                             int n_layers, int skip_pos) {
  MlpArgs a;
  const bf16* base = static_cast<const bf16*>(wpack);
  for (int i = 0; i < N_FIELDS; ++i) a.p[i] = base + offsets[i];
  a.staged = static_cast<const bf16*>(staged);
  a.H = H; a.EP = EP; a.ED = ED; a.EDP = (ED + KC - 1) / KC * KC;
  a.n_layers = n_layers; a.skip_pos = skip_pos; a.NS = 0;
  return a;
}

inline LargeMlpArgs make_large_args(const MlpArgs& a, void* scratch, int scratch_blocks) {
  LargeMlpArgs l;
  static_cast<MlpArgs&>(l) = a;
  l.scratch = static_cast<bf16*>(scratch);
  l.scratch_blocks = scratch_blocks;
  return l;
}

// The most weight stages (2..MAX_STAGES) that fit in shared memory beside
// the rest; → the block's dynamic shared memory, 0 if not even two fit.
inline size_t plan_stages(MlpArgs& a, size_t extra_bytes) {
  for (int ns = MAX_STAGES; ns >= 2; --ns) {
    const MlpLayout L(a.H, a.EP, a.EDP, a.n_layers, ns, extra_bytes, mlp_route(a.H));
    if (L.total <= SMEM_LIMIT) {
      a.NS = ns;
      return L.total;
    }
  }
  return 0;
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Persistent blocks for `units` tiles of work: one per SM at most, and on the
// large route no more than its scratch holds.
inline int grid_blocks(int units, const MlpArgs&) {
  return units < sm_count() ? units : sm_count();
}
inline int grid_blocks(int units, const LargeMlpArgs& P) {
  const int n = grid_blocks(units, static_cast<const MlpArgs&>(P));
  return n < P.scratch_blocks ? n : P.scratch_blocks;
}

// Set the kernel's shared memory and check that its register allocation
// leaves setmaxnreg room to hand the consumers CONSUMER_REGS (a block's pool
// is its threads x the registers the compiler gave each at entry): a
// setmaxnreg.inc the pool cannot serve would wait for ever.
template <class Kernel>
inline cudaError_t prepare_kernel(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const int per_thread = (fa.numRegs + 7) & ~7;
  if (per_thread * N_THREADS <
      CONSUMER_REGS * N_CONSUMER_THREADS + PRODUCER_REGS * WG_THREADS)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace nerf
