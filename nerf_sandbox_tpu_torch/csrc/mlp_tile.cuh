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
// warpgroup keeps its 64 x H bf16 activations in shared memory (act, swizzled
// like enc, 64 KiB at H = 512) and every layer reads its A operand from there
// through descriptors. A layer runs in output chunks of LNC = 256 columns,
// then a 128 tail (large_chunk: 512 = 256 + 256, 384 = 256 + 128; the colour
// head's 256, or 192 = 128 + 64), each into one 64 x 256 fp32 accumulator
// array (128 registers, the large route's; first product Wgmma::ss0), so act
// is read H / 128 times a layer where 32-column chunks read it H / 32 times.
// The weights stream as stages of 64 K rows x NCW = 128 columns (16 KiB; a
// 256-column chunk takes two per 64 K rows, one m64n128k16 product into each
// half of the accumulator; a 64-column tail fills the front of one), in
// (layer, chunk, array, K, half) order (stage_weights' wide stream). Each
// stage is committed as one wgmma group, and the consumers wait only for the
// group before it, so two stages' products are in flight. The first chunk's
// bias/relu/bf16 epilogue parks its result in registers (64 a thread, already
// transposed within each quad into 16-byte units); after the layer's last
// wgmma (and the warpgroup's barrier: every warp's products have read act) the
// parked chunk and the last chunk's epilogue go over act in place as 16-byte
// stores, then fence_async_smem and the warpgroup's own barrier (act is the
// warpgroup's own, so no block-wide barrier). Biases and head vectors are read
// from global memory (no prm region), which leaves room for 3 stages at H =
// 512 in K1 and the frequency K2 (2 where the encoding is padded to 128
// columns). sigma is a row dot of the last trunk activation read back from
// act, and rgb row dots of the colour head's epilogue, both in 32-column
// blocks, so the outputs are those of 32-column chunks. The layer-end stores
// go in pairs of 16-byte units, odd rows taking their partner's first, so that
// a quarter warp's two rows fill all 32 banks (probe_large_route.py --route
// wide). The H = 128 / 256 path does not share this code: the wide path is
// selected at compile time (H > 256), one instantiation per width.
//
// Hidden widths above 512 (the large route; any multiple of 128, H a run-time
// value, one instantiation for all): neither the 64 x H activations of both
// warpgroups (2 x 128 KiB at H = 1024) nor a layer's held output (H / 4
// registers a thread) fits, so each consumer warpgroup keeps its activations
// in a ping-pong pair of 64 x H bf16 buffers in global memory (LargeMlpArgs::
// scratch, allocated by the caller per persistent block), in the swizzled
// layout of act, where a 64-column slice is 8 KiB contiguous. A layer runs in
// output chunks of up to LNC = 256 columns (then 128, then 64: large_chunk;
// 640 = 256 + 256 + 128), each a 64 x 256 fp32 accumulator (128 registers, the
// register path's) fed by m64n256k16 wgmmas, so the input is read H / 256
// times a layer where 32-column chunks read it H / 32 times. The A operand
// comes through a ring of NA = 3 shared slots per warpgroup (ARing): lane 0 of
// the warpgroup issues one cp.async.bulk per 8 KiB slice, completed on the
// slot's mbarrier, up to NA slices ahead and across the chunks of a layer, and
// each warp releases a slot once its wgmmas have read it, as the weight stages
// are released. The chunk's epilogue (bias, relu, bf16) goes straight from the
// accumulator to the other buffer with st.global; at the end of a layer every
// thread runs fence.proxy.async.global and the warpgroup's barrier before the
// next layer's copies are issued, so that the bulk copies (async proxy) see
// the stores. The weights stream in stages of 64 K rows x the chunk's columns
// (32 KiB at 256; stage_weights' large stream), which an overload of
// mlp_produce walks. The colour head is the last step of the layer loop (its
// output goes to the buffer the feature layer read), and sigma and rgb are row
// dots of stored activations, read back after the layer's barrier, in
// 32-column blocks as the wide path sums them, so the outputs are those of
// 32-column chunks. The epilogue stores whole 16-byte units (a quad transposes
// its pairs with shuffles first), four times fewer stores than one 4-byte word
// per pair, which ran markedly slower (probe_large_route.py). What ptxas needs
// to keep these wgmmas asynchronous (chip_smoke.py phase 2 fails otherwise):
// one accumulator array for every chunk width, its first product written only
// (Wgmma::ss0), every wgmma of a pass in one loop, and no loop of thread-
// dependent trip count before the pass (K1 stages its rows with trip counts
// written out on this route). Biases and head vectors are read from global
// memory, so shared memory does not grow with H.
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

// The wide path (H = 384 or 512): the output columns of one weight stage
// (two stages per 64 K rows of a 256-column chunk), and its bytes.
constexpr int NCW = 128;
constexpr uint32_t WIDE_STAGE_BYTES = uint32_t(KC) * NCW * 2;

// The large route (H > 512): the widest output chunk of a layer (a 64 x 256
// fp32 accumulator, 128 registers), its weight stage (64 K rows x LNC
// columns; a narrower chunk fills the front of one), the A slots of each
// consumer warpgroup's ring, and the ring's mbarriers and pass count (the
// warpgroup's share of the prm region, which this route does not use).
constexpr int LNC = 256;
constexpr uint32_t LARGE_STAGE_BYTES = uint32_t(KC) * LNC * 2;
// 3 A slots leave room for 4 weight stages in K1 and the frequency K2, which
// runs faster than 4 slots and 3 stages (probe_large_route.py)
constexpr int NA = 3;
constexpr int LARGE_RING_META = (2 * NA + 1) * 8;

// The output columns of the next chunk of a matmul (wide path and large
// route) that still has `left` columns to produce: 256 while that many
// remain, then 128, then 64 (H is a multiple of 128, the colour head's H / 2
// of 64).
__host__ __device__ inline int large_chunk(int left) {
  return left >= LNC ? LNC : left >= 128 ? 128 : 64;
}

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
    ring = o;
    o += NS * size_t(route == ROUTE_LARGE ? LARGE_STAGE_BYTES : stage_bytes(H, wide));
    for (int w = 0; w < N_CONSUMERS; ++w) { enc[w] = o; o += (EP / KC) * A_CHUNK_BYTES; }
    for (int w = 0; w < N_CONSUMERS; ++w) { ed[w] = o; o += (EDP / KC) * A_CHUNK_BYTES; }
    for (int w = 0; w < N_CONSUMERS; ++w) { out[w] = o; o += WG_ROWS * 4 * sizeof(float); }
    for (int w = 0; w < N_CONSUMERS; ++w) {   // wide: 64 x H activations
      act[w] = o;                             // large: the A ring's NA slots
      if (route == ROUTE_WIDE) o += (H / KC) * A_CHUNK_BYTES;
      if (route == ROUTE_LARGE) o += NA * A_CHUNK_BYTES;
    }
    prm = o;   // the wide and large routes read global; the large route
               // keeps its A rings' state here
    if (route == ROUTE_REGS) o += ((prm_offsets(H, n_layers).total * 2 + 15) & ~size_t(15));
    if (route == ROUTE_LARGE) o += N_CONSUMERS * LARGE_RING_META;
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

// The large route's A ring of warpgroup wg: its NA "full" then NA "empty"
// mbarriers (shared-space address), and its count of slices so far.
__device__ __forceinline__ uint32_t large_ring_bars(const MlpSmem& S, int wg) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(S.prm)) + wg * LARGE_RING_META;
}
__device__ __forceinline__ uint32_t* large_ring_count(const MlpSmem& S, int wg) {
  return reinterpret_cast<uint32_t*>(
      reinterpret_cast<uintptr_t>(S.prm) + wg * LARGE_RING_META + 2 * NA * 8);
}

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
// rgb head vectors to shared memory (not on the wide and large routes, which
// read them from global memory), initialises the barriers.
template <int ROUTE>
__device__ inline void mlp_setup(unsigned char* raw, const MlpArgs& P) {
  const MlpSmem S = mlp_carve<ROUTE>(raw, P);
  if constexpr (ROUTE != ROUTE_REGS) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < MAX_STAGES; ++s) {
        mbar_init(S.bars + 8 * s, 1);                                // full
        mbar_init(S.bars + 8 * (MAX_STAGES + s), N_CONSUMER_THREADS / 32);  // empty
      }
      if constexpr (ROUTE == ROUTE_LARGE) {
        for (int w = 0; w < N_CONSUMERS; ++w) {   // the A rings
          for (int s = 0; s < NA; ++s) {
            mbar_init(large_ring_bars(S, w) + 8 * s, 1);
            mbar_init(large_ring_bars(S, w) + 8 * (NA + s), WG_THREADS / 32);
          }
          *large_ring_count(S, w) = 0;
        }
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

// The producer warpgroup: one thread refills each stage as soon as all
// consumer warps have released it, cycling through the stream, until the
// consumers are done; the other threads leave. Hidden widths 128 / 256; the
// wide path and the large route: the specialisation and the overload below.
template <int ROUTE>
__device__ inline void mlp_produce(unsigned char* raw, const MlpArgs& P) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
  if (threadIdx.x != N_CONSUMER_THREADS) return;
  const MlpSmem S = mlp_carve<ROUTE>(raw, P);
  const int n_trunk = trunk_chunks(P.H, P.EP, P.n_layers);
  const int n_chunks = stream_chunks(P.H, P.EP, P.EDP, P.n_layers);
  const uint32_t tbytes = uint32_t(KC) * P.H * 2;
  const uint32_t cbytes = tbytes / 2;
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

// The wide path's producer: the same ring, each slot WIDE_STAGE_BYTES apart,
// on stage_weights' wide stream: per matmul, per output chunk of
// large_chunk widths, per array, per 64 K rows, the chunk's columns in
// stages of at most NCW (two per 64 K rows of a 256-column chunk). Matmul m
// is layer 0 (K = EP), the trunk's layers (H, or H + EP at the skip), the
// feature layer (H) and, at m = last, the colour head (K = H + EDP, H / 2
// columns).
template <>
__device__ inline void mlp_produce<ROUTE_WIDE>(unsigned char* raw, const MlpArgs& P) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
  if (threadIdx.x != N_CONSUMER_THREADS) return;
  const MlpSmem S = mlp_carve<ROUTE_WIDE>(raw, P);
  const char* src = reinterpret_cast<const char*>(P.staged);
  volatile int* done = S.done;
  const int last = P.n_layers + 1;
  int m = 0, n = 0, k = 0, h = 0, s = 0;
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
    const int N = m == last ? P.H / 2 : P.H;
    const int K = m == 0 ? P.EP : m == last ? P.H + P.EDP
                : m == P.skip_pos ? P.H + P.EP : P.H;
    const int nc = large_chunk(N - n), sw = nc < NCW ? nc : NCW;
    const uint32_t bytes = uint32_t(sw) * (KC * 2);
    const uint32_t full = S.bars + 8 * s;
    mbar_expect_tx(full, bytes);
    bulk_load(S.ring + s * WIDE_STAGE_BYTES, src + off, bytes, full);
    off += bytes;
    if ((h += sw) == nc) {
      h = 0;
      if ((k += KC) == K) {
        k = 0;
        if ((n += nc) == N) {
          n = 0;
          if (++m > last) { m = 0; off = 0; }
        }
      }
    }
    if (++s == P.NS) { s = 0; ph ^= 1; }
  }
}

// The large route's producer: the same ring, in stages of 64 K rows x the
// output chunk's columns (stage_weights' large stream: per matmul, per
// chunk of large_chunk widths, the K / 64 stages of its arrays), each slot
// LARGE_STAGE_BYTES apart, the matmuls as on the wide path. The overload for
// the large route's arguments; the kernels call mlp_produce<R>(smem, P) for
// all.
template <int ROUTE>
__device__ inline void mlp_produce(unsigned char* raw, const LargeMlpArgs& P) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
  if (threadIdx.x != N_CONSUMER_THREADS) return;
  const MlpSmem S = mlp_carve<ROUTE_LARGE>(raw, P);
  const char* src = reinterpret_cast<const char*>(P.staged);
  volatile int* done = S.done;
  const int last = P.n_layers + 1;
  int m = 0, n = 0, k = 0, s = 0;
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
    const int N = m == last ? P.H / 2 : P.H;
    const int K = m == 0 ? P.EP : m == last ? P.H + P.EDP
                : m == P.skip_pos ? P.H + P.EP : P.H;
    const int nc = large_chunk(N - n);
    const uint32_t bytes = uint32_t(nc) * (KC * 2);
    const uint32_t full = S.bars + 8 * s;
    mbar_expect_tx(full, bytes);
    bulk_load(S.ring + s * LARGE_STAGE_BYTES, src + off, bytes, full);
    off += bytes;
    if ((k += KC) == K) {
      k = 0;
      if ((n += nc) == N) {
        n = 0;
        if (++m > last) { m = 0; off = 0; }
      }
    }
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
  // the large route's (its stages are LARGE_STAGE_BYTES apart)
  __device__ Pipe(const MlpSmem& S, const LargeMlpArgs& P, bool)
      : ring(S.ring), bars(S.bars), sbytes(LARGE_STAGE_BYTES), NS(P.NS), s(0), ph(0) {}
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

// ---- the large route: one warpgroup's 64 rows at any H > 512 ----

// The global stores of a layer's output, ordered before the bulk copies
// (async proxy) that read them as the next layer's input.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The A operand's ring of one consumer warpgroup: NA slots of 8 KiB, each a
// 64 x 64 slice of the layer's input (64 x H in global scratch, slice k at
// element k * 64 * 64, already in wgmma's swizzled layout), brought in by
// one cp.async.bulk completed on the slot's "full" mbarrier; each warp
// arrives on the slot's "empty" mbarrier once its wgmmas have read it. A
// layer takes its input's kh slices once per output chunk, in order, and
// lane 0 of the warpgroup issues them up to NA ahead, across the chunks of
// the layer. Every thread runs the same code (the wait on "empty" too), so
// that no branch sits between the wgmmas. The counts run on from pass to
// pass (mlp_pass_large keeps them in shared memory): slot n % NA, phase
// (n / NA) % 2.
struct ARing {
  uint32_t slots, bars;            // bars: NA "full", then NA "empty"
  uint32_t issued, taken, freed;   // slices issued, waited for, released
  const bf16* src;                 // the current layer's input
  int kh, k, left;                 // its slices, the next to issue, still to issue

  __device__ __forceinline__ void issue() {
    const uint32_t s = issued % NA;
    mbar_wait(bars + 8 * (NA + s), ((issued / NA) & 1) ^ 1);
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.eq.u32 p, %4, 0;\n"
        "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %3;\n"
        "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%1], [%2], %3, [%0];\n}\n"
        :: "r"(bars + 8 * s), "r"(slots + s * A_CHUNK_BYTES),
           "l"(src + size_t(k) * (WG_ROWS * KC)), "r"(uint32_t(A_CHUNK_BYTES)),
           "r"(threadIdx.x % WG_THREADS) : "memory");
    ++issued;
    --left;
    if (++k == kh) k = 0;
  }
  // Issue while slices remain and a slot is (or is about to be) free.
  __device__ __forceinline__ void refill() {
    while (left > 0 && issued - freed < uint32_t(NA)) issue();
  }
  // Start a layer whose input is `in` (kh slices), read by n_chunks output
  // chunks; called after the last layer's fence_async_global and wg_sync.
  __device__ __forceinline__ void begin(const bf16* in, int kh_, int n_chunks) {
    src = in;
    kh = kh_;
    k = 0;
    left = kh_ * n_chunks;
    refill();
  }
  // Wait for the next slice; → its shared address.
  __device__ __forceinline__ uint32_t take() {
    const uint32_t s = taken % NA;
    mbar_wait(bars + 8 * s, (taken / NA) & 1);
    ++taken;
    return slots + s * A_CHUNK_BYTES;
  }
  // After this warp's wgmmas on the oldest slice taken have completed: lane
  // 0 arrives (predicated, as Pipe::release); then refill its slot.
  __device__ __forceinline__ void release() {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.eq.u32 p, %1, 0;\n"
        "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
        :: "r"(bars + 8 * (NA + freed % NA)), "r"(threadIdx.x & 31) : "memory");
    ++freed;
    refill();
  }
};

// acc (64 x N) = A0 (64 x 64 n0, the ring's next n0 slices) @ W + A1 (64 x
// 64 n1, shared at a1) @ W', the n0 + n1 weight stages of one output chunk
// taken from the ring in order (warp-uniform n0, n1; n0 + n1 >= 1). One loop
// over the K slices, its first k16 step peeled (ss0: acc written, not read),
// so that no value flows into acc from an earlier chunk.
template <int N>
__device__ __forceinline__ void mma_large_chunk(float* acc, ARing& A, int n0, uint32_t a1,
                                                int n1, Pipe& P) {
  wgmma_fence();
  int st, prev;
  {
    const uint64_t db = sdesc(P.acquire(st));
    const uint64_t da = sdesc(n0 > 0 ? A.take() : a1);
    Wgmma<N>::ss0(acc, da, db);
#pragma unroll
    for (int kk = 1; kk < KC / 16; ++kk) Wgmma<N>::ss(acc, da + 2 * kk, db + 2 * kk, 1);
    wgmma_commit();
    prev = st;
  }
  for (int c = 1; c < n0 + n1; ++c) {
    const uint64_t db = sdesc(P.acquire(st));
    const uint64_t da = sdesc(c < n0 ? A.take() : a1 + (c - n0) * A_CHUNK_BYTES);
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) Wgmma<N>::ss(acc, da + 2 * kk, db + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<1>();
    P.release(prev);
    if (c - 1 < n0) A.release();
    prev = st;
  }
  wgmma_wait<0>();
  P.release(prev);
  if (n1 == 0) A.release();   // the last slice came from the A ring
  fence_regs<N / 2>(acc);
}

// Rows r, r + 8 and columns 8j + 2q, +1 of an accumulator (the epilogue's
// layout) → bf16(act(acc + bias)) as two packed pairs.
__device__ __forceinline__ void large_pack(const float* acc, const bf16* bias, int j,
                                           bool relu, uint32_t& u0, uint32_t& u1) {
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(bias + 8 * j + 2 * (threadIdx.x & 3)));
  const float y0 = acc[4 * j] + b.x, y1 = acc[4 * j + 1] + b.y;
  const float y2 = acc[4 * j + 2] + b.x, y3 = acc[4 * j + 3] + b.y;
  u0 = relu ? pack_bf16_relu(y0, y1) : pack_bf16(y0, y1);
  u1 = relu ? pack_bf16_relu(y2, y3) : pack_bf16(y2, y3);
}

// The four lanes of a quad each hold a[i], i < 4: lane p's word i. After
// this, lane q holds lane p's word q in a[p] (a 4 x 4 transpose in two
// exchanges of two words with the lane whose index differs in bit k).
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int k = 1; k <= 2; k <<= 1) {
    const bool hi = q & k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i & k) continue;
      const uint32_t x = a[i], y = a[i | k];
      const uint32_t got = __shfl_xor_sync(0xffffffffu, hi ? x : y, k);
      a[i] = hi ? got : x;
      a[i | k] = hi ? y : got;
    }
  }
}

// The epilogue of output chunk [n, n + N) (n a multiple of 64): bf16(act(acc
// + bias)) into the 64-row buffer g (global, swizzled as act: 16-byte unit u
// of row r's 64-column block at u ^ (r % 8)). Each lane packs its pairs of
// four n8 groups, the quad transposes them, and each lane stores one whole
// 16-byte unit of rows r and r + 8: a quarter of the stores of one word.
template <int N>
__device__ __forceinline__ void large_store(const float* acc, const bf16* bias, bool relu,
                                            bf16* g, int n) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  bf16* row = g + (n / KC) * (WG_ROWS * KC) + r * KC;
#pragma unroll
  for (int m = 0; m < N / 32; ++m) {
    uint32_t a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) large_pack(acc, bias + n, 4 * m + i, relu, a[i], b[i]);
    quad_transpose(a);
    quad_transpose(b);
    const int j = 4 * m + (lane & 3);   // this lane's n8 group (16-byte unit)
    bf16* p = row + (j / 8) * (WG_ROWS * KC) + (((j % 8) ^ (r & 7)) << 3);
    *reinterpret_cast<uint4*>(p) = make_uint4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<uint4*>(p + 8 * KC) = make_uint4(b[0], b[1], b[2], b[3]);
  }
}

// Rows r and r + 8 of the first `width` columns of the 64-row buffer g (after
// the warpgroup's barrier that follows large_store) dotted with the
// NV vectors v + k * stride, fp32, added to s[k]: per 32 columns row_dots'
// steps, then the sum, as the wide path reduces its 32-column chunks.
template <int NV>
__device__ __forceinline__ void large_row_dots(const bf16* g, int width, const bf16* v,
                                               int stride, float (&s)[NV][2]) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2), c2 = 2 * (lane & 3);
  const bf16* row = g + r * KC + c2;
  for (int b = 0; b < width; b += 32) {
    float d[NV][2];
#pragma unroll
    for (int k = 0; k < NV; ++k) d[k][0] = d[k][1] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = b + 8 * j;
      const bf16* p = row + (col / KC) * (WG_ROWS * KC) + ((((col % KC) >> 3) ^ (r & 7)) << 3);
      const float2 a = unpack_bf16(__ldcg(reinterpret_cast<const unsigned int*>(p)));
      const float2 c = unpack_bf16(__ldcg(reinterpret_cast<const unsigned int*>(p + 8 * KC)));
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const float2 w = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(v + k * stride + col + c2));
        d[k][0] = fmaf(a.y, w.y, fmaf(a.x, w.x, d[k][0]));
        d[k][1] = fmaf(c.y, w.y, fmaf(c.x, w.x, d[k][1]));
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        d[k][0] += __shfl_xor_sync(0xffffffffu, d[k][0], m);
        d[k][1] += __shfl_xor_sync(0xffffffffu, d[k][1], m);
      }
      s[k][0] += d[k][0];
      s[k][1] += d[k][1];
    }
  }
}

// One output chunk [n, n + N) of a layer: the products into the first N / 2
// registers of acc (one array for every width, so that every chunk's
// accumulator is the same registers), then the epilogue into out.
template <int N>
__device__ __forceinline__ void large_chunk_pass(float* acc, ARing& A, int n0, uint32_t a1,
                                                 int n1, Pipe& pipe, const bf16* bias,
                                                 bool relu, bf16* out, int n) {
  mma_large_chunk<N>(acc, A, n0, a1, n1, pipe);
  large_store<N>(acc, bias, relu, out, n);
}

// mlp_pass for any hidden width H = P.H above 512 (a multiple of 128): the
// same layers, rounding points and outputs as mlp_pass_wide, with layer l
// reading its input from buffer (l + 1) % 2 of the warpgroup's scratch pair
// through the A ring and writing buffer l % 2, in output chunks of 256
// columns (then 128, then 64: large_chunk) on the weight stream of
// stage_weights' large route (64 K rows x the chunk's columns a stage). The
// colour head's output goes to the buffer the feature layer read; sigma and
// rgb are row dots of what the epilogues stored, read back after the layer's
// barrier (no accumulator is live while they run).
__device__ inline void mlp_pass_large(const LargeMlpArgs& P, const MlpSmem& S,
                                      int wg, Pipe& pipe) {
  const int H = __shfl_sync(0xffffffffu, P.H, 0);
  const int kh = H / KC, half = H / 2;
  const int ke = __shfl_sync(0xffffffffu, P.EP / KC, 0);
  const int kd = __shfl_sync(0xffffffffu, P.EDP / KC, 0);
  const int n_layers = __shfl_sync(0xffffffffu, P.n_layers, 0);
  const int skip = __shfl_sync(0xffffffffu, P.skip_pos, 0);
  const uint32_t enc = smem_addr(S.enc[wg]), ed = smem_addr(S.ed[wg]);
  // buffer b of the warpgroup's pair at scratch + b * 64 * H
  bf16* scratch = P.scratch + size_t(blockIdx.x * N_CONSUMERS + wg) * 2 * WG_ROWS * H;
  uint32_t* count = large_ring_count(S, wg);
  ARing A;
  A.slots = smem_addr(S.act[wg]);
  A.bars = large_ring_bars(S, wg);
  A.issued = A.taken = A.freed = __shfl_sync(0xffffffffu, *count, 0);
  A.left = 0;
  int n_trunk = 0, n_head = 0;   // output chunks of a trunk layer, of the head
  for (int n = 0; n < H; n += large_chunk(H - n)) ++n_trunk;
  for (int n = 0; n < half; n += large_chunk(half - n)) ++n_head;
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float* res = S.out[wg];
  float acc[LNC / 2];
  // the trunk, the feature layer (l = n_layers, no activation), then the
  // colour head (l = n_layers + 1, width H/2, on [feature, enc_dir]) into
  // the buffer the feature layer read: one loop, so that every wgmma of the
  // pass sits in one region of code (a separate head loop made ptxas
  // serialize them all)
  for (int l = 0; l <= n_layers + 1; ++l) {
    const bool first = l == 0, feat = l == n_layers, head = l > n_layers;
    const bf16* bias = first ? P.p[B0]
                       : feat ? P.p[B_FEAT]
                       : head ? P.p[BC1]
                       : l == skip ? P.p[BSKIP]
                                   : P.p[B_MID] + H * (l - 1 - (l > skip));
    const int n0 = first ? 0 : kh;
    const int n1 = first || l == skip ? ke : head ? kd : 0;
    const uint32_t a1 = head ? ed : enc;
    const int width = head ? half : H, n_chunks = head ? n_head : n_trunk;
    const bf16* in = scratch + size_t((l + 1) & 1) * WG_ROWS * H;
    bf16* out = scratch + size_t(l & 1) * WG_ROWS * H;
    A.begin(in, kh, first ? 0 : n_chunks);
    if (feat) {
      // sigma from the last trunk activation, while the layer's first
      // slices land
      float sg[1][2] = {{0.0f, 0.0f}};
      large_row_dots<1>(in, H, P.p[W_SIG], 0, sg);
      // the four lanes of a quad hold the same sums and store the same value
      const float bs = __bfloat162float(P.p[B_SIG][0]);
      res[r * 4 + 3] = sg[0][0] + bs;
      res[(r + 8) * 4 + 3] = sg[0][1] + bs;
    }
    for (int n = 0; n < width;) {
      const int nc = large_chunk(width - n);
      if (nc == LNC)
        large_chunk_pass<LNC>(acc, A, n0, a1, n1, pipe, bias, !feat, out, n);
      else if (nc == 128)
        large_chunk_pass<128>(acc, A, n0, a1, n1, pipe, bias, !feat, out, n);
      else
        large_chunk_pass<64>(acc, A, n0, a1, n1, pipe, bias, !feat, out, n);
      n += nc;
    }
    fence_async_global();
    wg_sync(wg);   // the layer's output is in place before the next reads it
  }
  float rgb[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
  large_row_dots<3>(scratch + size_t((n_layers + 1) & 1) * WG_ROWS * H, half, P.p[WC2T],
                    half, rgb);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float b = __bfloat162float(P.p[BC2][k]);
    res[r * 4 + k] = rgb[k][0] + b;
    res[(r + 8) * 4 + k] = rgb[k][1] + b;
  }
  *count = A.issued;   // the same value from every thread; read after wg_sync
}

// ---- the wide path: one warpgroup's 64 rows at H = 384 or 512 ----

// acc (64 x N, its first N / 2 registers) = A0 (64 x 64 n0, shared at a0) @
// W + A1 (64 x 64 n1, shared at a1) @ W', the chunk's weight stages taken
// from the ring in order: per 64 K rows, one stage of each NCW columns of
// the chunk (N = 256: two, an m64n128k16 product into each half of acc).
// Each stage is one wgmma group, and a stage is released once the group
// after it is issued and its own is done, so two groups are in flight. The
// first 64 K rows are peeled (ss0: acc written, not read), so that no value
// flows into acc from an earlier chunk (n0, n1 warp-uniform, n0 + n1 >= 1).
template <int N>
__device__ __forceinline__ void mma_wide_chunk(float* acc, uint32_t a0, int n0, uint32_t a1,
                                               int n1, Pipe& P) {
  constexpr int SW = N < NCW ? N : NCW, NH = N / SW;
  wgmma_fence();
  int st, prev;
  {
    const uint64_t da = sdesc(n0 > 0 ? a0 : a1);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const uint64_t db = sdesc(P.acquire(st));
      Wgmma<SW>::ss0(acc + h * (SW / 2), da, db);
#pragma unroll
      for (int kk = 1; kk < KC / 16; ++kk)
        Wgmma<SW>::ss(acc + h * (SW / 2), da + 2 * kk, db + 2 * kk, 1);
      wgmma_commit();
      if (h > 0) {
        wgmma_wait<1>();
        P.release(prev);
      }
      prev = st;
    }
  }
  for (int c = 1; c < n0 + n1; ++c) {
    const uint64_t da =
        sdesc(c < n0 ? a0 + c * A_CHUNK_BYTES : a1 + (c - n0) * A_CHUNK_BYTES);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const uint64_t db = sdesc(P.acquire(st));
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        Wgmma<SW>::ss(acc + h * (SW / 2), da + 2 * kk, db + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<1>();
      P.release(prev);
      prev = st;
    }
  }
  wgmma_wait<0>();
  P.release(prev);
  fence_regs<N / 2>(acc);
}

// Columns [32 m, 32 m + 32) of acc + bias, relu'd if relu, as bf16 16-byte
// units: after the quad's transpose (large_store's), lane q holds unit
// 4 m + q of row r in u[0..3] and of row r + 8 in u[4..7].
__device__ __forceinline__ void wide_units(const float* acc, const bf16* bias, int m,
                                           bool relu, uint32_t* u) {
  uint32_t a[4], b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) large_pack(acc, bias, 4 * m + i, relu, a[i], b[i]);
  quad_transpose(a);
  quad_transpose(b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u[i] = a[i];
    u[4 + i] = b[i];
  }
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, const uint32_t* v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
}

// The units u of wide_units for the layer's 8-column group g (columns 8 g to
// 8 g + 7) of rows r and r + 8, into the warpgroup's activations at shared
// address act (unit g % 8 of row r's 64-column block at (g % 8) ^ (r % 8)).
__device__ __forceinline__ void st_unit(uint32_t act, int g, const uint32_t* u) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const uint32_t p = act + (g >> 3) * A_CHUNK_BYTES + r * (KC * 2) + (((g & 7) ^ (r & 7)) << 4);
  st_shared_v4(p, u);
  st_shared_v4(p + 8 * KC * 2, u + 4);
}

// The end of a wide layer: once every warp's products have read act (the
// warpgroup's barrier), the parked first chunk (LNC columns) and the
// epilogue of the last (N columns in acc, from column LNC) over act; then
// visible to wgmma.
template <int N>
__device__ __forceinline__ void wide_store(uint32_t act, const uint32_t (&park)[LNC / 32][8],
                                           const float* acc, const bf16* bias, bool relu,
                                           int wg) {
  static_assert(N % 64 == 0, "the stores go in pairs of 32-column blocks");
  const int q = threadIdx.x & 3;
  // odd rows store their pair partner's units first, so that rows r and
  // r + 1 of a store's quarter warp fill all 32 banks, not the same 16
  const int odd = (threadIdx.x >> 2) & 1;
  wg_sync(wg);
#pragma unroll
  for (int m = 0; m < LNC / 32; m += 2) {
    uint32_t x[8], y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = odd ? park[m + 1][i] : park[m][i];
      y[i] = odd ? park[m][i] : park[m + 1][i];
    }
    st_unit(act, 4 * (m + odd) + q, x);
    st_unit(act, 4 * (m + 1 - odd) + q, y);
  }
#pragma unroll
  for (int m = 0; m < N / 32; m += 2) {
    uint32_t u[8], v[8], x[8], y[8];
    wide_units(acc, bias + LNC, m, relu, u);
    wide_units(acc, bias + LNC, m + 1, relu, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = odd ? v[i] : u[i];
      y[i] = odd ? u[i] : v[i];
    }
    st_unit(act, LNC / 8 + 4 * (m + odd) + q, x);
    st_unit(act, LNC / 8 + 4 * (m + 1 - odd) + q, y);
  }
  fence_async_smem();
  wg_sync(wg);
}

// sigma's row dots on the wide path: rows r and r + 8 of the H columns of
// act (shared, swizzled) dotted with w, fp32, summed as large_row_dots sums
// them (per 32 columns row_dots' steps, then the blocks in column order),
// with every block's loads issued before the first shuffle.
template <int H>
__device__ __forceinline__ void wide_sigma(const bf16* act, const bf16* w, float& s0,
                                           float& s1) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2), c2 = 2 * (lane & 3);
  const bf16* row = act + r * KC + c2;
  float d0[H / 32], d1[H / 32];
#pragma unroll
  for (int b = 0; b < H / 32; ++b) {
    d0[b] = d1[b] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * b + 8 * j;
      const bf16* p = row + (col / KC) * (WG_ROWS * KC) + ((((col % KC) >> 3) ^ (r & 7)) << 3);
      const float2 a = unpack_bf16(*reinterpret_cast<const unsigned int*>(p));
      const float2 c = unpack_bf16(*reinterpret_cast<const unsigned int*>(p + 8 * KC));
      const float2 ww =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + col + c2));
      d0[b] = fmaf(a.y, ww.y, fmaf(a.x, ww.x, d0[b]));
      d1[b] = fmaf(c.y, ww.y, fmaf(c.x, ww.x, d1[b]));
    }
  }
  s0 = s1 = 0.0f;
#pragma unroll
  for (int b = 0; b < H / 32; ++b) {
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      d0[b] += __shfl_xor_sync(0xffffffffu, d0[b], m);
      d1[b] += __shfl_xor_sync(0xffffffffu, d1[b], m);
    }
    s0 += d0[b];
    s1 += d1[b];
  }
}

// The colour head's columns [n, n + N) in acc: bf16(relu(acc + bc1)) dotted
// with wc2t's three rows (stride half), per 32 columns (row_dots' steps),
// added to rgb.
template <int N>
__device__ __forceinline__ void wide_head_dots(const float* acc, const bf16* bc1,
                                               const bf16* wc2t, int half, int n,
                                               float (&rgb)[3][2]) {
#pragma unroll
  for (int m = 0; m < N / 32; ++m) {
    uint32_t hc[8];
    epilogue<32, true>(acc + 16 * m, hc, bc1 + n + 32 * m);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float a, b;
      row_dots<32>(hc, wc2t + k * half + n + 32 * m, a, b);
      rgb[k][0] += a;
      rgb[k][1] += b;
    }
  }
}

// mlp_pass for hidden width H = 384 or 512: the same layers, rounding points
// and outputs, with the activations in S.act[wg]; each layer in a chunk of
// LNC columns, parked in registers, and a last chunk of H - LNC; the colour
// head in one chunk of 256, or 128 and 64.
template <int H>
__device__ __forceinline__ void mlp_pass_wide(const MlpArgs& P, const MlpSmem& S, int wg,
                                              Pipe& pipe) {
  constexpr int kh = H / KC, C1 = H - LNC;
  constexpr int D0 = H / 2 >= LNC ? LNC : 128, D1 = H / 2 - D0;
  const uint32_t enc = smem_addr(S.enc[wg]), ed = smem_addr(S.ed[wg]);
  const uint32_t act = smem_addr(S.act[wg]);
  const int ke = __shfl_sync(0xffffffffu, P.EP / KC, 0);
  const int kd = __shfl_sync(0xffffffffu, P.EDP / KC, 0);
  const int n_layers = __shfl_sync(0xffffffffu, P.n_layers, 0);
  const int skip = __shfl_sync(0xffffffffu, P.skip_pos, 0);
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float* res = S.out[wg];
  float acc[LNC / 2];
  uint32_t park[LNC / 32][8];
  // the trunk, then the feature layer (l = n_layers, no activation)
  for (int l = 0; l <= n_layers; ++l) {
    const bool first = l == 0, feat = l == n_layers;
    const bf16* bias = first ? P.p[B0]
                       : feat ? P.p[B_FEAT]
                       : l == skip ? P.p[BSKIP]
                                   : P.p[B_MID] + H * (l - 1 - (l > skip));
    const uint32_t a0 = first ? enc : act;
    const int n0 = first ? ke : kh, n1 = l == skip ? ke : 0;
    if (feat) {
      // sigma from the last trunk activation, in act since the last layer's
      // barrier (the four lanes of a quad store the same value)
      float sg0 = 0.0f, sg1 = 0.0f;
      wide_sigma<H>(S.act[wg], P.p[W_SIG], sg0, sg1);
      const float bs = __bfloat162float(P.p[B_SIG][0]);
      res[r * 4 + 3] = sg0 + bs;
      res[(r + 8) * 4 + 3] = sg1 + bs;
    }
    mma_wide_chunk<LNC>(acc, a0, n0, enc, n1, pipe);
#pragma unroll
    for (int m = 0; m < LNC / 32; ++m) wide_units(acc, bias, m, !feat, park[m]);
    mma_wide_chunk<C1>(acc, a0, n0, enc, n1, pipe);
    wide_store<C1>(act, park, acc, bias, !feat, wg);
  }
  // the colour head (width H / 2) on [feature, enc_dir]
  float rgb[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
  mma_wide_chunk<D0>(acc, act, kh, ed, kd, pipe);
  wide_head_dots<D0>(acc, P.p[BC1], P.p[WC2T], H / 2, 0, rgb);
  if constexpr (D1 > 0) {
    mma_wide_chunk<D1>(acc, act, kh, ed, kd, pipe);
    wide_head_dots<D1>(acc, P.p[BC1], P.p[WC2T], H / 2, D0, rgb);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float b = __bfloat162float(P.p[BC2][k]);
    res[r * 4 + k] = rgb[k][0] + b;
    res[(r + 8) * 4 + k] = rgb[k][1] + b;
  }
}

// The pass of a kernel instantiated for hidden width H (0: the large route).
template <int H>
__device__ __forceinline__ void mlp_pass_any(const MlpArgs& P, const MlpSmem& S,
                                             int wg, Pipe& pipe) {
  if constexpr (H == 0)
    mlp_pass_large(static_cast<const LargeMlpArgs&>(P), S, wg, pipe);
  else if constexpr (H > 256)
    mlp_pass_wide<H>(P, S, wg, pipe);
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
