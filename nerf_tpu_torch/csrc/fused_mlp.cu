// Fused frequency encoding + NeRF-MLP forward for Hopper (sm_90a): the
// serving forward, on wgmma with the weights streamed through a shared-memory
// ring by bulk asynchronous copies, one persistent block per SM.
//
// Replaces the Pallas TPU kernel nerf_tpu/ops/fused_mlp.py:129 (_fused_kernel).
// Plain PyTorch version: nerf_tpu_torch/ops/fused_mlp.py::fused_nerf_eval_plain.
//
// What it computes, per point: phases a = x * 2^f (f32, exact), the encoding
// [x, sin a, cos a] rounded to bf16, the 8x256 ReLU trunk with the skip at
// layer 5, sigma = h.wa + ba, feat = h@Wf + bf, the 128-wide view layer on
// [feat, d, sin b, cos b], rgb = v@Wr + br; out[p] = [rgb, sigma] in f32.
// Operands are bf16, products are summed in f32, biases are f32.
//
// What bounds it on an H100: operations. 593,408 MACs (1.187 MFLOP) per point
// against 40 bytes of input and output, so at 989 TFLOP/s (bf16 dense) the
// tensor cores, not the 3.35 TB/s of device memory, set the floor. The
// 1.19 MB of weights do not fit one SM, so every tile of points streams all
// of them from L2: at 128 points a tile that is 9.3 KB of L2 traffic a point
// (measured on an H100: a variant that skips the copies is no faster, so L2
// does not bound it at this tile size).
//
// The design, and why:
// - Block = two consumer warpgroups (64 points each, so a tile is 128
//   points: m64 is wgmma's row count, and a 64x256 f32 accumulator is all
//   the registers a thread can spare) and one producer warpgroup, 384
//   threads, __launch_bounds__(384, 1): the 227 KB of shared memory below
//   fit one block per SM. The grid is one block per SM (at most),
//   persistent over the tiles: block b takes tiles b, b + grid, ... so the
//   weight ring never drains between tiles.
// - setmaxnreg: the producer warpgroup drops to 40 registers, the consumers
//   rise to 232 (384 x 168 at launch = 128 x 40 + 256 x 232). A consumer
//   thread holds the 128 accumulator registers and addressing; ptxas -v
//   shows no spills.
// - Weights: the eleven matrices of the ten layers, in layer order, repacked
//   on the host (ops/fused_mlp.py::pack_weight_stream) into wgmma's canonical
//   K-major layout without swizzle: [K/8, N, 8], so that 8 K-values of one
//   output column are 16 contiguous bytes and 8 columns one 128-byte core
//   matrix. Cut into chunks of 64 K-rows (32 KB for N = 256; the view layer's
//   N = 128 gives 16 KB chunks and a last one of 32 rows), 39 chunks a tile.
//   One producer thread copies each chunk with one 1-D bulk copy
//   (cp.async.bulk, completion counted in bytes on the stage's full
//   mbarrier), with no tensor map, into a ring of 4 stages of 32 KB (3 stages
//   measured 10% slower; 8 stages of 16 KB 4% slower). Every consumer warp
//   arrives on the stage's empty mbarrier when its products have read it.
//   Phases come from a running chunk count, so the ring runs on across
//   tiles: the next tile's first layers load while this tile's last run.
// - Products: wgmma.mma_async m64n256k16 (m64n128k16 for the view layer),
//   bf16 x bf16 -> f32, A and B from shared memory by descriptor. Each
//   consumer warpgroup keeps its 64-point activation tile in shared memory in
//   the same canonical layout: 44 slabs of 8 columns x 64 rows (1 KB each):
//   enc_x (slabs 0-7), h (8-39), enc_d (40-43), so the skip layer reads
//   slabs 0-39 and the view layer slabs 8-43 as one K = 320 / 288 product.
// - Ping-pong: the two warpgroups take turns issuing a layer's products
//   (Turns below), so one runs its epilogue while the other's products run.
// - Epilogue in registers: bias (from shared memory, loaded two steps ahead),
//   then ReLU and the bf16 rounding in one cvt.rn.relu.bf16x2 are applied to
//   the accumulator fragment, which each thread stores as 32-bit pairs
//   straight into the next layer's input slabs (a warp's stores fill whole
//   128-byte core matrices, so no bank conflicts), in place over the layer's
//   input once its products are done; no f32 staging. The sigma (256 -> 1)
//   and rgb (128 -> 3) heads are dot products of each thread's accumulator
//   columns, summed over the 4 lanes of a row.
// - Ragged last tile: loads of pts/dirs past P read zeros, stores past P are
//   skipped. P = 0 launches nothing.
//
// The previous forward (nvcuda::wmma, 64-point blocks, weights read from L2 as
// fragments) stays in fused_mlp.cuh as fused_nerf_kernel: the backward
// (fused_mlp_bwd.cu) recomputes its forward with it (STASH = true), and its
// serving instantiation is exported here as launch_fused_nerf_wmma, which
// chip_smoke.py and the GPU tests hold the new kernel against.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers; bound with ctypes).

#include "fused_mlp.cuh"

namespace {

constexpr int TILE = 128;                   // points per tile
constexpr int WG_ROWS = 64;                 // points per consumer warpgroup
constexpr int NTHR = 384;                   // two consumer warpgroups + the producer
constexpr int KC = 64;                      // K-rows per weight chunk
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = KC * W * 2;     // 32 KB
constexpr int NCHUNK_W = (EX + 4 * W + (EX + W) + 3 * W) / KC;  // 34 chunks of N = 256
constexpr int NCHUNK = NCHUNK_W + (W + ED + KC - 1) / KC;       // + 5 of the view layer
constexpr int WPACK_SIZE = OFF_WA;          // the stream holds every matrix but the heads
constexpr int SLAB = WG_ROWS * 16;          // 8 bf16 columns of 64 rows
constexpr int SLAB_EX = 0, SLAB_H = EX / 8, SLAB_ED = (EX + W) / 8;
constexpr int ACT_BYTES_WG = (EX + W + ED) / 8 * SLAB;  // 45,056
constexpr int SM_ACT = STAGES * STAGE_BYTES;
constexpr int SM_BIAS = SM_ACT + 2 * ACT_BYTES_WG;
constexpr int SM_BAR = SM_BIAS + BBUF_SIZE * 4;
constexpr int WG_SMEM = SM_BAR + 2 * STAGES * 8;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

static_assert(NCHUNK == 39 && WPACK_SIZE == 34 * KC * W + (W + ED) * VW, "chunk table");
static_assert(WG_SMEM <= 232448, "shared memory of one block");
static_assert(SM_BAR % 8 == 0, "mbarriers are 8-byte aligned");
static_assert(2 * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 384 * 168, "register budget");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed. A wait that
// never ends (a fault in the ring's bookkeeping) traps rather than hangs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done, spins = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (++spins == (1u << 28)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One 1-D bulk copy global -> shared; its bytes complete on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :
      : "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Generic-proxy stores to shared memory, made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the asynchronous
// products' issue and wait.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle (canonical "interleave"
// layout): 8x16-byte core matrices, lbo = bytes between the two core
// matrices of one k16 step (K direction), sbo = bytes between core matrices
// 8 rows apart (M or N direction).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)
#define ACC64(i) ACC16(i), ACC16(i + 16), ACC16(i + 32), ACC16(i + 48)

// d[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, f32 sums; scale_d = 0 starts
// the sum at zero. N = 256 uses d[0..127], N = 128 d[0..63].
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : ACC64(0), ACC64(64)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[128], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64(0)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef ACC64
#undef ACC16
#undef ACC4

// Chunk ch of the weight stream: its byte offset and size.
__device__ __forceinline__ void chunk_span(int ch, uint32_t& off, uint32_t& bytes) {
  constexpr uint32_t VCHUNK = KC * VW * 2;  // 16 KB
  if (ch < NCHUNK_W) {
    off = ch * STAGE_BYTES;
    bytes = STAGE_BYTES;
  } else {
    off = NCHUNK_W * STAGE_BYTES + (ch - NCHUNK_W) * VCHUNK;
    bytes = ch + 1 < NCHUNK ? VCHUNK : (W + ED - (NCHUNK - 1 - NCHUNK_W) * KC) * VW * 2;
  }
}

// The producer: one thread copies nchunks chunks (the stream's first
// nchunks, once per tile) through the ring, for ntiles tiles.
__device__ __forceinline__ void produce(const bf16* __restrict__ wpack, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, int ntiles,
                                        int nchunks) {
  uint32_t c = 0;  // chunks issued so far: stage c % STAGES, round c / STAGES
  for (int t = 0; t < ntiles; ++t) {
    for (int ch = 0; ch < nchunks; ++ch, ++c) {
      const uint32_t s = c % STAGES;
      mbar_wait(&empty[s], ((c / STAGES) & 1) ^ 1);  // the first round passes at once
      uint32_t off, bytes;
      chunk_span(ch, off, bytes);
      mbar_expect_tx(&full[s], bytes);
      bulk_copy(ring + s * STAGE_BYTES, reinterpret_cast<const unsigned char*>(wpack) + off,
                bytes, &full[s]);
    }
  }
}

// The two consumer warpgroups take turns issuing products, up to GROUP chunks
// (a whole layer but the last chunk of the 5-chunk ones) a turn: warpgroup w
// waits on named barrier 3 + w and, once its products are issued, arrives on
// the other's. So one warpgroup's epilogue runs while the other's products
// keep the tensor cores busy (FlashAttention-3's ping-pong). GROUP <= STAGES:
// a turn then needs only stages that the other warpgroup releases without
// waiting for a turn of its own.
constexpr int GROUP = STAGES;
struct Turns {
  int wg, left;  // this warpgroup and the turns it still has to take
  __device__ __forceinline__ void wait() { named_barrier(3 + wg, 256); }
  __device__ __forceinline__ void pass() {  // warpgroup 1's last turn passes to no one
    if (--left > 0 || wg == 0) named_arrive(3 + (wg ^ 1), 256);
  }
};
template <int K>
__host__ __device__ constexpr int turns_of() {
  return ((K + KC - 1) / KC + GROUP - 1) / GROUP;
}
constexpr int TURNS_PER_TILE =
    turns_of<EX>() + 7 * turns_of<W>() + turns_of<EX + W>() + turns_of<W + ED>();

// A consumer warpgroup's view of the ring: chunks are waited for in stream
// order and released in the same order.
struct Ring {
  uint32_t base;  // shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
  uint32_t next = 0, done = 0;  // chunks waited for / released, over all tiles

  __device__ __forceinline__ uint32_t wait() {
    const uint32_t s = next % STAGES;
    mbar_wait(&full[s], (next / STAGES) & 1);
    ++next;
    return base + s * STAGE_BYTES;
  }
  __device__ __forceinline__ void release() {  // one arrival per consumer warp
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[done % STAGES]);
    ++done;
  }
};

// d[64 x N] = act[64 x K] @ B[K x N]: act from the warpgroup's slabs starting
// at a_base (shared address), B chunk after chunk from the ring, in turns.
// Within a turn one chunk's products are in flight while the next chunk's
// are issued; each stage is released as soon as its products are done.
template <int K, int N>
__device__ __forceinline__ void layer_product(float (&d)[128], uint32_t a_base, Ring& ring,
                                              Turns& turns) {
  constexpr int NCH = (K + KC - 1) / KC;
  constexpr uint32_t B_SLAB = N * 16;  // 8 K-values of every column
  fence_acc(d);
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    if (ch % GROUP == 0) turns.wait();
    const uint32_t b = ring.wait();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      if (ch * KC + ks * 16 < K) {
        const uint64_t da = smem_desc(a_base + (ch * KC / 16 + ks) * 2 * SLAB, SLAB, 128);
        const uint64_t db = smem_desc(b + ks * 2 * B_SLAB, B_SLAB, 128);
        wgmma_bf16<N>(d, da, db, ch + ks > 0);
      }
    }
    wgmma_commit();
    if (ch % GROUP != 0) {
      wgmma_wait<1>();  // the previous chunk's products are done with its stage
      ring.release();
    }
    if (ch % GROUP == GROUP - 1 || ch == NCH - 1) {  // the turn's last chunk
      turns.pass();
      wgmma_wait<0>();
      ring.release();
    }
  }
  fence_acc(d);
}

// Accumulator fragment of m64nNk16 (f32): warp w of the warpgroup holds rows
// 16w + lane/4 (d[4j], d[4j+1]) and 16w + lane/4 + 8 (d[4j+2], d[4j+3]), at
// columns 8j + 2(lane%4) + {0, 1}. Element (row, col) of the activation tile
// lives at slab col/8, byte (row/8)*128 + (row%8)*16 + (col%8)*2.
//
// Two floats rounded to bf16 in one 32-bit word, lo in the low half; with
// RELU, negative values become 0 in the same instruction.
template <bool RELU>
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  if (RELU)
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Trunk epilogue: h = d + bias (ReLU'd with RELU) rounded to bf16, stored
// into the h slabs. With sigma, also adds this thread's part of h . wa for
// its two rows to s0, s1. Each step's bias pair is loaded two steps ahead:
// the compiler may not move a shared-memory load above the shared-memory
// stores before it.
template <bool RELU>
__device__ __forceinline__ void trunk_epilogue(const float (&d)[128], const float* bias,
                                               unsigned char* act, bool sigma,
                                               const bf16* __restrict__ wa, float& s0,
                                               float& s1) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int q = lane & 3;
  unsigned char* dst = act + SLAB_H * SLAB + warp * 256 + (lane >> 2) * 16 + q * 4;
  const float2* bq = reinterpret_cast<const float2*>(bias + 2 * q);  // column 8j + 2q at bq[4j]
  float2 b = bq[0], bn = bq[4];
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float2 bnn = j + 2 < W / 8 ? bq[4 * (j + 2)] : bn;
    const uint32_t lo = pack_bf16<RELU>(d[4 * j] + b.x, d[4 * j + 1] + b.y);
    const uint32_t hi = pack_bf16<RELU>(d[4 * j + 2] + b.x, d[4 * j + 3] + b.y);
    *reinterpret_cast<uint32_t*>(dst + j * SLAB) = lo;
    *reinterpret_cast<uint32_t*>(dst + j * SLAB + 128) = hi;
    if (sigma) {
      const __nv_bfloat162 w2 = __ldg(reinterpret_cast<const __nv_bfloat162*>(wa + 8 * j + 2 * q));
      const float w0 = __low2float(w2), w1 = __high2float(w2);
      s0 += bf16_lo(lo) * w0 + bf16_hi(lo) * w1;
      s1 += bf16_lo(hi) * w0 + bf16_hi(hi) * w1;
    }
    b = bn;
    bn = bnn;
  }
}

// View epilogue: v = relu(d + bv) rounded to bf16 (the 64 x 128 fragment in
// d[0..63]), rgb = v . wr + br and sigma = s + ba for this thread's two rows,
// summed over the 4 lanes of a row; lane 0 of the four writes out[row].
__device__ __forceinline__ void view_epilogue(const float (&d)[128], const float* bias,
                                              const bf16* __restrict__ wr, float s0, float s1,
                                              float* __restrict__ out, long long row0, int P) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int q = lane & 3;
  float r0[3] = {0.0f, 0.0f, 0.0f}, r1[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < VW / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const float2 b = *reinterpret_cast<const float2*>(bias + OFF_BV + col);
    const uint32_t lo = pack_bf16<true>(d[4 * j] + b.x, d[4 * j + 1] + b.y);
    const uint32_t hi = pack_bf16<true>(d[4 * j + 2] + b.x, d[4 * j + 3] + b.y);
    // wr is [128, 3]: the 6 weights of columns col and col + 1, 4-byte aligned
    const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(wr + col * 3);
    const __nv_bfloat162 wa = __ldg(w2), wb = __ldg(w2 + 1), wc = __ldg(w2 + 2);
    const float wc0[3] = {__low2float(wa), __high2float(wa), __low2float(wb)};
    const float wc1[3] = {__high2float(wb), __low2float(wc), __high2float(wc)};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r0[c] += bf16_lo(lo) * wc0[c] + bf16_hi(lo) * wc1[c];
      r1[c] += bf16_lo(hi) * wc0[c] + bf16_hi(hi) * wc1[c];
    }
  }
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r0[c] += __shfl_xor_sync(0xffffffffu, r0[c], m);
      r1[c] += __shfl_xor_sync(0xffffffffu, r1[c], m);
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, m);
    s1 += __shfl_xor_sync(0xffffffffu, s1, m);
  }
  if (q == 0) {
    const long long row = row0 + warp * 16 + (lane >> 2);
    const float* br = bias + OFF_BR;
    const float ba = bias[OFF_BA];
    if (row < P)
      *reinterpret_cast<float4*>(out + row * 4) =
          make_float4(r0[0] + br[0], r0[1] + br[1], r0[2] + br[2], s0 + ba);
    if (row + 8 < P)
      *reinterpret_cast<float4*>(out + (row + 8) * 4) =
          make_float4(r1[0] + br[0], r1[1] + br[1], r1[2] + br[2], s1 + ba);
  }
}

// Writes this warpgroup's 64 points' encodings into slabs 0-7 (xyz, 64
// columns: x, sin, cos, 0) and 40-43 (dir, 32 columns: d, sin, cos, 0s).
// Two threads a point: part 0 takes the inputs and the low bands, part 1 the
// high bands and the padding.
__device__ __forceinline__ void encode_tile(const float* __restrict__ pts,
                                            const float* __restrict__ dirs, long long row0,
                                            int P, unsigned char* act) {
  const int t = threadIdx.x & 127, p = t & 63, part = t >> 6;
  float x[3], v[3];
  const long long g = row0 + p;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    x[j] = g < P ? pts[g * 3 + j] : 0.0f;
    v[j] = g < P ? dirs[g * 3 + j] : 0.0f;
  }
  unsigned char* rowp = act + (p >> 3) * 128 + (p & 7) * 16;
  auto put = [&](int slab0, int col, float val) {
    *reinterpret_cast<bf16*>(rowp + (slab0 + col / 8) * SLAB + (col % 8) * 2) =
        __float2bfloat16_rn(val);
  };
  if (part == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      put(SLAB_EX, j, x[j]);
      put(SLAB_ED, j, v[j]);
    }
  } else {
    put(SLAB_EX, EX - 1, 0.0f);
#pragma unroll
    for (int c = 3 + 6 * DF; c < ED; ++c) put(SLAB_ED, c, 0.0f);
  }
  const int fx0 = part * (XF / 2), fd0 = part * (DF / 2);
#pragma unroll
  for (int f = 0; f < XF / 2; ++f) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s, c;
      sincosf(x[j] * static_cast<float>(1 << (fx0 + f)), &s, &c);  // exact f32 phase
      put(SLAB_EX, 3 + 3 * (fx0 + f) + j, s);
      put(SLAB_EX, 3 + 3 * XF + 3 * (fx0 + f) + j, c);
    }
  }
#pragma unroll
  for (int f = 0; f < DF / 2; ++f) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s, c;
      sincosf(v[j] * static_cast<float>(1 << (fd0 + f)), &s, &c);
      put(SLAB_ED, 3 + 3 * (fd0 + f) + j, s);
      put(SLAB_ED, 3 + 3 * DF + 3 * (fd0 + f) + j, c);
    }
  }
}

// The warpgroup's stores to its tile become visible to its next products.
__device__ __forceinline__ void tile_written(int wg) {
  fence_async_smem();
  named_barrier(1 + wg, 128);
}

// Shared set-up of both kernels below: biases to shared memory (when given),
// the ring's barriers. Returns (full, empty).
__device__ __forceinline__ void setup(unsigned char* smem, const float* __restrict__ bbuf,
                                      uint64_t*& full, uint64_t*& empty) {
  full = reinterpret_cast<uint64_t*>(smem + SM_BAR);
  empty = full + STAGES;
  if (bbuf != nullptr) {
    float* bias = reinterpret_cast<float*>(smem + SM_BIAS);
    for (int i = threadIdx.x; i < BBUF_SIZE; i += NTHR) bias[i] = bbuf[i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);      // the producer's arrive.expect_tx
      mbar_init(&empty[s], 8);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NTHR, 1)
fused_nerf_wgmma_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                        const bf16* __restrict__ wpack, const bf16* __restrict__ wbuf,
                        const float* __restrict__ bbuf, float* __restrict__ out, int P) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t *full, *empty;
  setup(smem, bbuf, full, empty);
  const int grid = static_cast<int>(gridDim.x), block = static_cast<int>(blockIdx.x);
  const int ntiles = ((P + TILE - 1) / TILE - block + grid - 1) / grid;  // this block's tiles
  const int wg = threadIdx.x >> 7;

  // One if/else for the whole kernel: the two roles never reconverge, so
  // ptxas can honour setmaxnreg.
  if (wg == 2) {  // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * 128) produce(wpack, smem, full, empty, ntiles, NCHUNK);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const float* bias = reinterpret_cast<const float*>(smem + SM_BIAS);
    unsigned char* act = smem + SM_ACT + wg * ACT_BYTES_WG;
    const uint32_t a_ex = smem_addr(act), a_h = a_ex + SLAB_H * SLAB;
    Ring ring{smem_addr(smem), full, empty};
    Turns turns{wg, ntiles * TURNS_PER_TILE};
    if (wg == 1) named_arrive(3, 256);  // warpgroup 0 takes the first turn
    float d[128];
    for (int t = 0; t < ntiles; ++t) {
      const long long row0 =
          (static_cast<long long>(t) * grid + block) * TILE + wg * WG_ROWS;
      named_barrier(1 + wg, 128);  // every warp is done with the last tile
      encode_tile(pts, dirs, row0, P, act);
      tile_written(wg);
      float s0 = 0.0f, s1 = 0.0f;  // this thread's parts of sigma for its two rows
      // layers 0-7 of the trunk (ReLU), then the feature layer (l = 8, no
      // activation, its bias right after the trunk's); each writes over h
#pragma unroll 1
      for (int l = 0; l < 9; ++l) {
        if (l == 0) {
          layer_product<EX, W>(d, a_ex, ring, turns);
        } else if (l == 5) {  // skip: [enc_x, h] are adjacent slabs, one K = 320 product
          layer_product<EX + W, W>(d, a_ex, ring, turns);
        } else {
          layer_product<W, W>(d, a_h, ring, turns);
        }
        if (l < 8) {
          trunk_epilogue<true>(d, bias + l * W, act, l == 7, wbuf + OFF_WA, s0, s1);
        } else {
          trunk_epilogue<false>(d, bias + l * W, act, false, wbuf + OFF_WA, s0, s1);
        }
        tile_written(wg);
      }
      // view layer on [feat, enc_d] (slabs 8-43), then the rgb head
      layer_product<W + ED, VW>(d, a_h, ring, turns);
      view_epilogue(d, bias, wbuf + OFF_WR, s0, s1, out, row0, P);
    }
  }
}

// Test of layer_product alone: out[128 x 256] f32 = a[128 x 256] @ B, where
// a is row-major bf16 and w is one 256 x 256 layer in the weight stream's
// layout ([32, 256, 8] bf16). The same block, ring and descriptors as above.
__global__ void __launch_bounds__(NTHR, 1)
wgmma_layer_test_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                        float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t *full, *empty;
  setup(smem, nullptr, full, empty);
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * 128) produce(w, smem, full, empty, 1, W / KC);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    unsigned char* act = smem + SM_ACT + wg * ACT_BYTES_WG;
    for (int i = threadIdx.x & 127; i < WG_ROWS * (W / 8); i += 128) {
      const int r = i % WG_ROWS, g = i / WG_ROWS;  // 16 bytes: 8 columns of one row
      *reinterpret_cast<uint4*>(act + (SLAB_H + g) * SLAB + (r >> 3) * 128 + (r & 7) * 16) =
          *reinterpret_cast<const uint4*>(a + (wg * WG_ROWS + r) * W + g * 8);
    }
    tile_written(wg);
    Ring ring{smem_addr(smem), full, empty};
    Turns turns{wg, turns_of<W>()};
    if (wg == 1) named_arrive(3, 256);
    float d[128];
    layer_product<W, W>(d, smem_addr(act) + SLAB_H * SLAB, ring, turns);
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int row = wg * WG_ROWS + warp * 16 + (lane >> 2), q = lane & 3;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = 8 * j + 2 * q;
      *reinterpret_cast<float2*>(out + row * W + col) = make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (row + 8) * W + col) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

}  // namespace

extern "C" void fused_nerf_buffer_sizes(int* wbuf, int* bbuf, int* wpack) {
  *wbuf = WBUF_SIZE;
  *bbuf = BBUF_SIZE;
  *wpack = WPACK_SIZE;
}

// pts, dirs: [P, 3] f32; wpack: WPACK_SIZE bf16, the weight stream (16-byte
// aligned); wbuf: WBUF_SIZE bf16 (for the heads); bbuf: BBUF_SIZE f32;
// out: [P, 4] f32 (16-byte aligned). Returns the CUDA error code.
extern "C" int launch_fused_nerf(const void* pts, const void* dirs, const void* wpack,
                                 const void* wbuf, const void* bbuf, void* out, int P,
                                 void* stream) {
  // above 48 KB of dynamic shared memory a kernel must opt in (per device)
  cudaError_t e = cudaFuncSetAttribute(fused_nerf_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (P <= 0) return 0;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int tiles = (P + TILE - 1) / TILE;
  fused_nerf_wgmma_kernel<<<tiles < sms ? tiles : sms, NTHR, WG_SMEM, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)dirs, (const bf16*)wpack, (const bf16*)wbuf,
      (const float*)bbuf, (float*)out, P);
  return (int)cudaGetLastError();
}

// The previous forward (fused_mlp.cuh, nvcuda::wmma, 64-point blocks), kept as
// the yardstick of the kernel above. Same arguments but wpack.
extern "C" int launch_fused_nerf_wmma(const void* pts, const void* dirs, const void* wbuf,
                                      const void* bbuf, void* out, int P, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_nerf_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  if (P <= 0) return 0;
  const int blocks = (P + TP - 1) / TP;
  fused_nerf_kernel<false><<<blocks, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)dirs, (const bf16*)wbuf, (const float*)bbuf,
      (float*)out, P, nullptr);
  return (int)cudaGetLastError();
}

// a: [128, 256] bf16 row-major; w: [32, 256, 8] bf16 (one layer of the weight
// stream); out: [128, 256] f32. Returns the CUDA error code.
extern "C" int launch_wgmma_layer_test(const void* a, const void* w, void* out, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(wgmma_layer_test_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  wgmma_layer_test_kernel<<<1, NTHR, WG_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)w, (float*)out);
  return (int)cudaGetLastError();
}
