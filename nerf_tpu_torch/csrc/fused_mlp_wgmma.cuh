// The wgmma forward of the fused frequency encoding + NeRF-MLP, shared by
// fused_mlp.cu (the serving forward, STASH = false) and fused_mlp_bwd.cu (the
// backward's recomputed forward, STASH = true, which also writes every
// layer's bf16 activations to the slab stash and the ReLU masks as bits).
// The design note is in fused_mlp.cu.
#pragma once

#include "fused_mlp.cuh"
#include "hopper.cuh"

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

// The backward's stash and masks, per block of WG_ROWS points (a point's
// row is its index % WG_ROWS, its block its index / WG_ROWS):
// - stash: its SLD columns (the order of fused_mlp.cuh) as SLD / 8 slabs of
//   SLAB bytes, [P / 64][SLD / 8][64][8] bf16: the tile's own layout, so that
//   a run of the tile's slabs is one bulk copy to a run of stash slabs;
// - masks: "h > 0" of the trunk layers' outputs h1..h8 (2,048 bytes each),
//   then of v (1,024 bytes), as each consumer thread's accumulator
//   fragment holds them: 16 (v: 8) bytes a thread, in thread order.
constexpr long long STASH_BLOCK_BYTES = (SLD / 8) * SLAB;
constexpr int MASK_LAYER_BYTES = 128 * 16;
constexpr long long MASK_BLOCK_BYTES = 8 * MASK_LAYER_BYTES + 128 * 8;  // 17,408: 272 a point

// This thread's mask words of layer l (0-7: the trunk; 8: the view layer)
// in the mask block at mblk.
__device__ __forceinline__ uint32_t* mask_words(unsigned char* mblk, int l) {
  const int t = threadIdx.x & 127;
  return reinterpret_cast<uint32_t*>(mblk + l * MASK_LAYER_BYTES + (l < 8 ? 16 : 8) * t);
}

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

// d[64 x N] = act[64 x K] @ B[K x N] (ACC: d +=): act from the warpgroup's
// slabs starting at a_base (shared address), B chunk after chunk from the
// ring, in turns. Within a turn one chunk's products are in flight while the
// next chunk's are issued; each stage is released as soon as its products
// are done.
template <int K, int N, bool ACC = false, int R>
__device__ __forceinline__ void layer_product(float (&d)[R], uint32_t a_base, Ring& ring,
                                              Turns& turns) {
  constexpr int NCH = (K + KC - 1) / KC;
  constexpr uint32_t B_SLAB = N * 16;  // 8 K-values of every column
  if constexpr (ACC) {
    fence_acc(d);
  } else {
    fence_acc_start(d);  // d is free between the last epilogue and here
  }
  a_base = opaque(a_base);  // A's descriptors are formed here, not kept across tiles
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
        wgmma_bf16<N>(d, da, db, ACC || ch + ks > 0);
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
  if (sigma) wa = opaque(wa);  // its addresses are formed here, each tile
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
// summed over the 4 lanes of a row; lane 0 of the four writes out[row]
// (unless out is null). With vact, v is also stored into the 16 slabs there.
__device__ __forceinline__ void view_epilogue(const float (&d)[128], const float* bias,
                                              const bf16* __restrict__ wr, float s0, float s1,
                                              float* __restrict__ out, long long row0, int P,
                                              unsigned char* vact = nullptr) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int q = lane & 3;
  wr = opaque(wr);  // its 16 column addresses are formed here, each tile
  float r0[3] = {0.0f, 0.0f, 0.0f}, r1[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < VW / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const float2 b = *reinterpret_cast<const float2*>(bias + OFF_BV + col);
    const uint32_t lo = pack_bf16<true>(d[4 * j] + b.x, d[4 * j + 1] + b.y);
    const uint32_t hi = pack_bf16<true>(d[4 * j + 2] + b.x, d[4 * j + 3] + b.y);
    if (vact != nullptr) {
      unsigned char* dst = vact + j * SLAB + warp * 256 + (lane >> 2) * 16 + q * 4;
      *reinterpret_cast<uint32_t*>(dst) = lo;
      *reinterpret_cast<uint32_t*>(dst + 128) = hi;
    }
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
  if (out == nullptr) return;
#pragma unroll
  for (int mm = 1; mm <= 2; mm <<= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r0[c] += __shfl_xor_sync(0xffffffffu, r0[c], mm);
      r1[c] += __shfl_xor_sync(0xffffffffu, r1[c], mm);
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, mm);
    s1 += __shfl_xor_sync(0xffffffffu, s1, mm);
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

// Stores this thread's bits "h > 0" of the NJ slabs of the tile at slabs
// (its own accumulator fragment's elements, as an epilogue stored them) to
// mask as NJ / 8 words: bit 4(j % 8) + e of word j / 8 is the element of
// d[4j + e] (mask_bits in ops/fused_mlp_bwd.py is the layout's plain
// version). Read back from shared memory once the accumulator is dead, so
// the epilogue itself is B1's.
template <int NJ>
__device__ __forceinline__ void mask_bits_of(const unsigned char* slabs, uint32_t* __restrict__ mask) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const unsigned char* src = slabs + warp * 256 + (lane >> 2) * 16 + (lane & 3) * 4;
#pragma unroll
  for (int w = 0; w < NJ / 8; ++w) {
    uint32_t m = 0u;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const unsigned char* p = src + (8 * w + jj) * SLAB;
      const uint32_t lo = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t hi = *reinterpret_cast<const uint32_t*>(p + 128);
      m |= (positive_bits(lo) | positive_bits(hi) << 2) << (4 * jj);
    }
    mask[w] = m;
  }
}

// A warpgroup's leader thread waits until its bulk stores have read their
// shared-memory slabs; then the warpgroup may write over them.
__device__ __forceinline__ void stores_read(int wg) {
  if ((threadIdx.x & 127) == 0) bulk_wait_read<0>();
  named_barrier(1 + wg, 128);
}

// The leader's bulk store of nslabs slabs of the tile (from slab a) to the
// stash block (from slab s), in a group of its own.
__device__ __forceinline__ void stash_slabs(unsigned char* sblk, int s, const unsigned char* act,
                                            int a, int nslabs) {
  if ((threadIdx.x & 127) != 0) return;
  bulk_store(sblk + s * SLAB, act + a * SLAB, nslabs * SLAB);
  bulk_commit();
}

// STASH = false: the serving forward, out [P, 4]. STASH = true: the same
// forward (the same products, epilogues and roundings, so the same bits),
// which also stores each 64-point block's activations to the slab stash
// (stash_block) and its ReLU masks as bits (masks_block), as the backward
// reads them; out may then be null, and P must be a multiple of TILE.
template <bool STASH>
__global__ void __launch_bounds__(NTHR, 1)
fused_nerf_wgmma_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                        const bf16* __restrict__ wpack, const bf16* __restrict__ wbuf,
                        const float* __restrict__ bbuf, float* __restrict__ out, int P,
                        bf16* __restrict__ stash, unsigned char* __restrict__ masks) {
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
      // this warpgroup's stash and mask blocks, formed where used
      auto sblk = [&] {
        return reinterpret_cast<unsigned char*>(stash) + (row0 / WG_ROWS) * STASH_BLOCK_BYTES;
      };
      auto mblk = [&] { return masks + (row0 / WG_ROWS) * MASK_BLOCK_BYTES; };
      named_barrier(1 + wg, 128);  // every warp is done with the last tile
      encode_tile(pts, dirs, row0, P, act);
      tile_written(wg);
      if (STASH) {
        stash_slabs(sblk(), S_EX / 8, act, SLAB_EX, EX / 8);
        stash_slabs(sblk(), S_ED / 8, act, SLAB_ED, ED / 8);
        stores_read(wg);  // here, where no accumulator is live
      }
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
        if (STASH) {  // d is free here: the bits, then the slabs to the stash
          if (l < 8) mask_bits_of<W / 8>(act + SLAB_H * SLAB, mask_words(mblk(), l));
          stash_slabs(sblk(), (l < 8 ? s_h(l) : S_FEAT) / 8, act, SLAB_H, W / 8);
          stores_read(wg);
        }
      }
      // view layer on [feat, enc_d] (slabs 8-43), then the rgb head
      layer_product<W + ED, VW>(d, a_h, ring, turns);
      if (STASH) {  // v goes to slabs 0-15 and on to the stash
        view_epilogue(d, bias, wbuf + OFF_WR, s0, s1, out, row0, P, act);
        tile_written(wg);
        mask_bits_of<VW / 8>(act, mask_words(mblk(), 8));
        stash_slabs(sblk(), S_V / 8, act, 0, VW / 8);
        stores_read(wg);
      } else {
        view_epilogue(d, bias, wbuf + OFF_WR, s0, s1, out, row0, P);
      }
    }
    if (STASH && (threadIdx.x & 127) == 0) bulk_wait_all();  // the last stores' writes
  }
}

}  // namespace
