// Backward of the fused frequency encoding + NeRF-MLP for Hopper (sm_90a):
// wgmma products over bulk-copied slabs, in three launches and two small ones.
//
// Replaces the Pallas TPU kernel nerf_tpu/ops/fused_mlp_bwd.py:43 (_bwd_kernel).
// Plain PyTorch version: nerf_tpu_torch/ops/fused_mlp_bwd.py::fused_nerf_bwd_plain.
//
// What it computes: given pts, dirs [P, 3] and the upstream gradient g [P, 4]
// of raw = [rgb, sigma], every weight and bias gradient of the packed
// buffers (wbuf, bbuf layout of fused_mlp.cuh, f32, summed over all P) and,
// on request, dpts and ddirs [P, 3].
//
// What bounds it on an H100: operations. The two products of each layer
// (dX = G @ W^T and dW = X^T @ G) and the recomputed forward are ~1.74 M MACs
// a point (the train step asks for no input gradients): 0.69 ms for the
// 196,608-point fine pass of a lego train step at 989 TFLOP/s. This design
// also moves bytes through device memory between its launches: the stash
// (2,528 bf16 a point) and the layer gradients gbuf (2,432 bf16 a point),
// each written once and read once by dW, plus 272 bytes of mask bits:
// ~20.4 KB a point, 4.0 GB on the fine pass, ~1.2 ms at 3.35 TB/s. So the
// design's floor is that byte floor, above the operation bound.
//
// Why not the TPU kernel's shape: it accumulates all 597k gradients in VMEM
// across a sequential grid. Here blocks run in parallel in no order and the
// gradients (2.4 MB f32) do not fit one SM, so the work is split:
//   1. fused_nerf_wgmma_kernel<true> (fused_mlp_wgmma.cuh): the forward
//      again, B1's own code (so its raw equals launch_fused_nerf's bit for
//      bit), which also bulk-stores every layer's bf16 activations to the
//      stash and writes the ReLU masks of h1..h8 and v as bits.
//   2. bwd_chain_wgmma_kernel: B1's skeleton (persistent 128-point tiles,
//      two consumer warpgroups of 64 points taking turns, one producer thread,
//      a 4-stage ring of 32 KB chunks) streaming wpack_bwd, each layer's W^T
//      in the K-major canonical layout, in chain order. Per layer: the G tile
//      (the warpgroup's shared slabs) times W^T on wgmma m64n256k16; the
//      epilogue in registers adds the sigma head's dsigma x wa (to G_7),
//      applies the forward's mask bits (the tile's 17 KB of bits are
//      bulk-copied to shared memory at its start), rounds to bf16, stores
//      the next layer's G over the tile and bulk-stores it to gbuf. The rgb
//      head (dv = drgb wr^T, masked by v > 0) is its prologue.
//   2'. bwd_input_wgmma_kernel, only with input gradients (the train step
//      asks for none): per 64 points, the encoding columns' f32 gradients
//      G_0 W0x^T + G_5 W5x^T and G_view Wvd^T on wgmma from gbuf's slabs,
//      then dpts, ddirs through the phases in exact f32. (In the chain
//      their 48 accumulator registers spilled.)
//   3. wgrad_wgmma_kernel: dW_l = X_l^T G_l for every matrix layer, persistent
//      over one range of the points: a block owns 64 (one warpgroup) or 128
//      (two) rows of one layer's dW and all its N columns, and walks its
//      range 64 points a stage; the producer bulk-copies the X and G slabs
//      of the stage (both operands MN-major: wgmma's transpose bits). The
//      block of a layer's first rows also sums G's columns (the bias
//      gradients) from the same stages. `splits` ranges (one wave of blocks
//      on 132 SMs at 6) write f32 partials.
//   4. head_wgrad_kernel: the sigma (N=1) and rgb (N=3) heads' gradients
//      from the h8 and v slabs of the stash (bulk-copied, two stages) and g,
//      scalar work, into partials of their own over `head_splits` ranges.
//   5. reduce_kernel: the sum of the partials over the ranges, in a fixed
//      order, so two launches give the same bits.
//
// Layouts (per block of 64 points; fused_mlp_wgmma.cuh): the stash
// [P/64][SLD/8][64][8] bf16 and gbuf [P/64][GLD/8][64][8] bf16, whose
// 8 columns of 8 points are one 128-byte core matrix, so every load and
// store of them is a 1-D bulk copy of whole slabs; the mask bits in the
// consumer threads' fragment order.
//
// Precision: every product takes bf16 operands (the stash holds the bf16
// activations the forward multiplied; G is rounded to bf16) and sums in f32.
// The bias sums add the bf16 G in f32. The heads take g in f32 and the
// weights as their bf16 values. The plain version rounds at the same places.
// P must be a multiple of 128 (the wrapper pads with zero gradients).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers; bound with ctypes).

#include "fused_mlp_wgmma.cuh"

namespace {

// layer gradients gbuf, GLD bf16 columns a point: G_l (pre-activation
// gradient of trunk layer l) at l * W, then the feature and the view layer
constexpr int G_FEAT = 8 * W;          // 2048
constexpr int G_VIEW = G_FEAT + W;     // 2304
constexpr int GLD = G_VIEW + VW;       // 2432 columns
constexpr long long GBUF_BLOCK_BYTES = (GLD / 8) * SLAB;

// partials: [splits, PST] f32, weights in wbuf order then biases at WBUF_SIZE
constexpr int TOTAL = WBUF_SIZE + BBUF_SIZE;
constexpr int PST = (TOTAL + 63) / 64 * 64;  // 32-byte aligned rows

// The heads' entries (wa, wr, ba, br) of the flat gradient: their index in
// a row of the heads' partials (wa | wr | ba | br), or -1.
__device__ __forceinline__ int head_entry(int e) {
  if (e >= OFF_WA && e < WBUF_SIZE) return e - OFF_WA;
  if (e >= WBUF_SIZE + OFF_BA) return W + VW * 3 + e - WBUF_SIZE - OFF_BA;
  return -1;
}

// The sum of the partials over the ranges, in a fixed order: the heads'
// entries over head_splits rows of hpartial [head_splits, head_ld], the
// others over splits rows of partial.
__global__ void reduce_kernel(const float* __restrict__ partial, int splits,
                              const float* __restrict__ hpartial, int head_splits, int head_ld,
                              float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= TOTAL) return;
  const int h = head_entry(e);
  float sum = 0.0f;
  if (h >= 0) {
    for (int s = 0; s < head_splits; ++s) sum += hpartial[(size_t)s * head_ld + h];
  } else {
    for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * PST + e];
  }
  out[e] = sum;
}

// ---- 2. the dX chain ----

// The chain's weight stream wpack_bwd (ops/fused_mlp.py::pack_bwd_stream):
// W^T of each layer in wgmma's K-major layout [N/8, K, 8] (K, N the
// forward's), in chain order; the encoding parts (ENC), read only by the
// input-gradient kernel: Wvf^T [128 x 256] | Wvd^T [128 x 32] ENC | Wf^T |
// W7^T | W6^T | W5h^T | W5x^T [256 x 64] ENC | W4^T | W3^T | W2^T | W1^T |
// W0^T [256 x 64] ENC.
constexpr uint32_t BW_VF = 0;
constexpr uint32_t BW_VD = BW_VF + VW * W * 2;
constexpr uint32_t BW_F = BW_VD + VW * ED * 2;           // then wf, w7, w6, w5h
constexpr uint32_t BW_5X = BW_F + 4 * W * W * 2;
constexpr uint32_t BW_4 = BW_5X + W * EX * 2;            // then w4, w3, w2, w1
constexpr uint32_t BW_0 = BW_4 + 4 * W * W * 2;
constexpr uint32_t BW_END = BW_0 + W * EX * 2;
static_assert(BW_END == WPACK_SIZE * 2, "the backward stream holds the same matrices");
constexpr int CHAIN_TURNS = 9;                            // turns of a tile (GROUP = 4 chunks)
constexpr int SM_G = STAGES * STAGE_BYTES;                // two G tiles of 256 columns
constexpr int G_TILE = W / 8 * SLAB;                      // 32 KB
constexpr int SM_MASK = SM_G + 2 * G_TILE;                // two tiles' mask blocks
constexpr int SM_CHAIN_BAR = SM_MASK + 2 * static_cast<int>(MASK_BLOCK_BYTES);
constexpr int CHAIN_SMEM = SM_CHAIN_BAR + (2 * STAGES + 2) * 8;
static_assert(CHAIN_SMEM <= 232448, "shared memory of one block");

// The chain's producer: the stream's non-encoding chunks in chain order,
// once per tile.
__device__ __forceinline__ void produce_chain(const bf16* __restrict__ wpack_bwd,
                                              unsigned char* ring, uint64_t* full,
                                              uint64_t* empty, int ntiles) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(wpack_bwd);
  uint32_t c = 0;  // chunks issued so far: stage c % STAGES, round c / STAGES
  for (int t = 0; t < ntiles; ++t) {
    for (int ch = 0; ch < (VW + 8 * W) / KC; ++ch, ++c) {
      const uint32_t off = ch < VW / KC ? BW_VF + ch * STAGE_BYTES
                           : ch < (VW + 4 * W) / KC ? BW_F + (ch - VW / KC) * STAGE_BYTES
                                                    : BW_4 + (ch - (VW + 4 * W) / KC) * STAGE_BYTES;
      const uint32_t s = c % STAGES;
      mbar_wait(&empty[s], ((c / STAGES) & 1) ^ 1);  // the first round passes at once
      mbar_expect_tx(&full[s], STAGE_BYTES);
      bulk_copy(ring + s * STAGE_BYTES, src + off, STAGE_BYTES, &full[s]);
    }
  }
}

// The leader's bulk store of nslabs G slabs of the tile to gbuf column col.
__device__ __forceinline__ void store_g(unsigned char* gblk, int col, const unsigned char* gt,
                                        int nslabs) {
  if ((threadIdx.x & 127) != 0) return;
  bulk_store(gblk + (col / 8) * SLAB, gt, nslabs * SLAB);
  bulk_commit();
}


// This thread's 4 mask words of a layer (the layout of trunk_epilogue's
// bits) from the bf16 stash block's columns scol.., the activations' signs,
// for tools/bwd_variants.py's stash_masks variant.
__device__ __forceinline__ void mask_from_stash(const unsigned char* sblk, int scol,
                                                uint32_t (&m)[4]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const unsigned char* src = sblk + (scol / 8) * SLAB + warp * 256 + (lane >> 2) * 16 +
                             (lane & 3) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = 0u;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const uint32_t lo = __ldg(reinterpret_cast<const unsigned int*>(src + j * SLAB));
    const uint32_t hi = __ldg(reinterpret_cast<const unsigned int*>(src + j * SLAB + 128));
    m[j / 8] |= (positive_bits(lo) | positive_bits(hi) << 2) << (4 * (j % 8));
  }
}

// Chain epilogue: G = bf16(d [+ dsigma wa] [masked by the words at mw, this
// thread's 4 in shared memory, read one at a time]) over the G tile, in the
// accumulator's fragment layout (as trunk_epilogue stores h).
template <bool SIGMA>
__device__ __forceinline__ void chain_epilogue(const float (&d)[128], unsigned char* gt,
                                               const uint32_t* mw, float ds0, float ds1,
                                               const bf16* __restrict__ wa) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int q = lane & 3;
  unsigned char* dst = gt + warp * 256 + (lane >> 2) * 16 + q * 4;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    float v0 = d[4 * j], v1 = d[4 * j + 1], v2 = d[4 * j + 2], v3 = d[4 * j + 3];
    if (SIGMA) {
      const __nv_bfloat162 w2 = __ldg(reinterpret_cast<const __nv_bfloat162*>(wa + 8 * j + 2 * q));
      const float w0 = __low2float(w2), w1 = __high2float(w2);
      v0 += ds0 * w0;
      v1 += ds0 * w1;
      v2 += ds1 * w0;
      v3 += ds1 * w1;
    }
    if (mw != nullptr) {
      const uint32_t b = mw[j / 8] >> (4 * (j % 8));
      v0 = (b & 1u) ? v0 : 0.0f;
      v1 = (b & 2u) ? v1 : 0.0f;
      v2 = (b & 4u) ? v2 : 0.0f;
      v3 = (b & 8u) ? v3 : 0.0f;
    }
    *reinterpret_cast<uint32_t*>(dst + j * SLAB) = pack_bf16<false>(v0, v1);
    *reinterpret_cast<uint32_t*>(dst + j * SLAB + 128) = pack_bf16<false>(v2, v3);
  }
}

// The chain's prologue, the rgb head: G_view = bf16((drgb wr^T) masked by
// v > 0) over the first 16 slabs of the G tile. ga, gb: g of the thread's
// two rows.
__device__ __forceinline__ void rgb_head(unsigned char* gt, unsigned char* msm, float4 ga,
                                         float4 gb, const bf16* __restrict__ wr) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int q = lane & 3;
  const uint2 mv = *reinterpret_cast<const uint2*>(mask_words(msm, 8));
  unsigned char* dst = gt + warp * 256 + (lane >> 2) * 16 + q * 4;
#pragma unroll
  for (int j = 0; j < VW / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(wr + col * 3);
    const __nv_bfloat162 wa = __ldg(w2), wb = __ldg(w2 + 1), wc = __ldg(w2 + 2);
    const float c0[3] = {__low2float(wa), __high2float(wa), __low2float(wb)};  // wr[col]
    const float c1[3] = {__high2float(wb), __low2float(wc), __high2float(wc)};  // wr[col + 1]
    const uint32_t b = (j < 8 ? mv.x : mv.y) >> (4 * (j % 8));
    const float v0 = ga.x * c0[0] + ga.y * c0[1] + ga.z * c0[2];
    const float v1 = ga.x * c1[0] + ga.y * c1[1] + ga.z * c1[2];
    const float v2 = gb.x * c0[0] + gb.y * c0[1] + gb.z * c0[2];
    const float v3 = gb.x * c1[0] + gb.y * c1[1] + gb.z * c1[2];
    *reinterpret_cast<uint32_t*>(dst + j * SLAB) =
        pack_bf16<false>((b & 1u) ? v0 : 0.0f, (b & 2u) ? v1 : 0.0f);
    *reinterpret_cast<uint32_t*>(dst + j * SLAB + 128) =
        pack_bf16<false>((b & 4u) ? v2 : 0.0f, (b & 8u) ? v3 : 0.0f);
  }
}

// Per 128-point tile and consumer warpgroup (64 points): the rgb head, the
// view layer's dX (feat), then the feature layer with the sigma head and
// trunk layers 7..1, each G -> the next G through the forward's masks.
__global__ void __launch_bounds__(NTHR, 1)
bwd_chain_wgmma_kernel(const float* __restrict__ g, const bf16* __restrict__ wpack_bwd,
                       const bf16* __restrict__ wbuf, const bf16* __restrict__ stash,
                       unsigned char* __restrict__ masks, bf16* __restrict__ gbuf, int P) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM_CHAIN_BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* mbar = empty + STAGES;  // one per consumer warpgroup: its mask block arrived
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive.expect_tx
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(&mbar[0], 1);
    mbar_init(&mbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int grid = static_cast<int>(gridDim.x), block = static_cast<int>(blockIdx.x);
  const int ntiles = (P / TILE - block + grid - 1) / grid;  // this block's tiles
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {  // producer warpgroup: one thread issues every weight copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * 128) produce_chain(wpack_bwd, smem, full, empty, ntiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    unsigned char* gt = smem + SM_G + wg * G_TILE;
    unsigned char* msm = smem + SM_MASK + wg * MASK_BLOCK_BYTES;
    const uint32_t a_g = smem_addr(gt);
    const bool leader = (threadIdx.x & 127) == 0;
    Ring ring{smem_addr(smem), full, empty};
    Turns turns{wg, ntiles * CHAIN_TURNS};
    if (wg == 1) named_arrive(3, 256);  // warpgroup 0 takes the first turn
    float d[128];
    for (int t = 0; t < ntiles; ++t) {
      const long long row0 =
          (static_cast<long long>(t) * grid + block) * TILE + wg * WG_ROWS;
      const long long blk = row0 / WG_ROWS;
      unsigned char* gblk = reinterpret_cast<unsigned char*>(gbuf) + blk * GBUF_BLOCK_BYTES;
      const long long r0 = row0 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
      stores_read(wg);  // the last tile's gbuf stores have read the G tile
      if (leader) {  // the tile's mask bits, 17 KB, into shared memory
        mbar_expect_tx(&mbar[wg], MASK_BLOCK_BYTES);
        bulk_copy(msm, masks + blk * MASK_BLOCK_BYTES, MASK_BLOCK_BYTES, &mbar[wg]);
      }
      mbar_wait(&mbar[wg], t & 1);
      rgb_head(gt, msm, __ldg(reinterpret_cast<const float4*>(g) + r0),
               __ldg(reinterpret_cast<const float4*>(g) + r0 + 8), wbuf + OFF_WR);
      tile_written(wg);
      store_g(gblk, G_VIEW, gt, VW / 8);
      // the view layer [feat, enc_d] <- G_view: feat's gradient (no activation)
      layer_product<VW, W>(d, a_g, ring, turns);
      stores_read(wg);
      chain_epilogue<false>(d, gt, nullptr, 0.0f, 0.0f, wbuf);
      tile_written(wg);
      store_g(gblk, G_FEAT, gt, W / 8);
      // l = 8: the feature layer and the sigma head -> h8, masked: G_7; then
      // trunk layers l = 7..1, each G_l -> G_{l-1} through h_l's mask
#pragma unroll 1
      for (int l = 8; l >= 1; --l) {
        layer_product<W, W>(d, a_g, ring, turns);
        const uint32_t* mw = mask_words(msm, l - 1);
        stores_read(wg);
        if (l == 8) {  // dsigma of the thread's two rows
          chain_epilogue<true>(d, gt, mw, __ldg(g + 4 * r0 + 3), __ldg(g + 4 * r0 + 35),
                               wbuf + OFF_WA);
        } else {
          chain_epilogue<false>(d, gt, mw, 0.0f, 0.0f, wbuf);
        }
        tile_written(wg);
        store_g(gblk, (l - 1) * W, gt, W / 8);
      }
    }
    if (leader) bulk_wait_all();
  }
}

// ---- 2'. the input gradients (only when asked for) ----

// The encoding columns' gradients of the 64 points of block blockIdx.x, in
// f32: enc_x = G_0 W0^T + G_5 W5x^T (m64n64), enc_d = G_view Wvd^T (m64n32),
// on wgmma from G slabs and weights bulk-copied to shared memory; then
// dpts, ddirs through the phases in exact f32.
constexpr int IN_G0 = 0, IN_G5 = IN_G0 + G_TILE, IN_GV = IN_G5 + G_TILE;
constexpr int IN_W0 = IN_GV + VW / 8 * SLAB, IN_W5 = IN_W0 + W * EX * 2;
constexpr int IN_WV = IN_W5 + W * EX * 2, IN_DENC = IN_WV + VW * ED * 2;
constexpr int IN_BAR = IN_DENC + WG_ROWS * (EX + ED) * 4;
constexpr int INPUT_SMEM = IN_BAR + 8;
static_assert(INPUT_SMEM <= 232448, "shared memory of one block");

// acc[64 x N] (+)= A[64 x K] B[K x N], both in shared memory: A in slabs, B
// in the K-major layout [K/8, N, 8].
template <int K, int N, int R>
__device__ __forceinline__ void smem_product(float (&acc)[R], uint32_t a, uint32_t b, bool start) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks)
    wgmma_bf16<N>(acc, smem_desc(a + ks * 2 * SLAB, SLAB, 128),
                  smem_desc(b + ks * 2 * N * 16, N * 16, 128), ks > 0 || !start);
}

__global__ void __launch_bounds__(128)
bwd_input_wgmma_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                       const bf16* __restrict__ wpack_bwd, const bf16* __restrict__ gbuf,
                       float* __restrict__ dpts, float* __restrict__ ddirs) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + IN_BAR);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long blk = blockIdx.x;
  if (threadIdx.x == 0) {
    const unsigned char* gb = reinterpret_cast<const unsigned char*>(gbuf) + blk * GBUF_BLOCK_BYTES;
    const unsigned char* wb = reinterpret_cast<const unsigned char*>(wpack_bwd);
    mbar_expect_tx(bar, IN_DENC);
    bulk_copy(smem + IN_G0, gb, G_TILE, bar);
    bulk_copy(smem + IN_G5, gb + (5 * W / 8) * SLAB, G_TILE, bar);
    bulk_copy(smem + IN_GV, gb + (G_VIEW / 8) * SLAB, VW / 8 * SLAB, bar);
    bulk_copy(smem + IN_W0, wb + BW_0, W * EX * 2, bar);
    bulk_copy(smem + IN_W5, wb + BW_5X, W * EX * 2, bar);
    bulk_copy(smem + IN_WV, wb + BW_VD, VW * ED * 2, bar);
  }
  float ex[32], ed[16];
  mbar_wait(bar, 0);
  const uint32_t base = smem_addr(smem);
  fence_acc_start(ex);
  fence_acc_start(ed);
  wgmma_fence();
  smem_product<W, EX>(ex, base + IN_G0, base + IN_W0, true);
  smem_product<W, EX>(ex, base + IN_G5, base + IN_W5, false);
  smem_product<VW, ED>(ed, base + IN_GV, base + IN_WV, true);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(ex);
  fence_acc(ed);
  const long long row0 = blk * WG_ROWS;
  constexpr int DLD = EX + ED;
  float* denc = reinterpret_cast<float*>(smem + IN_DENC);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < EX / 8; ++j) {
    *reinterpret_cast<float2*>(denc + r * DLD + 8 * j + c) = make_float2(ex[4 * j], ex[4 * j + 1]);
    *reinterpret_cast<float2*>(denc + (r + 8) * DLD + 8 * j + c) =
        make_float2(ex[4 * j + 2], ex[4 * j + 3]);
  }
#pragma unroll
  for (int j = 0; j < ED / 8; ++j) {
    *reinterpret_cast<float2*>(denc + r * DLD + EX + 8 * j + c) =
        make_float2(ed[4 * j], ed[4 * j + 1]);
    *reinterpret_cast<float2*>(denc + (r + 8) * DLD + EX + 8 * j + c) =
        make_float2(ed[4 * j + 2], ed[4 * j + 3]);
  }
  __syncthreads();
  // d/dx of [x, sin(x 2^f), cos(x 2^f)]: the phases again in exact f32
  for (int i = threadIdx.x; i < WG_ROWS * 3; i += 128) {
    const int p = i / 3, k = i % 3;
    const long long gi = row0 * 3 + i;
    const float* de = denc + p * DLD;
    const float x = pts[gi], v = dirs[gi];
    float acc = de[k];
#pragma unroll
    for (int f = 0; f < XF; ++f) {
      float s, co;
      sincosf(x * static_cast<float>(1 << f), &s, &co);
      acc += static_cast<float>(1 << f) * (co * de[3 + f * 3 + k] - s * de[3 + 3 * XF + f * 3 + k]);
    }
    dpts[gi] = acc;
    const float* dd = de + EX;
    float accd = dd[k];
#pragma unroll
    for (int f = 0; f < DF; ++f) {
      float s, co;
      sincosf(v * static_cast<float>(1 << f), &s, &co);
      accd += static_cast<float>(1 << f) * (co * dd[3 + f * 3 + k] - s * dd[3 + 3 * DF + f * 3 + k]);
    }
    ddirs[gi] = accd;
  }
}

}  // namespace

namespace {

// ---- 3. weight gradients ----

struct Layer {
  int xcol, K, gcol, N, woff, boff;  // stash column, dW rows, gbuf column, dW columns
};
constexpr int NLAYERS = 10;
__constant__ Layer kLayers[NLAYERS] = {
    {S_EX, EX, 0 * W, W, OFF_W0, 0 * W},
    {s_h(0), W, 1 * W, W, OFF_W1, 1 * W},
    {s_h(1), W, 2 * W, W, OFF_W2, 2 * W},
    {s_h(2), W, 3 * W, W, OFF_W3, 3 * W},
    {s_h(3), W, 4 * W, W, OFF_W4, 4 * W},
    {S_EX, EX + W, 5 * W, W, OFF_W5, 5 * W},
    {s_h(5), W, 6 * W, W, OFF_W6, 6 * W},
    {s_h(6), W, 7 * W, W, OFF_W7, 7 * W},
    {s_h(7), W, G_FEAT, W, OFF_WF, OFF_BF},
    {S_FEAT, W + ED, G_VIEW, VW, OFF_WV, OFF_BV},
};
// A block's work: 64 dW rows of a layer from m0 for warpgroup 0, from m1
// for warpgroup 1 (-1: none); the layer's K rows in 64-row tiles, paired.
struct Item {
  int layer, m0, m1;
};
constexpr int NITEMS = 21;
__constant__ Item kItems[NITEMS] = {
    {0, 0, -1},   {1, 0, 64},   {1, 128, 192}, {2, 0, 64},   {2, 128, 192}, {3, 0, 64},
    {3, 128, 192}, {4, 0, 64},  {4, 128, 192}, {5, 0, 64},   {5, 128, 192}, {5, 256, -1},
    {6, 0, 64},   {6, 128, 192}, {7, 0, 64},   {7, 128, 192}, {8, 0, 64},   {8, 128, 192},
    {9, 0, 64},   {9, 128, 192}, {9, 256, -1}};
constexpr int WG_A_BYTES = 8 * SLAB;                  // 64 dW rows of 64 points: 8 KB
constexpr int WG_STAGE = 2 * WG_A_BYTES + W / 8 * SLAB;  // A0 | A1 | B: 48 KB
constexpr int WG_STAGES = 4;
constexpr int SM_WG_BAR = WG_STAGES * WG_STAGE;
constexpr int WGRAD_SMEM = SM_WG_BAR + 2 * WG_STAGES * 8;
static_assert(WGRAD_SMEM <= 232448, "shared memory of one block");

// acc[64 x N] (+)= A^T B over one stage of 64 points (start: the sum starts
// at zero, so no instruction but a wgmma defines acc): A the warpgroup's X
// slabs (8 columns x 64 points each, so A(k, p) is MN-major), B the G slabs
// (B(p, n), MN-major too). Core matrices: 8 points apart 128 bytes (lbo),
// 8 columns apart one slab (sbo).
template <int N>
__device__ __forceinline__ void wgrad_stage(float (&acc)[128], uint32_t a, uint32_t b,
                                            bool start) {
#pragma unroll
  for (int ks = 0; ks < WG_ROWS / 16; ++ks) {
    const uint64_t da = smem_desc(a + ks * 2 * 128, 128, SLAB);
    const uint64_t db = smem_desc(b + ks * 2 * 128, 128, SLAB);
    wgmma_bf16<N, 1, 1>(acc, da, db, ks > 0 || !start);
  }
}

// This thread's sums of G over one stage, for the bias gradient: 8 columns
// (slab t / 8 of the B slabs) of the 8 points (t % 8) * 8.. of the stage,
// each row read starting at another 16 bytes so that the 8 threads of a
// slab touch every bank once.
__device__ __forceinline__ void bias_stage(float (&bs)[8], const unsigned char* bslabs, int t) {
  const unsigned char* src = bslabs + (t / 8) * SLAB + (t % 8) * 128;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + ((r + t) % 8) * 16);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bs[2 * i] += bf16_lo(w[i]);
      bs[2 * i + 1] += bf16_hi(w[i]);
    }
  }
}

// The consumer's walk over its stages: acc += A^T B for each (work: this
// warpgroup has rows of its own) and, with bias, the sums of G's columns.
// ptxas reports the products serialized here (C7518, wgmma in a branch it
// cannot prove uniform); a version without the branch, which it did not
// serialize, ran slower on the card.
template <int N>
__device__ __forceinline__ void wgrad_consume(float (&acc)[128], float (&bs)[8], uint32_t base,
                                              const unsigned char* smem, uint64_t* full,
                                              uint64_t* empty, int nstages, int wg, bool work,
                                              bool bias) {
  const int t = threadIdx.x & 255;
  for (int c = 0; c < nstages; ++c) {
    const uint32_t s = c % WG_STAGES;
    mbar_wait(&full[s], (c / WG_STAGES) & 1);
    const uint32_t st = base + s * WG_STAGE;
    if (work) {
      fence_acc(acc);
      wgmma_fence();
      wgrad_stage<N>(acc, st + wg * WG_A_BYTES, st + 2 * WG_A_BYTES, false);
      wgmma_commit();
    }
    if (bias && t < N) bias_stage(bs, smem + s * WG_STAGE + 2 * WG_A_BYTES, t);
    if (work) {
      wgmma_wait<1>();  // the previous stage's products are done with it
      fence_acc(acc);
    }
    if (c > 0 && (threadIdx.x & 31) == 0) mbar_arrive(&empty[(c - 1) % WG_STAGES]);
  }
  if (work) {
    wgmma_wait<0>();
    fence_acc(acc);
  }
  if (nstages > 0 && (threadIdx.x & 31) == 0) mbar_arrive(&empty[(nstages - 1) % WG_STAGES]);
}

// Block (item, range): the item's dW rows over the points of the range
// (64-point blocks [nb * r / splits, nb * (r + 1) / splits)), into partial
// row r; the bias over the same points when the item holds the layer's
// first rows.
__global__ void __launch_bounds__(NTHR, 1)
wgrad_wgmma_kernel(const bf16* __restrict__ stash, const bf16* __restrict__ gbuf,
                   float* __restrict__ partial, int P) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM_WG_BAR);
  uint64_t* empty = full + WG_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const Item it = kItems[blockIdx.x];
  const Layer L = kLayers[it.layer];
  const int nb = P / WG_ROWS, r = blockIdx.y, splits = gridDim.y;
  const int b0 = static_cast<int>(static_cast<long long>(nb) * r / splits);
  const int b1 = static_cast<int>(static_cast<long long>(nb) * (r + 1) / splits);
  const int wg = threadIdx.x >> 7;
  float* out = partial + static_cast<size_t>(r) * PST;

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 2 * 128) return;
    const unsigned char* sb = reinterpret_cast<const unsigned char*>(stash);
    const unsigned char* gb = reinterpret_cast<const unsigned char*>(gbuf);
    const uint32_t bbytes = L.N / 8 * SLAB;
    const uint32_t bytes = WG_A_BYTES * (it.m1 >= 0 ? 2 : 1) + bbytes;
    for (int b = b0; b < b1; ++b) {
      const uint32_t c = b - b0, s = c % WG_STAGES;
      mbar_wait(&empty[s], ((c / WG_STAGES) & 1) ^ 1);
      mbar_expect_tx(&full[s], bytes);
      unsigned char* st = smem + s * WG_STAGE;
      const unsigned char* sx = sb + b * STASH_BLOCK_BYTES;
      bulk_copy(st, sx + (L.xcol + it.m0) / 8 * SLAB, WG_A_BYTES, &full[s]);
      if (it.m1 >= 0)
        bulk_copy(st + WG_A_BYTES, sx + (L.xcol + it.m1) / 8 * SLAB, WG_A_BYTES, &full[s]);
      bulk_copy(st + 2 * WG_A_BYTES, gb + b * GBUF_BLOCK_BYTES + L.gcol / 8 * SLAB, bbytes,
                &full[s]);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int m = wg == 0 ? it.m0 : it.m1;
    const bool bias = it.m0 == 0;
    float acc[128], bs[8];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) bs[i] = 0.0f;
    const uint32_t base = smem_addr(smem);
    if (L.N == W) {
      wgrad_consume<W>(acc, bs, base, smem, full, empty, b1 - b0, wg, m >= 0, bias);
    } else {
      wgrad_consume<VW>(acc, bs, base, smem, full, empty, b1 - b0, wg, m >= 0, bias);
    }
    const int t = threadIdx.x & 255;
    if (bias && t < L.N) {  // the 8 threads of a slab are 8 neighbouring lanes
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        bs[i] += __shfl_xor_sync(0xffffffffu, bs[i], 1);
        bs[i] += __shfl_xor_sync(0xffffffffu, bs[i], 2);
        bs[i] += __shfl_xor_sync(0xffffffffu, bs[i], 4);
      }
      if (t % 8 == 0) {
        float* o = out + WBUF_SIZE + L.boff + t;
        *reinterpret_cast<float4*>(o) = make_float4(bs[0], bs[1], bs[2], bs[3]);
        *reinterpret_cast<float4*>(o + 4) = make_float4(bs[4], bs[5], bs[6], bs[7]);
      }
    }
    if (m < 0) return;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int row = m + warp * 16 + (lane >> 2), q = lane & 3;
    float* o = out + L.woff;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      if (8 * j < L.N) {
        const int col = 8 * j + 2 * q;
        if (row < L.K)
          *reinterpret_cast<float2*>(o + row * L.N + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
        if (row + 8 < L.K)
          *reinterpret_cast<float2*>(o + (row + 8) * L.N + col) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// ---- 4. the sigma and rgb heads ----

// wa = h8^T dsigma, wr = v^T drgb, ba, br over the 64-point blocks
// [nb s / splits, nb (s + 1) / splits) of block s, into row s of hpartial
// [splits, HEAD_LD] (wa | wr | ba | br). Each 64-point block's h8 and v slabs
// (48 KB) are bulk-copied into one of two shared-memory stages while the
// other is summed: thread t sums 8 columns (slab t / 8) over the rows
// t % 8 + 8i, so a warp reads 4 runs of 128 contiguous bytes a row step.
constexpr int HEAD_THREADS = 256;
constexpr int HEAD_N = W + VW * 3 + 4, HEAD_LD = (HEAD_N + 7) / 8 * 8;  // wa, wr, ba, br
constexpr int HEAD_H8 = W / 8 * SLAB, HEAD_STAGE = HEAD_H8 + VW / 8 * SLAB;  // 32 + 16 KB
constexpr int HEAD_SMEM = 2 * HEAD_STAGE + 2 * 8;

__device__ __forceinline__ void head_copy(unsigned char* stage, const bf16* __restrict__ stash,
                                          int b, uint64_t* bar) {
  const unsigned char* base = reinterpret_cast<const unsigned char*>(stash) + b * STASH_BLOCK_BYTES;
  mbar_expect_tx(bar, HEAD_STAGE);
  bulk_copy(stage, base + (s_h(7) / 8) * SLAB, HEAD_H8, bar);
  bulk_copy(stage + HEAD_H8, base + (S_V / 8) * SLAB, HEAD_STAGE - HEAD_H8, bar);
}

__global__ void __launch_bounds__(HEAD_THREADS)
head_wgrad_kernel(const bf16* __restrict__ stash, const float* __restrict__ g,
                  float* __restrict__ hpartial, int P) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ float gsum[HEAD_THREADS / 32][4];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * HEAD_STAGE);
  const int s = blockIdx.x, splits = gridDim.x, nb = P / WG_ROWS;
  const int b0 = static_cast<int>(static_cast<long long>(nb) * s / splits);
  const int b1 = static_cast<int>(static_cast<long long>(nb) * (s + 1) / splits);
  const int t = threadIdx.x, slab = t / 8, r = t % 8;
  const bool view = t < VW;  // threads 0-127 also take the 16 slabs of v
  if (t == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (b0 < b1) head_copy(smem, stash, b0, &full[0]);
  }
  __syncthreads();
  float wa[8], wr[8][3];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    wa[k] = 0.0f;
    wr[k][0] = wr[k][1] = wr[k][2] = 0.0f;
  }
  for (int i = 0; b0 + i < b1; ++i) {
    const int b = b0 + i, st = i & 1;
    // the other stage was freed by the last iteration's __syncthreads
    if (t == 0 && b + 1 < b1) head_copy(smem + (st ^ 1) * HEAD_STAGE, stash, b + 1, &full[st ^ 1]);
    mbar_wait(&full[st], (i >> 1) & 1);
    const unsigned char* h8 = smem + st * HEAD_STAGE + slab * SLAB;
    const unsigned char* vs = smem + st * HEAD_STAGE + HEAD_H8 + slab * SLAB;
    const float4* gb = reinterpret_cast<const float4*>(g) + static_cast<long long>(b) * WG_ROWS;
#pragma unroll 2
    for (int j = 0; j < WG_ROWS / 8; ++j) {
      const int p = r + 8 * j;
      const float4 gp = __ldg(gb + p);
      const uint4 h = *reinterpret_cast<const uint4*>(h8 + p * 16);
      const uint32_t hw[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wa[2 * k] += bf16_lo(hw[k]) * gp.w;
        wa[2 * k + 1] += bf16_hi(hw[k]) * gp.w;
      }
      if (view) {
        const uint4 v = *reinterpret_cast<const uint4*>(vs + p * 16);
        const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float lo = bf16_lo(vw[k]), hi = bf16_hi(vw[k]);
          wr[2 * k][0] += lo * gp.x;
          wr[2 * k][1] += lo * gp.y;
          wr[2 * k][2] += lo * gp.z;
          wr[2 * k + 1][0] += hi * gp.x;
          wr[2 * k + 1][1] += hi * gp.y;
          wr[2 * k + 1][2] += hi * gp.z;
        }
      }
    }
    __syncthreads();  // every thread is done with this stage
  }
  // the 8 threads of a slab are 8 neighbouring lanes
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      wa[k] += __shfl_xor_sync(0xffffffffu, wa[k], o);
#pragma unroll
      for (int c = 0; c < 3; ++c) wr[k][c] += __shfl_xor_sync(0xffffffffu, wr[k][c], o);
    }
  }
  float* out = hpartial + static_cast<size_t>(s) * HEAD_LD;
  if (r == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[slab * 8 + k] = wa[k];
    if (view) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c) out[W + (slab * 8 + k) * 3 + c] = wr[k][c];
    }
  }
  // ba, br: the column sums of g over the same points
  float c4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long p = static_cast<long long>(b0) * WG_ROWS + t;
       p < static_cast<long long>(b1) * WG_ROWS; p += HEAD_THREADS) {
    const float4 gp = __ldg(reinterpret_cast<const float4*>(g) + p);
    c4[0] += gp.x;
    c4[1] += gp.y;
    c4[2] += gp.z;
    c4[3] += gp.w;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c4[j] += __shfl_xor_sync(0xffffffffu, c4[j], o);
  if ((t & 31) == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j) gsum[t / 32][j] = c4[j];
  __syncthreads();
  if (t < 4) {  // ba, then br
    float sum = 0.0f;
    for (int w = 0; w < HEAD_THREADS / 32; ++w) sum += gsum[w][(t + 3) % 4];
    out[W + VW * 3 + t] = sum;
  }
}

// Test of wgrad_stage alone: out[64 x 256] f32 = x^T g over 64 points, x
// [64 points x 64] and g [64 points x 256] bf16 in the slab layout ([cols/8]
// [64][8]). One warpgroup; plain loads to shared memory.
__global__ void __launch_bounds__(128)
wgrad_test_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gs,
                  float* __restrict__ out) {
  __shared__ __align__(1024) unsigned char sm[WG_A_BYTES + W / 8 * SLAB];
  for (int i = threadIdx.x; i < (WG_A_BYTES + W / 8 * SLAB) / 16; i += 128) {
    const uint4* src = i < WG_A_BYTES / 16 ? reinterpret_cast<const uint4*>(x) + i
                                           : reinterpret_cast<const uint4*>(gs) + i - WG_A_BYTES / 16;
    reinterpret_cast<uint4*>(sm)[i] = *src;
  }
  fence_async_smem();
  __syncthreads();
  float acc[128];
  fence_acc_start(acc);
  wgmma_fence();
  wgrad_stage<W>(acc, smem_addr(sm), smem_addr(sm) + WG_A_BYTES, true);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = warp * 16 + (lane >> 2), q = lane & 3;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int col = 8 * j + 2 * q;
    *reinterpret_cast<float2*>(out + row * W + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (row + 8) * W + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

int sm_count(int* sms) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

extern "C" void fused_nerf_bwd_sizes(int* sld, int* gld, int* pst, int* mask_block,
                                     int* head_ld) {
  *sld = SLD;
  *gld = GLD;
  *pst = PST;
  *mask_block = static_cast<int>(MASK_BLOCK_BYTES);
  *head_ld = HEAD_LD;
}

// The launches of this backward, by bit of `phases` (31: all of them; the
// others time one launch alone on the scratch an earlier call filled). The
// chain's bit also takes the input-gradient kernel when input_grads != 0.
enum { PH_FORWARD = 1, PH_CHAIN = 2, PH_WGRAD = 4, PH_HEADS = 8, PH_REDUCE = 16 };

// pts, dirs: [P, 3] f32; g: [P, 4] f32; wpack (the forward's weight stream),
// wpack_bwd (the chain's), wbuf, bbuf as launch_fused_nerf; all 16-byte
// aligned. Scratch (allocated by the caller): stash [P/64][SLD/8][64][8]
// bf16, gbuf [P/64][GLD/8][64][8] bf16, masks P/64 x MASK_BLOCK_BYTES,
// partial [splits, PST] f32, hpartial [head_splits, HEAD_LD] f32. out: WBUF_SIZE + BBUF_SIZE
// f32 (the weight gradients in wbuf order, then the bias gradients in bbuf
// order). dpts, ddirs: [P, 3] f32, written when input_grads != 0. raw: [P,
// 4] f32, the recomputed forward's output, or null. P must be a multiple of
// 128. Returns the CUDA error code.
extern "C" int launch_fused_nerf_bwd(const void* pts, const void* dirs, const void* g,
                                     const void* wpack, const void* wpack_bwd, const void* wbuf,
                                     const void* bbuf, void* stash, void* gbuf, void* masks,
                                     void* partial, void* hpartial, void* out, void* dpts,
                                     void* ddirs, void* raw, int P, int splits, int head_splits,
                                     int input_grads, int phases, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_nerf_wgmma_kernel<true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaFuncSetAttribute(bwd_chain_wgmma_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, CHAIN_SMEM)) !=
      cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(bwd_input_wgmma_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, INPUT_SMEM)) !=
      cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(head_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                HEAD_SMEM)) != cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(wgrad_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                WGRAD_SMEM)) != cudaSuccess)
    return (int)e;
  if (P % TILE != 0 || splits < 1 || head_splits < 1) return (int)cudaErrorInvalidValue;
  if (input_grads && (dpts == nullptr || ddirs == nullptr)) return (int)cudaErrorInvalidValue;
  int sms;
  if (int rc = sm_count(&sms)) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = P / TILE, grid = tiles < sms ? tiles : sms;
  if (P > 0 && (phases & PH_FORWARD))
    fused_nerf_wgmma_kernel<true><<<grid, NTHR, WG_SMEM, st>>>(
        (const float*)pts, (const float*)dirs, (const bf16*)wpack, (const bf16*)wbuf,
        (const float*)bbuf, (float*)raw, P, (bf16*)stash, (unsigned char*)masks);
  if (P > 0 && (phases & PH_CHAIN)) {
    bwd_chain_wgmma_kernel<<<grid, NTHR, CHAIN_SMEM, st>>>(
        (const float*)g, (const bf16*)wpack_bwd, (const bf16*)wbuf, (const bf16*)stash,
        (unsigned char*)masks, (bf16*)gbuf, P);
    if (input_grads)
      bwd_input_wgmma_kernel<<<P / WG_ROWS, 128, INPUT_SMEM, st>>>(
          (const float*)pts, (const float*)dirs, (const bf16*)wpack_bwd, (const bf16*)gbuf,
          (float*)dpts, (float*)ddirs);
  }
  if (phases & PH_WGRAD)
    wgrad_wgmma_kernel<<<dim3(NITEMS, splits), NTHR, WGRAD_SMEM, st>>>(
        (const bf16*)stash, (const bf16*)gbuf, (float*)partial, P);
  if (phases & PH_HEADS)
    head_wgrad_kernel<<<head_splits, HEAD_THREADS, HEAD_SMEM, st>>>(
        (const bf16*)stash, (const float*)g, (float*)hpartial, P);
  if (phases & PH_REDUCE)
    reduce_kernel<<<(TOTAL + 255) / 256, 256, 0, st>>>(
        (const float*)partial, splits, (const float*)hpartial, head_splits, HEAD_LD, (float*)out);
  return (int)cudaGetLastError();
}

// x: [8][64][8] bf16, g: [32][64][8] bf16 (64 points in the slab layout);
// out: [64, 256] f32 = x^T g. Returns the CUDA error code.
extern "C" int launch_wgrad_test(const void* x, const void* g, void* out, void* stream) {
  wgrad_test_kernel<<<1, 128, 0, (cudaStream_t)stream>>>((const bf16*)x, (const bf16*)g,
                                                          (float*)out);
  return (int)cudaGetLastError();
}
