// Backward of the fused NeRF-MLP with float32 weights (B2-f32), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel nerf_tpu/ops/fused_mlp_bwd.py:43
// (_bwd_kernel) in its float32 mode. Plain PyTorch version:
// nerf_tpu_torch/ops/fused_mlp_bwd.py::fused_nerf_bwd_plain with float32
// weights (``tf32=True`` models the weight gradients' arithmetic below). It
// recomputes the forward, then returns the gradient of every weight and bias
// (summed over the points) and, when asked, of the points and directions.
// The forward and the chain are float32 fmaf on the CUDA cores; the weight
// gradients are 3xTF32 products on the tensor cores (no library GEMM).
//
// What bounds it on an H100: operations. The forward again, every weight
// gradient dW = X^T G and the input gradient G W^T of every layer: about 3 x
// 593,408 multiply-adds a point. At 67 TFLOP/s (float32 on the CUDA cores,
// data sheet) that is 10.2 ms for a train step's fine batch of 196,608
// points, 3.48 ms of it dW; dW in 3xTF32 at 495/3 TFLOP/s is 1.41 ms.
//
// The design, and what it costs. The Pallas kernel recomputes a whole tile's
// forward in VMEM; in float32 a point's activations are 2,528 floats (10 KB),
// so a tile worth computing does not fit in 227 KB of shared memory beside
// the gradients. This kernel keeps them in device memory instead:
// 1. forward: fwd_f32_kernel (fused_mlp_f32.cuh, the B1-f32 code) writes
//    every encoding and activation of a 64-point tile to a float32 stash
//    slab [tile][2528][64];
// 2. chain: a block a tile walks the layers down from the heads, each
//    layer's gradient G [256][64] in shared memory, the next one
//    (G W^T) * (h > 0) by the forward's register-blocked product over the
//    transposed weights (wbuf_t, packed on the host), the ReLU masks read
//    from the stash; every G goes to a gbuf slab [tile][2436][64], and the
//    input gradients are formed at the end from the encoding columns;
// 3. weight gradients (dw_tf32_wgmma_kernel): a block a work unit (two
//    64-row x 128-column slices of a gradient matrix, or one slice whose
//    points the two consumer warpgroups share; ops/fused_mlp_bwd.py::
//    dw_units) and a range of points ("split"). One producer thread keeps a
//    4-stage ring of TMA boxes in flight: 32 points of the unit's X (stash)
//    and G (gbuf) columns a stage, in the 128-byte swizzle that wgmma reads
//    as a K-major TF32 operand (the point is the reduction dimension, and it
//    is contiguous in both slabs). Three splitting warps round each landed
//    stage's G lines in place to TF32 hi and writes their lo parts beside
//    them (wgmma's B), summing each line on the way: the bias gradients ride
//    on the weight units whose rows start at 0. Each consumer warpgroup
//    splits its X values into hi + lo in registers (wgmma's A) and sums
//    hi hi + hi lo + lo hi with m64n128k8 in float32; every TC_PROMOTE
//    stages the product's sum is added into a register sum and restarted
//    (the tensor cores' float32 sums drift over long ranges). The heads
//    (256 x 1, 128 x 3) and their biases are fmaf on the CUDA cores in two
//    small units of the same launch;
// 4. reduce: each gradient entry sums its splits' partials in split order.
// Every sum runs in a fixed order, so a call gives the same bits each time.
// The stash and gbuf cost 19.8 KB a point; the launcher runs the launches on
// chunks of at most `chunk` points (the wrapper's choice: 262,144, 5.2 GB of
// scratch), the reduce adding each chunk's sums to the previous ones, so a
// whole-image tile of 1,572,864 points takes 6 chunks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers; bound with ctypes).

#include <cuda.h>
#include <dlfcn.h>
#include <string.h>

#include "fused_mlp_f32.cuh"
#include "hopper.cuh"

namespace f32mlp {

// gbuf columns: G_i (the gradient of layer i's pre-activation, i = 0..7),
// the feature's and the view layer's, and the upstream gradient [drgb, dsig]
__host__ __device__ constexpr int g_col(int i) { return i * W; }
constexpr int G_F = 8 * W;
constexpr int G_V = G_F + W;
constexpr int G_IN = G_V + VW;
constexpr int GLD = G_IN + 4;  // 2436

// wbuf_t: W^T of each layer part the chain reads, [N][rows] row-major, in
// the order of ops/fused_mlp.py::BWD_STREAM
constexpr int T_VF = 0;                   // view layer, feat rows: [128][256]
constexpr int T_VD = T_VF + VW * W;       // view layer, enc_d rows: [128][32]
constexpr int T_F = T_VD + VW * ED;       // feature layer: [256][256]
__host__ __device__ constexpr int t_layer(int i) {  // trunk layers 7, 6, 5 (h rows), 4..1
  return i >= 5 ? T_F + (8 - i) * W * W : T_F + 4 * W * W + W * EX + (4 - i) * W * W;
}
constexpr int T_5X = T_F + 4 * W * W;     // skip layer, enc_x rows: [256][64]
constexpr int T_0X = t_layer(1) + W * W;  // layer 0: [256][64]
constexpr int WT_SIZE = T_0X + W * EX;
static_assert(WT_SIZE == 593920 && t_layer(5) == 233472 && t_layer(4) == 315392, "wbuf_t");

// Shared memory of the chain, in floats
constexpr int CH_SG = 0, CH_SB = CH_SG + W * TP, CH_EX = CH_SB + 2 * KC * W,
              CH_ED = CH_EX + EX * TP, CH_IN = CH_ED + ED * TP, CH_SMEM = (CH_IN + 4 * TP) * 4;

// The chain's epilogue: G = acc (+ dsig * wa when wa) masked by h > 0 (the
// stash column hcol), into the shared tile and the gbuf slab.
__device__ __forceinline__ void store_grad(const float (&acc)[8][8], const float* st, int hcol,
                                           const float* __restrict__ wa, const float* sIn,
                                           float* sG, float* gb, int gcol) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col_of(j);
    const float* h = st + (hcol + col) * TP;
    const float waj = wa ? __ldg(wa + col) : 0.f;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = pt_of(i);
      const float g = wa ? acc[i][j] + sIn[3 * TP + p] * waj : acc[i][j];
      v[i] = (hcol < 0 || h[p] > 0.f) ? g : 0.f;
    }
    put8(sG, col, v);
    put8(gb, gcol + col, v);
  }
}

// out[r][p] (+)= sum_{n < K} sG[n][p] * Wt[n][r] for r < R: the gradient of
// an encoding's R columns (a thread an output; a warp shares r).
template <bool ADD>
__device__ __forceinline__ void enc_grad(const float* sG, int K, const float* __restrict__ Wt,
                                         int R, float* out) {
  for (int idx = threadIdx.x; idx < R * TP; idx += NT) {
    const int r = idx / TP, p = idx % TP;
    float s = 0.f;
    for (int n = 0; n < K; ++n) s = fmaf(sG[n * TP + p], __ldg(Wt + n * R + r), s);
    out[r * TP + p] = ADD ? out[r * TP + p] + s : s;
  }
}

// One 64-point tile of the chain (P a multiple of 64): g [P, 4] -> gbuf
// slab; dpts, ddirs [P, 3] when input_grads.
__global__ void __launch_bounds__(NT, 2)
chain_f32_kernel(const float* __restrict__ g, const float* __restrict__ wbuf,
                 const float* __restrict__ wbuf_t, const float* __restrict__ stash,
                 float* __restrict__ gbuf, float* __restrict__ dpts,
                 float* __restrict__ ddirs, int input_grads) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float *sG = smem + CH_SG, *sB = smem + CH_SB, *sEx = smem + CH_EX, *sEd = smem + CH_ED,
        *sIn = smem + CH_IN;
  const int tid = threadIdx.x, p0 = blockIdx.x * TP;
  const float* st = stash + (size_t)blockIdx.x * SLD * TP;
  float* gb = gbuf + (size_t)blockIdx.x * GLD * TP;
  {  // the upstream gradient, [4][64]
    const int p = tid >> 2, c = tid & 3;
    const float v = g[(size_t)(p0 + p) * 4 + c];
    sIn[c * TP + p] = v;
    gb[(G_IN + c) * TP + p] = v;
  }
  __syncthreads();
  // gv = (drgb @ Wr^T) * (v > 0)
  for (int idx = tid; idx < VW * TP; idx += NT) {
    const int j = idx / TP, p = idx % TP;
    float s = sIn[p] * __ldg(wbuf + OFF_WR + j * 3);
    s = fmaf(sIn[TP + p], __ldg(wbuf + OFF_WR + j * 3 + 1), s);
    s = fmaf(sIn[2 * TP + p], __ldg(wbuf + OFF_WR + j * 3 + 2), s);
    const float gv = st[(S_V + j) * TP + p] > 0.f ? s : 0.f;
    sG[j * TP + p] = gv;
    gb[(G_V + j) * TP + p] = gv;
  }
  __syncthreads();
  if (input_grads) enc_grad<false>(sG, VW, wbuf_t + T_VD, ED, sEd);
  float acc[8][8];
  zero<W>(acc);
  product<W>(acc, sG, VW, sG, VW, wbuf_t + T_VF, sB);  // gf = gv @ Wvf^T
  store_grad(acc, st, -1, nullptr, sIn, sG, gb, G_F);
  __syncthreads();
  zero<W>(acc);
  product<W>(acc, sG, W, sG, W, wbuf_t + T_F, sB);  // G7 = (gf @ Wf^T + dsig wa^T) * (h8 > 0)
  store_grad(acc, st, s_h(8), wbuf + OFF_WA, sIn, sG, gb, g_col(7));
  __syncthreads();
  for (int i = 7; i >= 1; --i) {  // G_{i-1} = (G_i @ W_i^T) * (h_i > 0)
    if (i == 5 && input_grads) enc_grad<false>(sG, W, wbuf_t + T_5X, EX, sEx);
    zero<W>(acc);
    product<W>(acc, sG, W, sG, W, wbuf_t + t_layer(i), sB);
    store_grad(acc, st, s_h(i), nullptr, sIn, sG, gb, g_col(i - 1));
    __syncthreads();
  }
  if (!input_grads) return;
  enc_grad<true>(sG, W, wbuf_t + T_0X, EX, sEx);
  __syncthreads();
  if (tid < TP) {  // da = cos a * dsin - sin a * dcos, then the sum over bands
    const int p = tid;
    const float* sx = st + S_X * TP;
    const float* sd = st + S_D * TP;
    for (int c = 0; c < 3; ++c) {
      float s = 0.f;
      for (int f = 0; f < XF; ++f) {
        const int q = 3 * f + c;
        const float da = sx[(3 + 3 * XF + q) * TP + p] * sEx[(3 + q) * TP + p] -
                         sx[(3 + q) * TP + p] * sEx[(3 + 3 * XF + q) * TP + p];
        s += da * (float)(1 << f);
      }
      dpts[(size_t)(p0 + p) * 3 + c] = sEx[c * TP + p] + s;
      s = 0.f;
      for (int f = 0; f < DF; ++f) {
        const int q = 3 * f + c;
        const float db = sd[(3 + 3 * DF + q) * TP + p] * sEd[(3 + q) * TP + p] -
                         sd[(3 + q) * TP + p] * sEd[(3 + 3 * DF + q) * TP + p];
        s += db * (float)(1 << f);
      }
      ddirs[(size_t)(p0 + p) * 3 + c] = sEd[c * TP + p] + s;
    }
  }
}

// a split's row of partials: the weight gradients in wbuf order, then the biases'
constexpr int PST = WBUF_SIZE + BBUF_SIZE;

// ---- 3. weight gradients on the tensor cores (3xTF32) ----

constexpr int TC_PASSES = 3;   // TF32 products a k-step: hi hi, hi lo, lo hi (1: hi hi alone)
constexpr int TC_STAGES = 4;   // stages of the ring
constexpr int TC_PROMOTE = 8;  // stages (32 points each) between promotions; 0: never

// A work unit (ops/fused_mlp_bwd.py::dw_units builds the table). A stage
// holds xlines stash columns from xcol, then glines gbuf columns from gcol,
// 32 points each (one 128-byte line a column), then the lo parts of G lines
// [0, nsplit), which the splitting warps split into TF32 hi (in place)
// and lo (the products' B operand), summing each line into partial entry
// bias + line when bias >= 0.
// - TC_PRODUCTS: consumer warpgroup w multiplies X lines x[w].. (64 dW rows)
//   by G lines g[w].. (128 dW columns) into partial entries out[w] + row *
//   ld + column for rows < rows (x[w] < 0: no product).
// - TC_KSPLIT: one such slice, x[0], g[0], out[0], its points shared:
//   warpgroup 0 takes the first two k-steps of each stage, warpgroup 1 the
//   last two, and their sums are added at the end.
// - TC_VIEW_RGB, on the CUDA cores: out[1] + 3 j + c = sum over the points
//   of X line x[1] + j times G line g[1] + c, j < 128, c < 3 (wr).
// - TC_HEADS, on the CUDA cores: out[0] + j = sum of X line j times G line
//   3 (wa = h8^T dsigma, j < 256); bias + (0, 1, 2, 3) = the sums of G
//   lines 3, 0, 1, 2 (ba, br).
enum : int { TC_PRODUCTS = 0, TC_HEADS = 1, TC_VIEW_RGB = 2, TC_KSPLIT = 3 };
struct DwUnit {
  int kind, xcol, xlines, gcol, glines;
  int x[2], g[2], out[2];
  int ld, rows, nsplit, bias;
};
constexpr int TC_UNIT_INTS = 15, TC_MAX_UNITS = 60;  // the parameters stay under 4 KB
static_assert(sizeof(DwUnit) == TC_UNIT_INTS * 4, "unit table row");
struct DwUnits {
  DwUnit u[TC_MAX_UNITS];
};

constexpr int TC_LINE = 128, TC_BOX = 32;  // bytes a line; lines a TMA box
constexpr int TC_SLOT_LINES = 384;         // X, G and lo lines of a stage
constexpr int TC_SLOT_BYTES = TC_SLOT_LINES * TC_LINE;  // 48 KB
constexpr int TC_BAR_OFF = TC_STAGES * TC_SLOT_BYTES;
constexpr int TC_SMEM = 1024 + TC_BAR_OFF + 3 * TC_STAGES * 8;  // + room to align to 1024
// two consumer warpgroups and the producer's (one thread loads, three warps
// split); 384 threads leave 168 registers a thread, which the consumers'
// 64 products, 64 promoted sums and A fragments fit
constexpr int TC_THREADS = 384;
constexpr int TC_CONSUMER_REGS = 208, TC_PRODUCER_REGS = 88;
static_assert(TC_SMEM <= 232448, "shared memory of one block");
// setmaxnreg moves registers within the block's allocation (168 a thread):
// an increase beyond what the decrease frees waits forever
static_assert(2 * 128 * TC_CONSUMER_REGS + 128 * TC_PRODUCER_REGS <= TC_THREADS * 168,
              "register budget");

// Byte offset of 16-byte chunk c (points 4c..4c+3) of line l in a region of
// 128-byte swizzled lines that starts 1024-byte aligned.
__device__ __forceinline__ uint32_t sw_off(int l, int c) {
  return l * TC_LINE + (((c ^ l) & 7) << 4);
}

// One arrival for the warp (when on), by lane 0, as a predicated
// instruction rather than a branch (ptxas serializes wgmma around code on a
// divergent path). The lanes' own accesses must be ordered before it (a
// wgmma wait, or __syncwarp).
__device__ __forceinline__ void warp_arrive(uint64_t* bar, bool on = true) {
  asm volatile(
      "{\n .reg .pred p, q;\n .reg .u32 l;\n mov.u32 l, %%laneid;\n setp.ne.u32 q, %1, 0;\n"
      " setp.eq.and.u32 p, l, 0, q;\n @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      ::"r"(smem_addr(bar)), "r"(static_cast<uint32_t>(on))
      : "memory");
}

// A consumer warp that only reads a stage (the CUDA-core units) releases it.
__device__ __forceinline__ void tc_release(uint64_t* empty, int s) {
  __syncwarp();
  warp_arrive(&empty[s]);
}

// The TMA boxes of stage c into its slot, once the slot is free.
__device__ __forceinline__ void tc_load(const DwUnit& U, const CUtensorMap* tx,
                                        const CUtensorMap* tg, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty, int t0, int c) {
  const int s = c % TC_STAGES;
  mbar_wait(&empty[s], ((c / TC_STAGES) & 1) ^ 1);  // the first round passes at once
  mbar_expect_tx(&full[s], (U.xlines + U.glines) * TC_LINE);
  unsigned char* st = smem + s * TC_SLOT_BYTES;
  const int tile = t0 + (c >> 1), p = (c & 1) * 32;
  for (int i = 0; i < U.xlines; i += TC_BOX)
    tma_load_3d(st + i * TC_LINE, tx, p, U.xcol + i, tile, &full[s]);
  for (int i = 0; i < U.glines; i += TC_BOX)
    tma_load_3d(st + (U.xlines + i) * TC_LINE, tg, p, U.gcol + i, tile, &full[s]);
}

// The producer warpgroup's warps 1-3 (its thread 0 loads the stages): they
// split each stage's G lines [0, nsplit) as it lands in place into TF32 hi,
// with the lo parts after the stage's data, 16-byte chunk k = t + 96 i by
// thread t (a warp takes four whole lines a step), and sum them: each
// thread its chunks' four values (pairs, then in order of stages) apart for
// each i, the eight chunks of a line added across their lanes at the end.
// Each warp tells the consumers when its part of a stage is split.
constexpr int TC_SPLITTERS = 96, TC_SPLIT_STEPS = 128 * 8 / TC_SPLITTERS + 1;  // 11
__device__ __forceinline__ void tc_split(const DwUnit& U, unsigned char* smem, uint64_t* full,
                                         uint64_t* ready, int nst, float* out) {
  const int t = threadIdx.x - 288, nchunks = U.nsplit * 8;
  if (nchunks == 0) return;
  float bsum[TC_SPLIT_STEPS];
#pragma unroll
  for (int i = 0; i < TC_SPLIT_STEPS; ++i) bsum[i] = 0.f;
  for (int c = 0; c < nst; ++c) {
    const int s = c % TC_STAGES;
    mbar_wait(&full[s], (c / TC_STAGES) & 1);
    unsigned char* gs = smem + s * TC_SLOT_BYTES + U.xlines * TC_LINE;
    unsigned char* lo = smem + s * TC_SLOT_BYTES + (U.xlines + U.glines) * TC_LINE;
#pragma unroll
    for (int i = 0; i < TC_SPLIT_STEPS; ++i) {
      const int k = t + TC_SPLITTERS * i;
      if (k >= nchunks) break;
      const uint32_t off = sw_off(k >> 3, k & 7);
      const float4 v = *reinterpret_cast<const float4*>(gs + off);
      bsum[i] += (v.x + v.y) + (v.z + v.w);
      const uint4 h = make_uint4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
      *reinterpret_cast<uint4*>(gs + off) = h;
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(
          tf32_rna(v.x - __uint_as_float(h.x)), tf32_rna(v.y - __uint_as_float(h.y)),
          tf32_rna(v.z - __uint_as_float(h.z)), tf32_rna(v.w - __uint_as_float(h.w)));
    }
    fence_async_smem();
    __syncwarp();
    warp_arrive(&ready[s]);
  }
  if (U.bias < 0) return;
#pragma unroll
  for (int i = 0; i < TC_SPLIT_STEPS; ++i) {
    float v = bsum[i];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    const int k = t + TC_SPLITTERS * i;
    if ((t & 7) == 0 && k < nchunks) out[U.bias + (k >> 3)] = v;
  }
}

// k-steps 2 G and 2 G + 1 of a stage: this thread's A values (rows r0 and
// r0 + 8 of the warpgroup's 64, points 8 ks + q and 8 ks + q + 4) split into
// TF32 hi and lo, then the products with B's hi and lo lines, as one
// committed group; waits until the group before it is done.
template <int G>
__device__ __forceinline__ void tc_group(float (&acc)[64], uint32_t (&ah)[2][4],
                                         uint32_t (&al)[2][4], const unsigned char* xs,
                                         uint32_t bh, uint32_t bl, int r0, int q, bool start) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ks = 2 * G + k;
    const float v[4] = {*reinterpret_cast<const float*>(xs + sw_off(r0, 2 * ks) + 4 * q),
                        *reinterpret_cast<const float*>(xs + sw_off(r0 + 8, 2 * ks) + 4 * q),
                        *reinterpret_cast<const float*>(xs + sw_off(r0, 2 * ks + 1) + 4 * q),
                        *reinterpret_cast<const float*>(xs + sw_off(r0 + 8, 2 * ks + 1) + 4 * q)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[k][i] = tf32_rna(v[i]);
      al[k][i] = tf32_rna(v[i] - __uint_as_float(ah[k][i]));
    }
  }
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t kb = (2 * G + k) * 32;
    wgmma_tf32_n128(acc, ah[k], smem_desc_sw128(bh + kb), start && k == 0 ? 0 : 1);
    if (TC_PASSES == 3) {
      wgmma_tf32_n128(acc, ah[k], smem_desc_sw128(bl + kb), 1);
      wgmma_tf32_n128(acc, al[k], smem_desc_sw128(bh + kb), 1);
    }
  }
  wgmma_commit();
  wgmma_wait<1>();
  fence_acc(acc);
}

// A consumer warpgroup's products over every stage once it is split, then
// its dW slice. PART 0: both groups of k-steps of each stage (TC_PRODUCTS);
// 1 or 2: the first or the second group only (TC_KSPLIT, warpgroup 0 or 1),
// the second warpgroup's sums added to the first's through shared memory.
template <int PART>
__device__ __forceinline__ void tc_products(const DwUnit& U, unsigned char* smem, uint64_t* full,
                                            uint64_t* ready, uint64_t* empty, int nst,
                                            float* out, int wg) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2), q = lane & 3;
  const int w = PART == 0 ? wg : 0;  // the slice's fields
  // acc: the products since the last promotion; sum: the promoted sums (none
  // without promotion)
  float acc[64], sum[TC_PROMOTE > 0 ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (TC_PROMOTE > 0 ? 64 : 1); ++i) sum[i] = 0.f;
  uint32_t ah0[2][4], al0[2][4], ah1[2][4], al1[2][4];
  for (int c = 0; c < nst; ++c) {
    const int s = c % TC_STAGES;
    mbar_wait(&full[s], (c / TC_STAGES) & 1);
    mbar_wait(&ready[s], (c / TC_STAGES) & 1);
    const unsigned char* st = smem + s * TC_SLOT_BYTES;
    const unsigned char* xs = st + U.x[w] * TC_LINE;
    const uint32_t bh = smem_addr(st + (U.xlines + U.g[w]) * TC_LINE);
    const uint32_t bl = smem_addr(st + (U.xlines + U.glines + U.g[w]) * TC_LINE);
    const bool start = c == 0 || (TC_PROMOTE > 0 && c % TC_PROMOTE == 0);
    // a stage's slot is released once this warpgroup's last group on it is
    // done: the wait of the first group it commits on the next stage
    if constexpr (PART != 2) tc_group<0>(acc, ah0, al0, xs, bh, bl, r0, q, start);
    if constexpr (PART == 2) tc_group<1>(acc, ah1, al1, xs, bh, bl, r0, q, start);
    if (TC_STAGES > 1) warp_arrive(&empty[(c + TC_STAGES - 1) % TC_STAGES], c > 0);
    if constexpr (PART == 0) tc_group<1>(acc, ah1, al1, xs, bh, bl, r0, q, false);
    if (c == nst - 1 || (TC_PROMOTE > 0 && c % TC_PROMOTE == TC_PROMOTE - 1)) {
      wgmma_wait<0>();
      fence_acc(acc);
      if constexpr (TC_PROMOTE > 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += acc[i];
      }
    }
    if (TC_STAGES == 1) {
      wgmma_wait<0>();
      fence_acc(acc);
      warp_arrive(&empty[s]);
    }
  }
  float* res = TC_PROMOTE > 0 ? sum : acc;
  if constexpr (PART != 0) {  // every stage is consumed: the slots are free for the exchange
    float* x = reinterpret_cast<float*>(smem) + (threadIdx.x & 127) * 64;
    named_barrier(3, 256);
    if constexpr (PART == 2) {
#pragma unroll
      for (int i = 0; i < 64; ++i) x[i] = res[i];
    }
    named_barrier(3, 256);
    if constexpr (PART == 2) {
      return;
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) res[i] += x[i];
    }
  }
  float* o = out + U.out[w];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * q;
    if (r0 < U.rows)
      *reinterpret_cast<float2*>(o + r0 * U.ld + col) = make_float2(res[4 * j], res[4 * j + 1]);
    if (r0 + 8 < U.rows)
      *reinterpret_cast<float2*>(o + (r0 + 8) * U.ld + col) =
          make_float2(res[4 * j + 2], res[4 * j + 3]);
  }
}

// TC_HEADS: thread t < 256 sums X line t times G line 3 (wa); threads 0-3
// also sum G lines 0-3 (br, ba). Each stage's 32 terms are summed apart,
// then added to the running sums.
__device__ __forceinline__ void tc_heads(const DwUnit& U, unsigned char* smem, uint64_t* full,
                                         uint64_t* empty, int nst, float* out) {
  const int t = threadIdx.x;
  float wa = 0.f, gsum = 0.f;
  for (int c = 0; c < nst; ++c) {
    const int s = c % TC_STAGES;
    mbar_wait(&full[s], (c / TC_STAGES) & 1);
    const unsigned char* xs = smem + s * TC_SLOT_BYTES;
    const unsigned char* gs = xs + U.xlines * TC_LINE;
    float pw = 0.f, pg = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(xs + sw_off(t, j));
      const float4 d = *reinterpret_cast<const float4*>(gs + sw_off(3, j));
      pw = fmaf(x.x, d.x, pw);
      pw = fmaf(x.y, d.y, pw);
      pw = fmaf(x.z, d.z, pw);
      pw = fmaf(x.w, d.w, pw);
      const float4 v = *reinterpret_cast<const float4*>(gs + sw_off(t & 3, j));
      pg += (v.x + v.y) + (v.z + v.w);
    }
    wa += pw;
    gsum += pg;
    tc_release(empty, s);
  }
  out[U.out[0] + t] = wa;
  if (t < 4) out[U.bias + (t == 3 ? 0 : 1 + t)] = gsum;
}

// TC_VIEW_RGB: thread j < 128 of warpgroup 0 sums X line x[1] + j times G
// lines g[1] .. g[1] + 2 (wr), a stage's terms apart as above; warpgroup 1
// only releases the stages.
__device__ __forceinline__ void tc_view_rgb(const DwUnit& U, unsigned char* smem, uint64_t* full,
                                            uint64_t* empty, int nst, float* out, int wg) {
  const int j = threadIdx.x & 127;
  float w[3] = {0.f, 0.f, 0.f};
  for (int c = 0; c < nst; ++c) {
    const int s = c % TC_STAGES;
    mbar_wait(&full[s], (c / TC_STAGES) & 1);
    if (wg == 0) {
      const unsigned char* xs = smem + s * TC_SLOT_BYTES;
      const unsigned char* gs = xs + U.xlines * TC_LINE;
      float pw[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 x = *reinterpret_cast<const float4*>(xs + sw_off(U.x[1] + j, k));
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float4 d = *reinterpret_cast<const float4*>(gs + sw_off(U.g[1] + ch, k));
          pw[ch] = fmaf(x.x, d.x, pw[ch]);
          pw[ch] = fmaf(x.y, d.y, pw[ch]);
          pw[ch] = fmaf(x.z, d.z, pw[ch]);
          pw[ch] = fmaf(x.w, d.w, pw[ch]);
        }
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) w[ch] += pw[ch];
    }
    tc_release(empty, s);
  }
  if (wg == 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[U.out[1] + 3 * j + ch] = w[ch];
  }
}

// Block b: unit b / splits over the 64-point tiles [tiles r / splits,
// tiles (r + 1) / splits) of the chunk, r = b % splits, into partial row r.
__global__ void __launch_bounds__(TC_THREADS, 1)
dw_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_g, float* __restrict__ partial,
                     int tiles, int splits, const __grid_constant__ DwUnits units) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  unsigned char* smem = tc_smem + ((1024 - (smem_addr(tc_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TC_BAR_OFF);
  uint64_t* ready = full + TC_STAGES;
  uint64_t* empty = ready + TC_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive.expect_tx
      mbar_init(&ready[s], TC_SPLITTERS / 32);  // one arrival per splitting warp
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const DwUnit& U = units.u[blockIdx.x / splits];
  const int r = blockIdx.x % splits;
  const int t0 = static_cast<int>(static_cast<long long>(tiles) * r / splits);
  const int t1 = static_cast<int>(static_cast<long long>(tiles) * (r + 1) / splits);
  // the warpgroup, warp-uniform to the compiler
  const int nst = 2 * (t1 - t0), wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  float* out = partial + static_cast<size_t>(r) * PST;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(TC_PRODUCER_REGS));
    if (threadIdx.x >= 288) {
      tc_split(U, smem, full, ready, nst, out);
    } else if (threadIdx.x == 256) {
      for (int c = 0; c < nst; ++c) tc_load(U, &tm_x, &tm_g, smem, full, empty, t0, c);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(TC_CONSUMER_REGS));
    if (U.kind == TC_HEADS) {
      tc_heads(U, smem, full, empty, nst, out);
    } else if (U.kind == TC_VIEW_RGB) {
      tc_view_rgb(U, smem, full, empty, nst, out, wg);
    } else if (U.kind == TC_KSPLIT) {
      if (wg == 0)
        tc_products<1>(U, smem, full, ready, empty, nst, out, wg);
      else
        tc_products<2>(U, smem, full, ready, empty, nst, out, wg);
    } else if (U.x[wg] >= 0) {
      tc_products<0>(U, smem, full, ready, empty, nst, out, wg);
    } else {  // no product of its own: it only releases the stages
      for (int c = 0; c < nst; ++c) {
        mbar_wait(&ready[c % TC_STAGES], (c / TC_STAGES) & 1);
        tc_release(empty, c % TC_STAGES);
      }
    }
  }
}

// flat[i] = (accumulate ? flat[i] : 0) + sum over splits of partial[s][i], in
// split order.
__global__ void reduce_f32_kernel(const float* __restrict__ partial, float* __restrict__ flat,
                                  int splits, int accumulate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= PST) return;
  float s = partial[i];
  for (int k = 1; k < splits; ++k) s += partial[(size_t)k * PST + i];
  flat[i] = accumulate ? flat[i] + s : s;
}

}  // namespace f32mlp

using namespace f32mlp;

namespace {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process has loaded (no link
// against it).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// The tensor map of slabs [tiles][cols][64] float32: boxes of 32 points x 32
// columns of one slab, 128-byte swizzle, columns past cols read as zeros.
cudaError_t slab_map(CUtensorMap* m, const void* base, int cols, int tiles) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {TP, static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(tiles)};
  const cuuint64_t strides[2] = {TP * 4, static_cast<cuuint64_t>(cols) * TP * 4};
  const cuuint32_t box[3] = {32, TC_BOX, 1}, elem[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The unit table's rows, checked against what the kernel assumes.
bool read_units(const int* rows, int n, DwUnits* out) {
  if (n <= 0 || n > TC_MAX_UNITS) return false;
  for (int i = 0; i < n; ++i) {
    DwUnit u;
    memcpy(&u, rows + i * TC_UNIT_INTS, sizeof(u));
    bool ok = u.kind >= TC_PRODUCTS && u.kind <= TC_KSPLIT && u.xlines > 0 &&
              u.xlines % TC_BOX == 0 && u.glines > 0 && u.glines % TC_BOX == 0 &&
              u.xcol >= 0 && u.xcol + u.xlines <= SLD && u.gcol >= 0 && u.gcol < GLD &&
              (u.nsplit == 0 || u.nsplit == 128) && u.nsplit <= u.glines &&
              u.xlines + u.glines + u.nsplit <= TC_SLOT_LINES;
    if (u.kind == TC_HEADS) ok = ok && u.xlines == 256 && u.glines >= 4 && u.bias >= 0;
    if (u.kind == TC_VIEW_RGB) ok = ok && u.x[1] >= 0 && u.x[1] + 128 <= u.xlines &&
                                  u.g[1] >= 0 && u.g[1] + 3 <= u.glines;
    if (u.kind == TC_PRODUCTS || u.kind == TC_KSPLIT) {
      // the consumers wait for the split of every stage
      ok = ok && u.nsplit > 0 && u.ld > 0 && u.rows > 0 && u.rows <= 64;
      for (int w = 0; w < (u.kind == TC_KSPLIT ? 1 : 2); ++w)
        if (u.kind == TC_KSPLIT || u.x[w] >= 0)
          ok = ok && u.x[w] >= 0 && u.x[w] % 8 == 0 && u.x[w] + u.rows <= u.xlines &&
               u.g[w] % 8 == 0 && u.g[w] + 128 <= u.nsplit;
    }
    if (!ok) return false;
    out->u[i] = u;
  }
  return true;
}

}  // namespace

extern "C" void fused_nerf_bwd_f32_sizes(int* sld, int* gld, int* pst, int* wt) {
  *sld = SLD;
  *gld = GLD;
  *pst = PST;
  *wt = WT_SIZE;
}

// pts, dirs [P, 3], g [P, 4] f32, P a multiple of 64; wbuf (16-byte
// aligned), bbuf, wbuf_t (WT_SIZE, 16-byte aligned) f32; scratch for one
// chunk of `chunk` points (a multiple of 64): stash [chunk/64, SLD, 64], gbuf
// [chunk/64, GLD, 64], partial [splits, PST]; flat [PST] gets the gradients
// (weights in wbuf order, then the biases in bbuf order); raw [P, 4] the
// recomputed forward; dpts, ddirs [P, 3] when input_grads; units: the weight
// gradients' work units, n_units rows of TC_UNIT_INTS ints (host memory).
// phases selects the launches (1 forward, 2 chain, 4 weight gradients on
// the tensor cores, 8 reduce; 15 all). Returns the CUDA error code.
extern "C" int launch_fused_nerf_bwd_f32(const void* pts, const void* dirs, const void* g,
                                         const void* wbuf, const void* bbuf, const void* wbuf_t,
                                         void* stash, void* gbuf, void* partial, void* flat,
                                         void* raw, void* dpts, void* ddirs, const void* units,
                                         int P, int chunk, int splits, int n_units,
                                         int input_grads, int phases, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                FWD_SMEM)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(chain_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                CH_SMEM)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(dw_tf32_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                TC_SMEM)) != cudaSuccess)
    return (int)e;
  if (P <= 0 || P % TP || chunk <= 0 || chunk % TP || splits <= 0) return (int)cudaErrorInvalidValue;
  DwUnits table;
  if (!read_units(static_cast<const int*>(units), n_units, &table)) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_g;
  if (phases & 4) {
    const int tiles = (P < chunk ? P : chunk) / TP;
    if ((e = slab_map(&tm_x, stash, SLD, tiles)) != cudaSuccess ||
        (e = slab_map(&tm_g, gbuf, GLD, tiles)) != cudaSuccess)
      return (int)e;
  }
  for (int c0 = 0; c0 < P; c0 += chunk) {
    const int n = P - c0 < chunk ? P - c0 : chunk, tiles = n / TP;
    const float* pc = (const float*)pts + (size_t)c0 * 3;
    const float* dc = (const float*)dirs + (size_t)c0 * 3;
    if (phases & 1)
      fwd_f32_kernel<<<tiles, NT, FWD_SMEM, s>>>(pc, dc, (const float*)wbuf, (const float*)bbuf,
                                                 (float*)raw + (size_t)c0 * 4, n, (float*)stash);
    if (phases & 2)
      chain_f32_kernel<<<tiles, NT, CH_SMEM, s>>>(
          (const float*)g + (size_t)c0 * 4, (const float*)wbuf, (const float*)wbuf_t,
          (const float*)stash, (float*)gbuf, input_grads ? (float*)dpts + (size_t)c0 * 3 : nullptr,
          input_grads ? (float*)ddirs + (size_t)c0 * 3 : nullptr, input_grads);
    if (phases & 4)
      dw_tf32_wgmma_kernel<<<n_units * splits, TC_THREADS, TC_SMEM, s>>>(
          tm_x, tm_g, (float*)partial, tiles, splits, table);
    if (phases & 8)
      reduce_f32_kernel<<<(PST + 255) / 256, 256, 0, s>>>((const float*)partial, (float*)flat,
                                                          splits, c0 > 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}
