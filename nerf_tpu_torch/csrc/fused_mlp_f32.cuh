// Float32 forms of the fused NeRF-MLP (B1-f32) and of the forward its
// backward recomputes (B2-f32, fused_mlp_bwd_f32.cu): true float32 products
// and sums, one FFMA per multiply-add on the CUDA cores. Hopper's wgmma takes
// no float32 operands and its TF32 mode keeps a 10-bit mantissa, so neither
// kernel touches the tensor cores.
//
// Layouts shared by both kernels (all float32):
// - wbuf: the weights as ops/fused_mlp.py::repack_params packs them, each
//   layer's [K, N] row-major, the encoding rows padded to 16-multiples
//   (64 for x, 32 for d), then the sigma and rgb heads; bbuf: the biases.
// - A tile is TP = 64 points. Its activations live in shared memory as
//   [rows][64 points] (one row a unit, the points contiguous), so that a
//   product's A operand is read as two float4 a row and its output is
//   written back the same way.
// - The backward's stash and gbuf are slabs: [tile][column][64 points].
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32mlp {

constexpr int TP = 64;   // points a tile
constexpr int NT = 256;  // threads a block
constexpr int KC = 8;    // weight rows a streamed chunk
constexpr int W = 256;   // trunk width
constexpr int VW = 128;  // view layer width
constexpr int XF = 10;   // xyz frequency bands
constexpr int DF = 4;    // dir frequency bands
constexpr int EX = 64;   // xyz encoding 3 + 2*30 = 63, padded to 64
constexpr int ED = 32;   // dir encoding 3 + 2*12 = 27, padded to 32

// wbuf offsets (floats): the ten layers' matrices, then the heads
constexpr int OFF_L0 = 0;                          // [64, 256]: x, sin, cos, 0
constexpr int OFF_L1 = OFF_L0 + EX * W;
constexpr int OFF_L5 = OFF_L1 + 4 * W * W;         // [320, 256]: x, sin, cos, 0, h5
constexpr int OFF_L6 = OFF_L5 + (EX + W) * W;
constexpr int OFF_LF = OFF_L6 + 2 * W * W;         // feature layer [256, 256]
constexpr int OFF_LV = OFF_LF + W * W;             // view layer [288, 128]: feat, d, sin, cos, 0
constexpr int OFF_WA = OFF_LV + (W + ED) * VW;     // [256]
constexpr int OFF_WR = OFF_WA + W;                 // [128, 3]
constexpr int WBUF_SIZE = OFF_WR + VW * 3;
__host__ __device__ constexpr int off_layer(int i) {  // trunk layers 1-4, 6, 7
  return i <= 4 ? OFF_L1 + (i - 1) * W * W : OFF_L6 + (i - 6) * W * W;
}
// bbuf offsets
constexpr int OFF_BF = 8 * W;
constexpr int OFF_BV = OFF_BF + W;
constexpr int OFF_BA = OFF_BV + VW;
constexpr int OFF_BR = OFF_BA + 1;
constexpr int BBUF_SIZE = OFF_BR + 3;

// stash columns: the encodings and every activation the backward reads
constexpr int S_X = 0;                                  // 64
__host__ __device__ constexpr int s_h(int i) { return EX + (i - 1) * W; }  // h1..h8
constexpr int S_FEAT = EX + 8 * W;                      // 256
constexpr int S_D = S_FEAT + W;                         // 32
constexpr int S_V = S_D + ED;                           // 128
constexpr int SLD = S_V + VW;                           // 2528

static_assert(WBUF_SIZE == 594560 && BBUF_SIZE == 2436 && SLD == 2528, "layout");

// Thread layout of a product (8 warps): lane = pgl + 8 jgl, jg = 4 warp + jgl.
// A thread owns points 4 pgl + (0..3) and 32 + 4 pgl + (0..3), and output
// columns 4 jg + (0..3) (+ 128 when the layer is 256 wide): a quarter-warp
// reads or writes 128 contiguous bytes of a row, so no bank conflicts.
__device__ __forceinline__ int pgl() { return threadIdx.x & 7; }
__device__ __forceinline__ int jg() { return (threadIdx.x >> 5) * 4 + ((threadIdx.x >> 3) & 3); }
__device__ __forceinline__ int pt_of(int i) { return (i & 3) + 4 * pgl() + 32 * (i >> 2); }
__device__ __forceinline__ int col_of(int j) { return (j & 3) + 4 * jg() + 128 * (j >> 2); }

template <int NOUT>
__device__ __forceinline__ void zero(float (&acc)[8][NOUT / 32]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NOUT / 32; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_k A[k][pt(i)] * B[k][col(j)] over k = 0..K-1, in order of
// k, one fmaf each. A: shared rows of 64 points, rows k < ksplit from A0,
// the rest from A1 (row k - ksplit). B: global [K, NOUT] row-major, streamed
// through sB (2 x KC x 256 floats) in chunks of KC rows, the next chunk held
// in registers while this one is multiplied. K and ksplit are multiples of
// KC. Ends with a barrier: A may be overwritten after it.
template <int NOUT>
__device__ __forceinline__ void product(float (&acc)[8][NOUT / 32], const float* A0, int ksplit,
                                        const float* A1, int K, const float* __restrict__ Bg,
                                        float* sB) {
  constexpr int NJ = NOUT / 32, V = KC * NOUT / (4 * NT), CH4 = KC * NOUT / 4;
  const int nc = K / KC, tid = threadIdx.x, p4 = 4 * pgl(), c4 = 4 * jg();
  const float4* Bg4 = reinterpret_cast<const float4*>(Bg);
  float4 pre[V];
#pragma unroll
  for (int v = 0; v < V; ++v) pre[v] = __ldg(Bg4 + tid + v * NT);
#pragma unroll
  for (int v = 0; v < V; ++v) reinterpret_cast<float4*>(sB)[tid + v * NT] = pre[v];
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    const float* bs = sB + (c & 1) * (KC * W);
    if (c + 1 < nc) {
#pragma unroll
      for (int v = 0; v < V; ++v) pre[v] = __ldg(Bg4 + (c + 1) * CH4 + tid + v * NT);
    }
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const int k = c * KC + kk;
      const float* arow = k < ksplit ? A0 + k * TP : A1 + (k - ksplit) * TP;
      const float4 a0 = *reinterpret_cast<const float4*>(arow + p4);
      const float4 a1 = *reinterpret_cast<const float4*>(arow + 32 + p4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[NJ];
#pragma unroll
      for (int g = 0; g < NJ / 4; ++g) {
        const float4 bb = *reinterpret_cast<const float4*>(bs + kk * NOUT + 128 * g + c4);
        b[4 * g] = bb.x;
        b[4 * g + 1] = bb.y;
        b[4 * g + 2] = bb.z;
        b[4 * g + 3] = bb.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (c + 1 < nc) {
      float4* nb = reinterpret_cast<float4*>(sB + ((c + 1) & 1) * (KC * W));
#pragma unroll
      for (int v = 0; v < V; ++v) nb[tid + v * NT] = pre[v];
    }
    __syncthreads();
  }
}

// Row col of a [rows][64] tile (shared or a global slab) gets the thread's
// eight values of that column.
__device__ __forceinline__ void put8(float* rows, int col, const float (&v)[8]) {
  float* r = rows + col * TP + 4 * pgl();
  *reinterpret_cast<float4*>(r) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(r + 32) = make_float4(v[4], v[5], v[6], v[7]);
}

// The forward epilogue: out = acc + bias (ReLU'd when RELU) into the shared
// tile H and, when st is not null, into the stash slab at column st_col.
template <int NOUT, bool RELU>
__device__ __forceinline__ void store_act(const float (&acc)[8][NOUT / 32],
                                          const float* __restrict__ bias, float* H, float* st,
                                          int st_col) {
#pragma unroll
  for (int j = 0; j < NOUT / 32; ++j) {
    const int col = col_of(j);
    const float bj = __ldg(bias + col);
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = RELU ? fmaxf(acc[i][j] + bj, 0.f) : acc[i][j] + bj;
    put8(H, col, v);
    if (st) put8(st, st_col + col, v);
  }
}

// The encodings of one tile: sX [64][64] = [x, sin(x 2^f), cos(x 2^f), 0]
// (f-major, coordinate-minor, as repack_params orders the rows) and sD
// [32][64] likewise for the directions; the phases x 2^f are exact float32
// products. Points past P read zeros.
__device__ __forceinline__ void encode(const float* __restrict__ pts,
                                       const float* __restrict__ dirs, int p0, int P, float* sX,
                                       float* sD) {
  for (int idx = threadIdx.x; idx < (EX + ED) * TP; idx += NT) {
    const bool isx = idx < EX * TP;
    const int r = (isx ? idx : idx - EX * TP) / TP, p = idx % TP, F = isx ? XF : DF;
    const float* src = isx ? pts : dirs;
    float v = 0.f;
    if (p0 + p < P && r < 3 + 6 * F) {
      if (r < 3) {
        v = __ldg(src + (size_t)(p0 + p) * 3 + r);
      } else {
        const int q = (r - 3) % (3 * F), f = q / 3, c = q % 3;
        const float ph = __ldg(src + (size_t)(p0 + p) * 3 + c) * (float)(1 << f);
        v = r < 3 + 3 * F ? sinf(ph) : cosf(ph);
      }
    }
    (isx ? sX : sD)[r * TP + p] = v;
  }
}

// Shared memory of the forward, in floats.
constexpr int FWD_SX = 0, FWD_SD = FWD_SX + EX * TP, FWD_SH = FWD_SD + ED * TP,
              FWD_SB = FWD_SH + W * TP, FWD_SIG = FWD_SB + 2 * KC * W,
              FWD_SMEM = (FWD_SIG + TP) * 4;

// One 64-point tile of the forward: out[p] = [rgb, sigma] for p < P. With a
// stash (the backward's recomputation) every encoding and activation of the
// tile goes to its slab, in the columns above.
__global__ void __launch_bounds__(NT, 2)
fwd_f32_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
               const float* __restrict__ wbuf, const float* __restrict__ bbuf,
               float* __restrict__ out, int P, float* __restrict__ stash) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float *sX = smem + FWD_SX, *sD = smem + FWD_SD, *sH = smem + FWD_SH, *sB = smem + FWD_SB,
        *sSig = smem + FWD_SIG;
  const int tid = threadIdx.x, p0 = blockIdx.x * TP;
  float* st = stash ? stash + (size_t)blockIdx.x * SLD * TP : nullptr;
  encode(pts, dirs, p0, P, sX, sD);
  __syncthreads();
  if (st) {
    for (int i = tid; i < EX * TP / 4; i += NT)
      reinterpret_cast<float4*>(st + S_X * TP)[i] = reinterpret_cast<const float4*>(sX)[i];
    for (int i = tid; i < ED * TP / 4; i += NT)
      reinterpret_cast<float4*>(st + S_D * TP)[i] = reinterpret_cast<const float4*>(sD)[i];
  }
  float acc[8][8];
  zero<W>(acc);
  product<W>(acc, sX, EX, sX, EX, wbuf + OFF_L0, sB);
  store_act<W, true>(acc, bbuf, sH, st, s_h(1));
  __syncthreads();
  for (int i = 1; i <= 7; ++i) {
    zero<W>(acc);
    if (i == 5)  // the skip layer reads [enc_x, h5]
      product<W>(acc, sX, EX, sH, EX + W, wbuf + OFF_L5, sB);
    else
      product<W>(acc, sH, W, sH, W, wbuf + off_layer(i), sB);
    store_act<W, true>(acc, bbuf + i * W, sH, st, s_h(i + 1));
    __syncthreads();
  }
  {  // sigma = h8 . wa + ba: four threads a point, 64 units each
    const int p = tid >> 2, q = tid & 3;
    float s = 0.f;
    for (int k = q * 64; k < q * 64 + 64; ++k) s = fmaf(sH[k * TP + p], __ldg(wbuf + OFF_WA + k), s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0) sSig[p] = s + __ldg(bbuf + OFF_BA);
  }
  zero<W>(acc);
  product<W>(acc, sH, W, sH, W, wbuf + OFF_LF, sB);
  store_act<W, false>(acc, bbuf + OFF_BF, sH, st, S_FEAT);
  __syncthreads();
  float accv[8][4];
  zero<VW>(accv);
  product<VW>(accv, sH, W, sD, W + ED, wbuf + OFF_LV, sB);
  store_act<VW, true>(accv, bbuf + OFF_BV, sH, st, S_V);
  __syncthreads();
  if (tid < 3 * TP) {  // rgb = v @ Wr + br
    const int p = tid / 3, c = tid % 3;
    float s = 0.f;
    for (int j = 0; j < VW; ++j) s = fmaf(sH[j * TP + p], __ldg(wbuf + OFF_WR + j * 3 + c), s);
    if (p0 + p < P) out[(size_t)(p0 + p) * 4 + c] = s + __ldg(bbuf + OFF_BR + c);
  }
  if (tid < TP && p0 + tid < P) out[(size_t)(p0 + tid) * 4 + 3] = sSig[tid];
}

// Launch the forward on P points (stash: null, or [ceil(P/64), SLD, 64]).
inline cudaError_t launch_fwd(const float* pts, const float* dirs, const float* wbuf,
                              const float* bbuf, float* out, int P, float* stash,
                              cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(fwd_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (e != cudaSuccess) return e;
  if (P <= 0) return cudaSuccess;
  fwd_f32_kernel<<<(P + TP - 1) / TP, NT, FWD_SMEM, stream>>>(pts, dirs, wbuf, bbuf, out, P,
                                                              stash);
  return cudaGetLastError();
}

}  // namespace f32mlp
