// Shared by fused_mlp.cu (the serving forward) and fused_mlp_bwd.cu (the
// backward, which recomputes the forward with STASH = true). The design note
// is in fused_mlp.cu.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int TP = 64;                 // points per block
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RT = TP / 16;            // row tiles per block (each warp does all)
constexpr int W = 256;                 // trunk width
constexpr int VW = 128;                // view layer width
constexpr int XF = 10;                 // xyz frequency bands
constexpr int DF = 4;                  // dir frequency bands
constexpr int EX = 64;                 // xyz encoding 3 + 2*30 = 63, padded to 64
constexpr int ED = 32;                 // dir encoding 3 + 2*12 = 27, padded to 32

// activation tile columns (bf16), one row per point
constexpr int COL_EX = 0;              // xyz encoding; later the view layer output
constexpr int COL_H = EX;              // trunk activations; later the feature
constexpr int COL_ED = EX + W;         // dir encoding (right after the feature)
constexpr int LDA = EX + W + ED + 8;   // row stride; +8 staggers shared-memory banks

// bf16 weight buffer: matrices [K, N] row-major, in this order
constexpr int OFF_W0 = 0;                       // [64, 256]: x, sin, cos, 0
constexpr int OFF_W1 = OFF_W0 + EX * W;
constexpr int OFF_W2 = OFF_W1 + W * W;
constexpr int OFF_W3 = OFF_W2 + W * W;
constexpr int OFF_W4 = OFF_W3 + W * W;
constexpr int OFF_W5 = OFF_W4 + W * W;          // [320, 256]: x, sin, cos, 0, h
constexpr int OFF_W6 = OFF_W5 + (EX + W) * W;
constexpr int OFF_W7 = OFF_W6 + W * W;
constexpr int OFF_WF = OFF_W7 + W * W;
constexpr int OFF_WV = OFF_WF + W * W;          // [288, 128]: feat, d, sin, cos, 0
constexpr int OFF_WA = OFF_WV + (W + ED) * VW;  // [256]
constexpr int OFF_WR = OFF_WA + W;              // [128, 3]
constexpr int WBUF_SIZE = OFF_WR + VW * 3;
// f32 bias buffer
constexpr int OFF_BF = 8 * W;
constexpr int OFF_BV = OFF_BF + W;
constexpr int OFF_BA = OFF_BV + VW;
constexpr int OFF_BR = OFF_BA + 1;
constexpr int BBUF_SIZE = OFF_BR + 3;

// Activation stash of the backward's recomputed forward: one bf16 row of SLD
// columns per point, holding each layer's input so that the skip and view
// inputs are adjacent columns as in the tile:
//   h1 h2 h3 h4 | enc_x h5 | h6 h7 h8 | feat enc_d | v
// (h_i is the output of trunk layer i-1, after its ReLU).
constexpr int S_EX = 4 * W;                     // 1024, enc_x; layer 5 reads [enc_x, h5]
constexpr int S_FEAT = S_EX + EX + 4 * W;      // 2112, after h5..h8; the view layer reads [feat, enc_d]
constexpr int S_ED = S_FEAT + W;               // 2368
constexpr int S_V = S_ED + ED;                 // 2400
constexpr int SLD = S_V + VW;                  // 2528 columns
// the stash column of h_{l+1}, the output of trunk layer l (0..7)
__host__ __device__ constexpr int s_h(int l) { return l < 4 ? l * W : S_EX + EX + (l - 4) * W; }

constexpr int ACT_BYTES = TP * LDA * 2;
constexpr int STAGE_FLOATS = NWARPS * 256;      // one 16x16 f32 tile per warp
constexpr int SMEM_BYTES = ACT_BYTES + (STAGE_FLOATS + 2 * TP * 3 + TP) * 4;

static_assert(ACT_BYTES % 128 == 0, "staging area must stay aligned");
static_assert((LDA * 2) % 16 == 0, "rows must stay 16-byte aligned");

// One dense layer on the tile: act[:, out_col:out_col+N] =
//   act(bias + act[:, in_col:in_col+K] @ w), written as bf16.
// N = NWARPS * CT * 16; warp w owns column tiles [w*CT, (w+1)*CT), all rows.
template <int K, int CT>
__device__ __forceinline__ void dense_layer(bf16* act, int in_col, int out_col,
                                            const bf16* __restrict__ w,
                                            const float* __restrict__ bias,
                                            bool relu, float* stage) {
  constexpr int N = NWARPS * CT * 16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT][CT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) wmma::fill_fragment(acc[r][c], 0.0f);

#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c)
      wmma::load_matrix_sync(b[c], w + (size_t)k * N + (warp * CT + c) * 16, N);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, act + r * 16 * LDA + in_col + k, LDA);
#pragma unroll
      for (int c = 0; c < CT; ++c) wmma::mma_sync(acc[r][c], a, b[c], acc[r][c]);
    }
  }
  __syncthreads();  // every warp has read the input before anyone overwrites it

  // lane l converts 8 consecutive elements of row l/2 of each 16x16 tile
  const int row = lane >> 1;
  const int c0 = (lane & 1) * 8;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      wmma::store_matrix_sync(stage, acc[r][c], 16, wmma::mem_row_major);
      __syncwarp();
      const int col = (warp * CT + c) * 16 + c0;
      uint4 pk;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&pk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v0 = stage[row * 16 + c0 + 2 * j] + bias[col + 2 * j];
        float v1 = stage[row * 16 + c0 + 2 * j + 1] + bias[col + 2 * j + 1];
        if (relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        __nv_bfloat162 two = __floats2bfloat162_rn(v0, v1);  // v0 in the low half
        pw[j] = *reinterpret_cast<uint32_t*>(&two);
      }
      *reinterpret_cast<uint4*>(act + (r * 16 + row) * LDA + out_col + col) = pk;
      __syncwarp();
    }
  }
  __syncthreads();
}

// Writes [v, sin(v*2^f) f-major, cos(v*2^f) f-major, 0...] for one point.
template <int NF, int WIDTH>
__device__ __forceinline__ void encode(const float* v, bf16* dst, int k) {
  // k in [0, 3*NF): one phase; k in [3*NF, 3*NF + 3): the input itself;
  // the rest: zero padding
  if (k < 3 * NF) {
    const int f = k / 3, j = k % 3;
    float s, c;
    sincosf(v[j] * (float)(1 << f), &s, &c);  // exact f32 phase
    dst[3 + k] = __float2bfloat16_rn(s);
    dst[3 + 3 * NF + k] = __float2bfloat16_rn(c);
  } else if (k < 3 * NF + 3) {
    dst[k - 3 * NF] = __float2bfloat16_rn(v[k - 3 * NF]);
  } else if (k < 3 * NF + 3 + (WIDTH - 3 - 6 * NF)) {
    dst[3 + 6 * NF + (k - 3 * NF - 3)] = __float2bfloat16_rn(0.0f);
  }
}

// Copies columns [col, col + ncols) of the activation tile to columns
// [scol, scol + ncols) of the stash rows of this block's points.
__device__ __forceinline__ void stash_cols(const bf16* act, int col, int ncols, bf16* stash,
                                           int scol, long long base, int P) {
  const int per_row = ncols / 8;
  for (int i = threadIdx.x; i < TP * per_row; i += NTHREADS) {
    const int row = i / per_row, c8 = (i % per_row) * 8;
    if (base + row < P)
      *reinterpret_cast<uint4*>(stash + (base + row) * SLD + scol + c8) =
          *reinterpret_cast<const uint4*>(act + row * LDA + col + c8);
  }
}

// STASH = false: the serving forward, out [P, 4]. STASH = true: the same
// forward, which also writes every layer's bf16 input to stash [P, SLD]
// (the layout above) for the backward; out may then be null.
template <bool STASH>
__global__ void __launch_bounds__(NTHREADS)
fused_nerf_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                  const bf16* __restrict__ wbuf, const float* __restrict__ bbuf,
                  float* __restrict__ out, int P, bf16* __restrict__ stash) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  float* stage_all = reinterpret_cast<float*>(smem + ACT_BYTES);
  float* stage = stage_all + (threadIdx.x >> 5) * 256;
  float* xs = stage_all + STAGE_FLOATS;  // [TP][3]
  float* ds = xs + TP * 3;               // [TP][3]
  float* sig = ds + TP * 3;              // [TP]

  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * TP;

  for (int i = tid; i < TP * 3; i += NTHREADS) {
    const long long g = base * 3 + i;
    const bool ok = base + i / 3 < P;
    xs[i] = ok ? pts[g] : 0.0f;
    ds[i] = ok ? dirs[g] : 0.0f;
  }
  __syncthreads();

  constexpr int KX = 3 * XF + 3 + (EX - 3 - 6 * XF);  // 34 encode jobs per point
  constexpr int KD = 3 * DF + 3 + (ED - 3 - 6 * DF);  // 20
  for (int i = tid; i < TP * KX; i += NTHREADS) {
    const int p = i / KX;
    encode<XF, EX>(xs + p * 3, act + p * LDA + COL_EX, i % KX);
  }
  for (int i = tid; i < TP * KD; i += NTHREADS) {
    const int p = i / KD;
    encode<DF, ED>(ds + p * 3, act + p * LDA + COL_ED, i % KD);
  }
  __syncthreads();
  if (STASH) {
    stash_cols(act, COL_EX, EX, stash, S_EX, base, P);
    stash_cols(act, COL_ED, ED, stash, S_ED, base, P);
  }

  dense_layer<EX, 2>(act, COL_EX, COL_H, wbuf + OFF_W0, bbuf + 0 * W, true, stage);
  if (STASH) stash_cols(act, COL_H, W, stash, s_h(0), base, P);
  dense_layer<W, 2>(act, COL_H, COL_H, wbuf + OFF_W1, bbuf + 1 * W, true, stage);
  if (STASH) stash_cols(act, COL_H, W, stash, s_h(1), base, P);
  dense_layer<W, 2>(act, COL_H, COL_H, wbuf + OFF_W2, bbuf + 2 * W, true, stage);
  if (STASH) stash_cols(act, COL_H, W, stash, s_h(2), base, P);
  dense_layer<W, 2>(act, COL_H, COL_H, wbuf + OFF_W3, bbuf + 3 * W, true, stage);
  if (STASH) stash_cols(act, COL_H, W, stash, s_h(3), base, P);
  dense_layer<W, 2>(act, COL_H, COL_H, wbuf + OFF_W4, bbuf + 4 * W, true, stage);
  if (STASH) stash_cols(act, COL_H, W, stash, s_h(4), base, P);
  // skip: [encoding, h] are adjacent columns, so layer 5 is one K=320 product
  dense_layer<EX + W, 2>(act, COL_EX, COL_H, wbuf + OFF_W5, bbuf + 5 * W, true, stage);
  if (STASH) stash_cols(act, COL_H, W, stash, s_h(5), base, P);
  dense_layer<W, 2>(act, COL_H, COL_H, wbuf + OFF_W6, bbuf + 6 * W, true, stage);
  if (STASH) stash_cols(act, COL_H, W, stash, s_h(6), base, P);
  dense_layer<W, 2>(act, COL_H, COL_H, wbuf + OFF_W7, bbuf + 7 * W, true, stage);
  if (STASH) stash_cols(act, COL_H, W, stash, s_h(7), base, P);

  {  // sigma head: 4 threads per point, 64 products each
    const int p = tid >> 2, part = tid & 3;
    const bf16* h = act + p * LDA + COL_H + part * 64;
    const bf16* wa = wbuf + OFF_WA + part * 64;
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < 64; ++k) s += __bfloat162float(h[k]) * __bfloat162float(wa[k]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) sig[p] = s + bbuf[OFF_BA];
  }
  // feature (no activation), written over h; then the view layer reads
  // [feat, dir encoding], which are adjacent columns
  dense_layer<W, 2>(act, COL_H, COL_H, wbuf + OFF_WF, bbuf + OFF_BF, false, stage);
  if (STASH) stash_cols(act, COL_H, W, stash, S_FEAT, base, P);
  dense_layer<W + ED, 1>(act, COL_H, COL_EX, wbuf + OFF_WV, bbuf + OFF_BV, true, stage);
  if (STASH) stash_cols(act, COL_EX, VW, stash, S_V, base, P);
  if (out == nullptr) return;

  if (tid < TP * 3) {  // rgb head
    const int p = tid / 3, c = tid % 3;
    const bf16* v = act + p * LDA + COL_EX;
    const bf16* wr = wbuf + OFF_WR + c;
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < VW; ++k) s += __bfloat162float(v[k]) * __bfloat162float(wr[k * 3]);
    if (base + p < P) out[(base + p) * 4 + c] = s + bbuf[OFF_BR + c];
  } else {
    const int p = tid - TP * 3;
    if (p < TP && base + p < P) out[(base + p) * 4 + 3] = sig[p];
  }
}

}  // namespace
