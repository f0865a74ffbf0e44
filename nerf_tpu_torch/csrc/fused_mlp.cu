// Fused frequency encoding + NeRF-MLP forward for Hopper (sm_90a).
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
// tensor cores, not the 3.35 TB/s of device memory, set the floor.
//
// What the design does about it: a block holds a tile of 64 points and keeps
// its whole activation tile (encoding, trunk, feature, view input) in shared
// memory as bf16, so no intermediate touches device memory. It walks the
// layers and streams each bf16 weight matrix from global memory, where the
// 1.19 MB of weights stay L2-resident (they do not fit in one SM's 227 KB,
// as they do in a TPU core's VMEM). The products run on the tensor cores as
// nvcuda::wmma 16x16x16 bf16 -> f32 fragments: 8 warps, each owning all 64
// rows of 1-2 column tiles of 16. The accumulators stay in registers until
// every warp has read the layer's input, so each layer writes its output in
// place. The sigma (N=1) and rgb (N=3) heads are 0.1% of the work and run as
// scalar dot products. A later change can move the products to wgmma/TMA.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers; bound with ctypes).

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

__global__ void __launch_bounds__(NTHREADS)
fused_nerf_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                  const bf16* __restrict__ wbuf, const float* __restrict__ bbuf,
                  float* __restrict__ out, int P) {
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

  dense_layer<EX, 2>(act, COL_EX, COL_H, wbuf + OFF_W0, bbuf + 0 * W, true, stage);
  dense_layer<W, 2>(act, COL_H, COL_H, wbuf + OFF_W1, bbuf + 1 * W, true, stage);
  dense_layer<W, 2>(act, COL_H, COL_H, wbuf + OFF_W2, bbuf + 2 * W, true, stage);
  dense_layer<W, 2>(act, COL_H, COL_H, wbuf + OFF_W3, bbuf + 3 * W, true, stage);
  dense_layer<W, 2>(act, COL_H, COL_H, wbuf + OFF_W4, bbuf + 4 * W, true, stage);
  // skip: [encoding, h] are adjacent columns, so layer 5 is one K=320 product
  dense_layer<EX + W, 2>(act, COL_EX, COL_H, wbuf + OFF_W5, bbuf + 5 * W, true, stage);
  dense_layer<W, 2>(act, COL_H, COL_H, wbuf + OFF_W6, bbuf + 6 * W, true, stage);
  dense_layer<W, 2>(act, COL_H, COL_H, wbuf + OFF_W7, bbuf + 7 * W, true, stage);

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
  dense_layer<W + ED, 1>(act, COL_H, COL_EX, wbuf + OFF_WV, bbuf + OFF_BV, true, stage);

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

extern "C" void fused_nerf_buffer_sizes(int* wbuf, int* bbuf) {
  *wbuf = WBUF_SIZE;
  *bbuf = BBUF_SIZE;
}

// pts, dirs: [P, 3] f32; wbuf: WBUF_SIZE bf16 (32-byte aligned);
// bbuf: BBUF_SIZE f32; out: [P, 4] f32. Returns the CUDA error code.
extern "C" int launch_fused_nerf(const void* pts, const void* dirs, const void* wbuf,
                                 const void* bbuf, void* out, int P, void* stream) {
  // above 48 KB of dynamic shared memory a kernel must opt in (per device)
  cudaError_t e = cudaFuncSetAttribute(
      fused_nerf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  if (P <= 0) return 0;
  const int blocks = (P + TP - 1) / TP;
  fused_nerf_kernel<<<blocks, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)dirs, (const bf16*)wbuf, (const float*)bbuf,
      (float*)out, P);
  return (int)cudaGetLastError();
}
