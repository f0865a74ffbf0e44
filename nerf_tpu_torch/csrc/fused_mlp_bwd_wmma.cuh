// The wmma backward of the fused NeRF-MLP (nvcuda::wmma products, the row
// stash [P, SLD] and layer gradients [P, GLD] written by the wmma forward of
// fused_mlp.cuh), kept beside its Hopper redesign in fused_mlp_bwd.cu as the
// yardstick that chip_smoke.py and the GPU tests hold it against; no path of
// the port calls it. Exported as launch_fused_nerf_bwd_wmma.
//
// Its launches: 1. fused_nerf_kernel<true>, the forward again with the row
// stash; 2. bwd_chain_kernel, dX = G @ W^T layer after layer on wmma 16x16x16
// products, masks read from the bf16 stash; 3. wgrad_kernel, dW = X^T @ G
// over `splits` point ranges into f32 partials; 4. head_wgrad_kernel, the
// sigma and rgb heads; 5. reduce_kernel (fused_mlp_bwd.cu), the sum of the
// partials in a fixed order. P must be a multiple of 64.
#pragma once

#include "fused_mlp.cuh"

namespace {
namespace wmma_bwd {

// ---- 2. the dX chain ----
constexpr int LDG = W + 8;             // shared gradient tile row stride (bf16)
constexpr int DLD = EX + ED;           // f32 encoding gradients: enc_x (64), enc_d (32)
constexpr int CHAIN_SMEM = 2 * TP * LDG * 2 + (TP * DLD + STAGE_FLOATS + TP * 4 + 2 * TP * 3) * 4;

static_assert((TP * LDG * 2) % 128 == 0, "gradient tiles must stay aligned");

// One layer's input gradient: out[p, k] = sum_n gsrc[p, n] * w[k, n], w the
// forward's [KO, NR] weights. Output columns [enc_lo, enc_hi) add into the
// f32 encoding gradients at denc column enc_dst (skipped unless enc);
// the others k become gdst[p, k - g_lo] = bf16((v + extra) * mask), with
// mask = stash[p, xcol + k] > 0 when xcol >= 0, extra = g[p, 3] * wa[k] when
// wa is not null, also written to gbuf column gcol + k - g_lo. gdst may be
// null (layer 0 has no G below it).
template <int NR, int KO>
__device__ __forceinline__ void dx_layer(const bf16* gsrc, bf16* gdst, const bf16* __restrict__ w,
                                         int enc_lo, int enc_hi, int enc_dst, bool enc,
                                         int g_lo, int xcol, const bf16* __restrict__ wa,
                                         float* denc, const float* gs, float* stage,
                                         const bf16* __restrict__ stash, bf16* __restrict__ gbuf,
                                         int gcol, long long base) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1;
  const int c0 = (lane & 1) * 8;
  for (int ct = warp; ct < KO / 16; ct += NWARPS) {
    const int k0 = ct * 16;
    const bool to_enc = k0 >= enc_lo && k0 < enc_hi;
    if (to_enc && !enc) continue;
    if (!to_enc && gdst == nullptr) continue;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) wmma::fill_fragment(acc[r], 0.0f);
#pragma unroll 2
    for (int n = 0; n < NR; n += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;  // b(n, k) = w[k, n]
      wmma::load_matrix_sync(b, w + (size_t)k0 * NR + n, NR);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, gsrc + r * 16 * LDG + n, LDG);
        wmma::mma_sync(acc[r], a, b, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wmma::store_matrix_sync(stage, acc[r], 16, wmma::mem_row_major);
      __syncwarp();
      const int p = r * 16 + row;
      const int k = k0 + c0;
      if (to_enc) {
#pragma unroll
        for (int j = 0; j < 8; ++j) denc[p * DLD + enc_dst + k - enc_lo + j] += stage[row * 16 + c0 + j];
      } else {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = stage[row * 16 + c0 + j];
        if (wa != nullptr) {
          const float ds = gs[p * 4 + 3];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] += ds * __bfloat162float(wa[k + j]);
        }
        if (xcol >= 0) {
          const uint4 hx = *reinterpret_cast<const uint4*>(stash + (base + p) * SLD + xcol + k);
          const bf16* h = reinterpret_cast<const bf16*>(&hx);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (!(__bfloat162float(h[j]) > 0.0f)) v[j] = 0.0f;
        }
        uint4 pk;
        uint32_t* pw = reinterpret_cast<uint32_t*>(&pk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
          pw[j] = *reinterpret_cast<uint32_t*>(&two);
        }
        const int gk = k - g_lo;
        *reinterpret_cast<uint4*>(gdst + p * LDG + gk) = pk;
        *reinterpret_cast<uint4*>(gbuf + (base + p) * GLD + gcol + gk) = pk;
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS)
bwd_chain_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                 const float* __restrict__ g, const bf16* __restrict__ wbuf,
                 const bf16* __restrict__ stash, bf16* __restrict__ gbuf,
                 float* __restrict__ dpts, float* __restrict__ ddirs, int input_grads) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ga = reinterpret_cast<bf16*>(smem);
  bf16* gb = ga + TP * LDG;
  float* denc = reinterpret_cast<float*>(gb + TP * LDG);
  float* stage_all = denc + TP * DLD;
  float* stage = stage_all + (threadIdx.x >> 5) * 256;
  float* gs = stage_all + STAGE_FLOATS;  // [TP][4]
  float* xs = gs + TP * 4;               // [TP][3]
  float* ds = xs + TP * 3;               // [TP][3]

  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * TP;
  const bool enc = input_grads != 0;
  for (int i = tid; i < TP * 4; i += NTHREADS) gs[i] = g[base * 4 + i];
  for (int i = tid; i < TP * 3; i += NTHREADS) {
    xs[i] = pts[base * 3 + i];
    ds[i] = dirs[base * 3 + i];
  }
  for (int i = tid; i < TP * DLD; i += NTHREADS) denc[i] = 0.0f;
  __syncthreads();

  // rgb head: dv = drgb @ wr^T (f32), masked by v > 0 -> the view layer's G
  for (int i = tid; i < TP * VW; i += NTHREADS) {
    const int p = i / VW, k = i % VW;
    const bf16* wr = wbuf + OFF_WR + k * 3;
    float v = gs[p * 4] * __bfloat162float(wr[0]) + gs[p * 4 + 1] * __bfloat162float(wr[1]) +
              gs[p * 4 + 2] * __bfloat162float(wr[2]);
    if (!(__bfloat162float(stash[(base + p) * SLD + S_V + k]) > 0.0f)) v = 0.0f;
    const bf16 vb = __float2bfloat16_rn(v);
    ga[p * LDG + k] = vb;
    gbuf[(base + p) * GLD + G_VIEW + k] = vb;
  }
  __syncthreads();

  // view layer [feat, enc_d] <- G_view: the feature (no activation) and enc_d
  dx_layer<VW, W + ED>(ga, gb, wbuf + OFF_WV, W, W + ED, EX, enc, 0, -1, nullptr,
                       denc, gs, stage, stash, gbuf, G_FEAT, base);
  // feature layer and sigma head -> h8, masked: G_7
  dx_layer<W, W>(gb, ga, wbuf + OFF_WF, 0, 0, 0, enc, 0, s_h(7), wbuf + OFF_WA,
                 denc, gs, stage, stash, gbuf, 7 * W, base);
  dx_layer<W, W>(ga, gb, wbuf + OFF_W7, 0, 0, 0, enc, 0, s_h(6), nullptr,
                 denc, gs, stage, stash, gbuf, 6 * W, base);
  dx_layer<W, W>(gb, ga, wbuf + OFF_W6, 0, 0, 0, enc, 0, s_h(5), nullptr,
                 denc, gs, stage, stash, gbuf, 5 * W, base);
  // skip layer: [enc_x, h5]; stash columns S_EX + k hold exactly that input
  dx_layer<W, EX + W>(ga, gb, wbuf + OFF_W5, 0, EX, 0, enc, EX, S_EX, nullptr,
                      denc, gs, stage, stash, gbuf, 4 * W, base);
  dx_layer<W, W>(gb, ga, wbuf + OFF_W4, 0, 0, 0, enc, 0, s_h(3), nullptr,
                 denc, gs, stage, stash, gbuf, 3 * W, base);
  dx_layer<W, W>(ga, gb, wbuf + OFF_W3, 0, 0, 0, enc, 0, s_h(2), nullptr,
                 denc, gs, stage, stash, gbuf, 2 * W, base);
  dx_layer<W, W>(gb, ga, wbuf + OFF_W2, 0, 0, 0, enc, 0, s_h(1), nullptr,
                 denc, gs, stage, stash, gbuf, 1 * W, base);
  dx_layer<W, W>(ga, gb, wbuf + OFF_W1, 0, 0, 0, enc, 0, s_h(0), nullptr,
                 denc, gs, stage, stash, gbuf, 0, base);
  if (!enc) return;
  dx_layer<W, EX>(gb, nullptr, wbuf + OFF_W0, 0, EX, 0, enc, 0, -1, nullptr,
                  denc, gs, stage, stash, gbuf, 0, base);

  // d/dx of [x, sin(x 2^f), cos(x 2^f)]: the phases again in exact f32
  for (int i = tid; i < TP * 3; i += NTHREADS) {
    const int p = i / 3, j = i % 3;
    const float* de = denc + p * DLD;
    float acc = de[j];
#pragma unroll
    for (int f = 0; f < XF; ++f) {
      float s, c;
      sincosf(xs[i] * (float)(1 << f), &s, &c);
      acc += (float)(1 << f) * (c * de[3 + f * 3 + j] - s * de[3 + 3 * XF + f * 3 + j]);
    }
    dpts[base * 3 + i] = acc;
    const float* dd = de + EX;
    float accd = dd[j];
#pragma unroll
    for (int f = 0; f < DF; ++f) {
      float s, c;
      sincosf(ds[i] * (float)(1 << f), &s, &c);
      accd += (float)(1 << f) * (c * dd[3 + f * 3 + j] - s * dd[3 + 3 * DF + f * 3 + j]);
    }
    ddirs[base * 3 + i] = accd;
  }
}

// ---- 3. weight gradients, split over the points ----
struct Layer {
  int xcol, K, gcol, N, woff, boff;
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
constexpr int BK = 64, BN = 128;       // block tile of dW; 8 warps of 32 x 32

__host__ __device__ constexpr int layer_tiles(int K, int N) {
  return ((K + BK - 1) / BK) * (N / BN);
}
constexpr int WGRAD_TILES = layer_tiles(EX, W) + 4 * layer_tiles(W, W) + layer_tiles(EX + W, W) +
                            2 * layer_tiles(W, W) + layer_tiles(W, W) + layer_tiles(W + ED, VW);

__global__ void __launch_bounds__(NTHREADS)
wgrad_kernel(const bf16* __restrict__ stash, const bf16* __restrict__ gbuf,
             float* __restrict__ partial, int P, int chunk) {
  __shared__ float bsum[NTHREADS];
  int t = blockIdx.x, li = 0;
  while (li < NLAYERS - 1 && t >= layer_tiles(kLayers[li].K, kLayers[li].N)) {
    t -= layer_tiles(kLayers[li].K, kLayers[li].N);
    ++li;
  }
  const Layer L = kLayers[li];
  const int tiles_n = L.N / BN;
  const int kt = t / tiles_n, nt = t % tiles_n;
  const int s = blockIdx.y;
  const long long p0 = (long long)s * chunk;
  const long long p1 = min((long long)P, p0 + chunk);
  float* out = partial + (size_t)s * PST;

  const int warp = threadIdx.x >> 5;
  const int k0 = kt * BK + (warp >> 2) * 32;
  const int n0 = nt * BN + (warp & 3) * 32;
  if (k0 < L.K) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (long long p = p0; p < p1; p += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];  // a(k, p) = X[p, k]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];  // b(p, n) = G[p, n]
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], stash + p * SLD + L.xcol + k0 + i * 16, SLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], gbuf + p * GLD + L.gcol + n0 + j * 16, GLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(out + L.woff + (size_t)(k0 + i * 16) * L.N + n0 + j * 16,
                                acc[i][j], L.N, wmma::mem_row_major);
  }
  if (kt == 0) {  // bias: the column sums of G over this split's points
    const int col = threadIdx.x % BN, half = threadIdx.x / BN;
    float sum = 0.0f;
    for (long long p = p0 + half; p < p1; p += 2)
      sum += __bfloat162float(gbuf[p * GLD + L.gcol + nt * BN + col]);
    bsum[threadIdx.x] = sum;
    __syncthreads();
    if (half == 0)
      out[WBUF_SIZE + L.boff + nt * BN + col] = bsum[threadIdx.x] + bsum[threadIdx.x + BN];
  }
}

// ---- 4. the sigma and rgb heads ----
constexpr int HQ = 4;                  // point lanes per column: 4 x 256 threads
__global__ void __launch_bounds__(HQ * W)
head_wgrad_kernel(const bf16* __restrict__ stash, const float* __restrict__ g,
                  float* __restrict__ partial, int P, int chunk) {
  __shared__ float red[HQ][W + VW * 3];
  const int s = blockIdx.x;
  const int col = threadIdx.x % W, q = threadIdx.x / W;
  const long long p0 = (long long)s * chunk;
  const long long p1 = min((long long)P, p0 + chunk);
  float* out = partial + (size_t)s * PST;
  float wa = 0.0f, wr0 = 0.0f, wr1 = 0.0f, wr2 = 0.0f;
#pragma unroll 4
  for (long long p = p0 + q; p < p1; p += HQ) {
    const float* gp = g + p * 4;
    wa += __bfloat162float(stash[p * SLD + s_h(7) + col]) * gp[3];  // h8 . dsigma
    if (col < VW) {
      const float v = __bfloat162float(stash[p * SLD + S_V + col]);
      wr0 += v * gp[0];
      wr1 += v * gp[1];
      wr2 += v * gp[2];
    }
  }
  red[q][col] = wa;
  if (col < VW) {
    red[q][W + col * 3] = wr0;
    red[q][W + col * 3 + 1] = wr1;
    red[q][W + col * 3 + 2] = wr2;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < W + VW * 3; i += HQ * W) {
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < HQ; ++j) sum += red[j][i];
    out[i < W ? OFF_WA + i : OFF_WR + i - W] = sum;
  }
  if (threadIdx.x < 32) {  // ba, br: the column sums of g
    const int lane = threadIdx.x;
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (long long p = p0 + lane; p < p1; p += 32)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] += g[p * 4 + j];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) c[j] += __shfl_xor_sync(0xffffffffu, c[j], o);
    if (lane == 0) {
      out[WBUF_SIZE + OFF_BA] = c[3];
      for (int j = 0; j < 3; ++j) out[WBUF_SIZE + OFF_BR + j] = c[j];
    }
  }
}

}  // namespace wmma_bwd
}  // namespace
