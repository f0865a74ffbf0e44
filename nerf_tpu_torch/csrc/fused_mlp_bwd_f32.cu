// Backward of the fused NeRF-MLP with float32 weights (B2-f32), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel nerf_tpu/ops/fused_mlp_bwd.py:43
// (_bwd_kernel) in its float32 mode. Plain PyTorch version:
// nerf_tpu_torch/ops/fused_mlp_bwd.py::fused_nerf_bwd_plain with float32
// weights. It recomputes the forward, then returns the gradient of every
// weight and bias (summed over the points) and, when asked, of the points
// and directions. All products and sums are float32 fmaf on the CUDA cores
// (no TF32, no tensor cores, no library GEMM).
//
// What bounds it on an H100: operations. The forward again, every weight
// gradient dW = X^T G and the input gradient G W^T of every layer: about 3 x
// 593,408 multiply-adds a point at 67 TFLOP/s (float32, data sheet), 10.4 ms
// for a train step's fine batch of 196,608 points.
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
// 3. weight gradients: one block per 128 x 128 tile of a gradient matrix
//    and per range of points ("split"), X and G of 32 points at a time in
//    shared memory, 8 x 8 outer products a thread, its partial sum written
//    to its split's row; a bias is the same product with X = 1;
// 4. reduce: each gradient entry sums its splits' partials in split order.
// Every sum runs in a fixed order, so a call gives the same bits each time.
// The stash and gbuf cost 19.8 KB a point; the launcher runs the four
// launches on chunks of at most `chunk` points (the wrapper's choice:
// 262,144, 5.2 GB of scratch), the reduce adding each chunk's sums to the
// previous ones, so a whole-image tile of 1,572,864 points takes 6 chunks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers; bound with ctypes).

#include "fused_mlp_f32.cuh"

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

// A weight gradient dW[K, N] = X^T G over the points, X from stash columns
// xcol.. (xcol < 0: a bias, X = 1, K = 1), G from gbuf columns gcol..; it goes
// to entry out + k N + n of a split's partial row (wbuf order, then bbuf's).
struct Job {
  int xcol, k, gcol, n, out;
};
constexpr int NJOBS = 26;
constexpr int TK = 128, TN = 128, DW_PTS = 32;  // a block's output tile; points a step
struct Jobs {
  Job job[NJOBS];
  int first[NJOBS + 1];  // first block (x) of each job's tiles
};
constexpr int PST = WBUF_SIZE + BBUF_SIZE;
constexpr int DW_LD = TK + 4;  // row stride of the [points][columns] tiles
constexpr int DW_SMEM = 2 * DW_PTS * DW_LD * 4;

__global__ void __launch_bounds__(NT, 2)
dw_f32_kernel(const float* __restrict__ stash, const float* __restrict__ gbuf,
              float* __restrict__ partial, int nslabs, Jobs jobs) {
  extern __shared__ float4 smem4[];
  float* sXs = reinterpret_cast<float*>(smem4);
  float* sGs = sXs + DW_PTS * DW_LD;
  int j = 0;
  while (blockIdx.x >= jobs.first[j + 1]) ++j;
  const Job jb = jobs.job[j];
  const int ntn = (jb.n + TN - 1) / TN, t = blockIdx.x - jobs.first[j];
  const int k0 = (t / ntn) * TK, n0 = (t % ntn) * TN;
  const int kn = min(TK, jb.k - k0), nn = min(TN, jb.n - n0);
  const int split = blockIdx.y, splits = gridDim.y;
  const int s0 = (int)((long long)nslabs * split / splits);
  const int s1 = (int)((long long)nslabs * (split + 1) / splits);
  const int tid = threadIdx.x, tk = tid >> 4, tn = tid & 15;
  // a thread's rows 4 tk + (0..3), 64 + 4 tk + (0..3); columns likewise by tn
  const bool active = 4 * tk < kn;
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  for (int s = s0; s < s1; ++s) {
    for (int h = 0; h < TP; h += DW_PTS) {
      // X and G of 32 points, transposed to [point][column]
      for (int idx = tid; idx < (TK + TN) * (DW_PTS / 4); idx += NT) {
        const bool isx = idx < TK * (DW_PTS / 4);
        const int c = (isx ? idx : idx - TK * (DW_PTS / 4)) / (DW_PTS / 4), q = idx % (DW_PTS / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (isx ? c < kn : c < nn) {
          if (isx && jb.xcol < 0) {
            v = make_float4(1.f, 1.f, 1.f, 1.f);
          } else {
            const float* src = isx ? stash + ((size_t)s * SLD + jb.xcol + k0 + c) * TP
                                   : gbuf + ((size_t)s * GLD + jb.gcol + n0 + c) * TP;
            v = __ldg(reinterpret_cast<const float4*>(src + h) + q);
          }
        }
        float* dst = (isx ? sXs : sGs) + 4 * q * DW_LD + c;
        dst[0] = v.x;
        dst[DW_LD] = v.y;
        dst[2 * DW_LD] = v.z;
        dst[3 * DW_LD] = v.w;
      }
      __syncthreads();
      if (active) {
#pragma unroll 4
        for (int p = 0; p < DW_PTS; ++p) {
          const float* xr = sXs + p * DW_LD;
          const float* gr = sGs + p * DW_LD;
          const float4 x0 = *reinterpret_cast<const float4*>(xr + 4 * tk);
          const float4 x1 = *reinterpret_cast<const float4*>(xr + 64 + 4 * tk);
          const float4 g0 = *reinterpret_cast<const float4*>(gr + 4 * tn);
          const float4 g1 = *reinterpret_cast<const float4*>(gr + 64 + 4 * tn);
          const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
          const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(x[a], gg[b], acc[a][b]);
        }
      }
      __syncthreads();
    }
  }
  float* dst = partial + (size_t)split * PST + jb.out;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int k = (a & 3) + 4 * tk + 64 * (a >> 2);
    if (k >= kn) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int n = (b & 3) + 4 * tn + 64 * (b >> 2);
      if (n < nn) dst[(size_t)(k0 + k) * jb.n + n0 + n] = acc[a][b];
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

Jobs make_jobs() {
  const Job list[NJOBS] = {
      {S_X, EX, g_col(0), W, OFF_L0},
      {s_h(1), W, g_col(1), W, off_layer(1)},
      {s_h(2), W, g_col(2), W, off_layer(2)},
      {s_h(3), W, g_col(3), W, off_layer(3)},
      {s_h(4), W, g_col(4), W, off_layer(4)},
      {S_X, EX, g_col(5), W, OFF_L5},
      {s_h(5), W, g_col(5), W, OFF_L5 + EX * W},
      {s_h(6), W, g_col(6), W, off_layer(6)},
      {s_h(7), W, g_col(7), W, off_layer(7)},
      {s_h(8), W, G_F, W, OFF_LF},
      {S_FEAT, W, G_V, VW, OFF_LV},
      {S_D, ED, G_V, VW, OFF_LV + W * VW},
      {s_h(8), W, G_IN + 3, 1, OFF_WA},
      {S_V, VW, G_IN, 3, OFF_WR},
      {-1, 1, g_col(0), W, WBUF_SIZE},
      {-1, 1, g_col(1), W, WBUF_SIZE + W},
      {-1, 1, g_col(2), W, WBUF_SIZE + 2 * W},
      {-1, 1, g_col(3), W, WBUF_SIZE + 3 * W},
      {-1, 1, g_col(4), W, WBUF_SIZE + 4 * W},
      {-1, 1, g_col(5), W, WBUF_SIZE + 5 * W},
      {-1, 1, g_col(6), W, WBUF_SIZE + 6 * W},
      {-1, 1, g_col(7), W, WBUF_SIZE + 7 * W},
      {-1, 1, G_F, W, WBUF_SIZE + OFF_BF},
      {-1, 1, G_V, VW, WBUF_SIZE + OFF_BV},
      {-1, 1, G_IN + 3, 1, WBUF_SIZE + OFF_BA},
      {-1, 1, G_IN, 3, WBUF_SIZE + OFF_BR},
  };
  Jobs jobs;
  jobs.first[0] = 0;
  for (int j = 0; j < NJOBS; ++j) {
    jobs.job[j] = list[j];
    jobs.first[j + 1] = jobs.first[j] + ((list[j].k + TK - 1) / TK) * ((list[j].n + TN - 1) / TN);
  }
  return jobs;
}

}  // namespace f32mlp

using namespace f32mlp;

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
// recomputed forward; dpts, ddirs [P, 3] when input_grads. phases selects
// the launches (1 forward, 2 chain, 4 weight gradients, 8 reduce; 15 all),
// for timing. Returns the CUDA error code.
extern "C" int launch_fused_nerf_bwd_f32(const void* pts, const void* dirs, const void* g,
                                         const void* wbuf, const void* bbuf, const void* wbuf_t,
                                         void* stash, void* gbuf, void* partial, void* flat,
                                         void* raw, void* dpts, void* ddirs, int P, int chunk,
                                         int splits, int input_grads, int phases,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                FWD_SMEM)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(chain_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                CH_SMEM)) != cudaSuccess)
    return (int)e;
  if (P <= 0 || P % TP || chunk <= 0 || chunk % TP || splits <= 0) return (int)cudaErrorInvalidValue;
  static const Jobs jobs = make_jobs();
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
      dw_f32_kernel<<<dim3(jobs.first[NJOBS], splits), NT, DW_SMEM, s>>>(
          (const float*)stash, (const float*)gbuf, (float*)partial, tiles, jobs);
    if (phases & 8)
      reduce_f32_kernel<<<(PST + 255) / 256, 256, 0, s>>>((const float*)partial, (float*)flat,
                                                          splits, c0 > 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}
