// Volume compositing (alpha integration with early ray termination) for Hopper.
//
// Replaces the Pallas TPU kernel nerf_tpu/ops/integrate.py:24 (_integrate_kernel).
// Plain PyTorch version: nerf_tpu_torch/ops/integrate.py::integrate_plain.
//
// What it computes, per ray of S samples: dists = (z[i+1] - z[i], tail 1e10)
// * |d|; density relu, softplus or exp (act 0, 1, 2); lam = dens * dist; alpha = 1 - exp(-lam);
// exclusive log-transmittance sum_{j<i} log(exp(-lam_j) + 1e-10), each term
// formed as a stable logaddexp; T = exp(.); w = alpha * T, zeroed where
// T < ert (ERT, when ert > 0); rgb = sum w * sigmoid(rgb_raw), depth =
// sum w * z, acc = sum w, and the weights themselves.
//
// What bounds it on an H100: bytes. 20 bytes read (raw rgb+sigma, z) and
// 4 written (weight) per sample against ~40 flops, far below the 295
// flop/byte ridge, so 3.35 TB/s of device memory sets the floor.
//
// What the design does about it: one warp per ray, each lane owning K =
// ceil(S/32) consecutive samples (rays of up to 256 samples), all of whose
// loads it issues before any math, through L1 (a lane's samples share
// 32-byte sectors), so a ray costs one round trip to memory and the rays in
// flight keep the loads streaming.
// A lane takes z[i+1] from its own registers, or its neighbour's by one
// shuffle, sums its own samples' log terms serially, and one 5-shuffle
// exclusive warp scan of the lane sums gives each lane the log-transmittance
// arriving at its first sample: one scan per ray in place of the TPU's
// triangular-matmul cumsum. Blocks of 4 warps spread even the 1,024-ray
// tiles over all 132 SMs. Longer rays go in chunks of 64 samples, the next
// chunk's loads issued before this chunk's math, and there ERT is an early
// exit: transmittance only falls, so once T after a chunk is below the
// threshold the rest of the ray's weights are written as 0 without reading
// its samples. Either way a weight is zero exactly where T < ert.
// tools/integrate_variants.py measured the alternatives (every ray in
// chunks of 32, 64 or 128, read-once loads, block sizes).
//
// Counting ERT's cut (a non-null ert_cut, while the program's spans are on):
// each lane counts its samples whose weight ERT zeroes (T < ert, or the whole
// chunk when it is skipped as done), a warp sum gives the ray's count (S
// minus its first sample past the cut, as T only falls), and each block adds
// its rays' counts to the counter with one atomic. A null counter launches
// the kernel without any of it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers; bound with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG_EPS = -23.025850929940457f;  // log(1e-10)
// Switched by nerf_tpu_torch/tools/integrate_variants.py: warps (rays) per
// block; rays of up to 256 samples loaded whole rather than in chunks;
// samples a lane takes in each chunk; loads marked read-once (ld.global.cs)
// rather than through L1 (ld.global.nc).
constexpr int WARPS_PER_BLOCK = 4;
constexpr bool UP_FRONT = true;
constexpr int MAX_K = 8;  // samples a lane holds when loading a ray whole
constexpr int CHUNK_K = 2;
constexpr bool STREAM_LOADS = false;

// The density of raw sigma: relu (act 0), softplus (1, in a form that does
// not overflow) or exp (2, Instant-NGP's log-space density). act is the
// same for every thread of a launch.
__device__ __forceinline__ float density(float sg, int act) {
  if (act == 1) return fmaxf(sg, 0.0f) + logf(1.0f + expf(-fabsf(sg)));
  if (act == 2) return expf(sg);
  return fmaxf(sg, 0.0f);
}

// A lane's K consecutive samples: raw (rgb_raw, sigma_raw) and z.
template <int K>
struct Samples {
  float4 q[K];
  float z[K];
};

template <typename V>
__device__ __forceinline__ V load(const V* p) {
  if constexpr (STREAM_LOADS) return __ldcs(p);
  else return __ldg(p);
}

// Issue the loads of samples first .. first + K - 1 of the ray at row (zeros past S).
template <int K>
__device__ __forceinline__ void load_samples(Samples<K>& s, const float4* __restrict__ raw,
                                             const float* __restrict__ z, long long row,
                                             int first, int S) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool valid = first + j < S;
    s.q[j] = valid ? load(raw + row + first + j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s.z[j] = valid ? load(z + row + first + j) : 0.0f;
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Ray n's maps and weights, by its warp; lane l owns samples c0 + l K ..
// c0 + l K + K - 1 of each chunk of 32 K samples. CHUNKED: more than one
// chunk, the next one's loads issued before this one's math; otherwise the
// one chunk is the whole ray. Returns the lane's count of samples past ERT's
// cut when COUNT (else 0).
template <int K, bool CHUNKED, bool COUNT>
__device__ __forceinline__ unsigned composite_ray(
    const float4* __restrict__ raw, const float* __restrict__ z,
    const float* __restrict__ rays_d, float* __restrict__ rgb_map, float* __restrict__ depth,
    float* __restrict__ acc, float* __restrict__ weights, long long n, int lane, int S,
    float ert, int act) {
  constexpr int CH = 32 * K;
  const long long row = n * S;
  unsigned cut = 0;

  Samples<K> cur, nxt;
  load_samples<K>(cur, raw, z, row, lane * K, S);
  const float dx = rays_d[n * 3], dy = rays_d[n * 3 + 1], dz = rays_d[n * 3 + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);

  float carry = 0.0f;  // log transmittance arriving at this chunk
  float r = 0.0f, g = 0.0f, b = 0.0f, dep = 0.0f, ac = 0.0f;
  bool done = false;  // warp-uniform: T fell below ert before this chunk
  for (int c0 = 0; c0 < S; c0 += CH) {
    const int first = c0 + lane * K;
    const bool more = CHUNKED && c0 + CH < S;
    if (CHUNKED && more && !done) load_samples<K>(nxt, raw, z, row, first + CH, S);
    float w[K];
    if (done) {  // T < ert from here on: every weight is 0
#pragma unroll
      for (int j = 0; j < K; ++j) {
        w[j] = 0.0f;
        if (COUNT && first + j < S) ++cut;
      }
    } else {
      // z after the lane's last sample: the next lane's first, or for lane
      // 31 the next chunk's first (unused past the ray's end)
      float z_after = __shfl_down_sync(FULL, cur.z[0], 1);
      if (CHUNKED) {
        const float z_next = __shfl_sync(FULL, nxt.z[0], 0);
        if (lane == 31) z_after = z_next;
      }
      float alpha[K], l1ma[K];
      float lane_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int i = first + j;
        alpha[j] = l1ma[j] = 0.0f;
        if (i < S) {
          const float zn = j + 1 < K ? cur.z[j + 1] : z_after;
          const float dist = (i + 1 < S ? zn - cur.z[j] : 1e10f) * dnorm;
          const float sg = cur.q[j].w;
          const float dens = density(sg, act);
          const float lam = dens * dist;
          alpha[j] = 1.0f - expf(-lam);
          // log(1 - alpha + 1e-10) = logaddexp(-lam, log 1e-10), stably
          const float hi = fmaxf(-lam, LOG_EPS), lo = fminf(-lam, LOG_EPS);
          l1ma[j] = hi + logf(1.0f + expf(lo - hi));
        }
        lane_sum += l1ma[j];
      }
      float incl = lane_sum;  // warp inclusive scan of the lanes' sums
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += t;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = 0.0f;
      float log_t = carry + excl;  // log T at the lane's first sample
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float T = expf(log_t);
        w[j] = alpha[j] * T;
        if (ert > 0.0f && !(T >= ert)) {
          w[j] = 0.0f;
          if (COUNT && first + j < S) ++cut;
        }
        r += w[j] * sigmoid(cur.q[j].x);
        g += w[j] * sigmoid(cur.q[j].y);
        b += w[j] * sigmoid(cur.q[j].z);
        dep += w[j] * cur.z[j];
        ac += w[j];
        log_t += l1ma[j];
      }
      carry += __shfl_sync(FULL, incl, 31);
      // T only falls: below the threshold here, below it for the rest
      if (CHUNKED && ert > 0.0f && expf(carry) < ert) done = true;
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (first + j < S) weights[row + first + j] = w[j];
    if (CHUNKED) cur = nxt;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r += __shfl_xor_sync(FULL, r, off);
    g += __shfl_xor_sync(FULL, g, off);
    b += __shfl_xor_sync(FULL, b, off);
    dep += __shfl_xor_sync(FULL, dep, off);
    ac += __shfl_xor_sync(FULL, ac, off);
  }
  if (lane == 0) {
    rgb_map[n * 3] = r;
    rgb_map[n * 3 + 1] = g;
    rgb_map[n * 3 + 2] = b;
    depth[n] = dep;
    acc[n] = ac;
  }
  return cut;
}

template <int K, bool CHUNKED>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
integrate_kernel(const float4* __restrict__ raw, const float* __restrict__ z,
                 const float* __restrict__ rays_d, float* __restrict__ rgb_map,
                 float* __restrict__ depth, float* __restrict__ acc,
                 float* __restrict__ weights, int N, int S, float ert, int act) {
  const long long n = (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= N) return;  // whole warps leave together
  composite_ray<K, CHUNKED, false>(raw, z, rays_d, rgb_map, depth, acc, weights, n, lane, S,
                                   ert, act);
}

// integrate_kernel that also adds the block's samples past ERT's cut to
// *ert_cut: every warp reaches the block's barrier, those past N with none.
template <int K, bool CHUNKED>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
integrate_count_kernel(const float4* __restrict__ raw, const float* __restrict__ z,
                       const float* __restrict__ rays_d, float* __restrict__ rgb_map,
                       float* __restrict__ depth, float* __restrict__ acc,
                       float* __restrict__ weights, int N, int S, float ert, int act,
                       unsigned long long* __restrict__ ert_cut) {
  __shared__ unsigned warp_cut[WARPS_PER_BLOCK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  unsigned cut = 0;
  if (n < N)
    cut = composite_ray<K, CHUNKED, true>(raw, z, rays_d, rgb_map, depth, acc, weights, n,
                                          lane, S, ert, act);
  cut = __reduce_add_sync(FULL, cut);
  if (lane == 0) warp_cut[warp] = cut;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long block = 0;
#pragma unroll
    for (int w = 0; w < WARPS_PER_BLOCK; ++w) block += warp_cut[w];
    if (block) atomicAdd(ert_cut, block);
  }
}

template <int K, bool CHUNKED>
void launch(const void* raw, const void* z, const void* rays_d, void* rgb_map, void* depth,
            void* acc, void* weights, int N, int S, float ert, int act, void* ert_cut,
            cudaStream_t s) {
  const int blocks = (N + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (ert_cut)
    integrate_count_kernel<K, CHUNKED><<<blocks, WARPS_PER_BLOCK * 32, 0, s>>>(
        (const float4*)raw, (const float*)z, (const float*)rays_d, (float*)rgb_map,
        (float*)depth, (float*)acc, (float*)weights, N, S, ert, act,
        (unsigned long long*)ert_cut);
  else
    integrate_kernel<K, CHUNKED><<<blocks, WARPS_PER_BLOCK * 32, 0, s>>>(
        (const float4*)raw, (const float*)z, (const float*)rays_d, (float*)rgb_map,
        (float*)depth, (float*)acc, (float*)weights, N, S, ert, act);
}

}  // namespace

// raw: [N, S, 4] f32 (rgb_raw, sigma_raw), 16-byte aligned; z: [N, S];
// rays_d: [N, 3]; outputs rgb_map [N, 3] (before the background), depth [N],
// acc [N], weights [N, S]. ert <= 0 turns ERT off. ert_cut: null, or an
// int64 counter that the samples past ERT's cut are added to. Returns the
// CUDA error code.
extern "C" int launch_integrate(const void* raw, const void* z, const void* rays_d,
                                void* rgb_map, void* depth, void* acc, void* weights,
                                int N, int S, float ert, int act, void* ert_cut,
                                void* stream) {
  if (N <= 0 || S <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define NERF_INTEGRATE_ARGS \
  raw, z, rays_d, rgb_map, depth, acc, weights, N, S, ert, act, ert_cut, s
  const int k = UP_FRONT ? (S + 31) / 32 : MAX_K + 1;
  switch (k) {
    case 1: launch<1, false>(NERF_INTEGRATE_ARGS); break;
    case 2: launch<2, false>(NERF_INTEGRATE_ARGS); break;
    case 3: launch<3, false>(NERF_INTEGRATE_ARGS); break;
    case 4: launch<4, false>(NERF_INTEGRATE_ARGS); break;
    case 5: launch<5, false>(NERF_INTEGRATE_ARGS); break;
    case 6: launch<6, false>(NERF_INTEGRATE_ARGS); break;
    case 7: launch<7, false>(NERF_INTEGRATE_ARGS); break;
    case 8: launch<8, false>(NERF_INTEGRATE_ARGS); break;
    default: launch<CHUNK_K, true>(NERF_INTEGRATE_ARGS);
  }
#undef NERF_INTEGRATE_ARGS
  return (int)cudaGetLastError();
}
