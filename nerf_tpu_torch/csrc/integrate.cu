// Volume compositing (alpha integration with early ray termination) for Hopper.
//
// Replaces the Pallas TPU kernel nerf_tpu/ops/integrate.py:24 (_integrate_kernel).
// Plain PyTorch version: nerf_tpu_torch/ops/integrate.py::integrate_plain.
//
// What it computes, per ray of S samples: dists = (z[i+1] - z[i], tail 1e10)
// * |d|; density relu or softplus; lam = dens * dist; alpha = 1 - exp(-lam);
// exclusive log-transmittance sum_{j<i} log(exp(-lam_j) + 1e-10), each term
// formed as a stable logaddexp; T = exp(.); w = alpha * T, zeroed where
// T < ert (ERT, when ert > 0); rgb = sum w * sigmoid(rgb_raw), depth =
// sum w * z, acc = sum w, and the weights themselves.
//
// What bounds it on an H100: bytes. 20 bytes read (raw rgb+sigma, z) and
// 4 written (weight) per sample against ~40 flops, far below the 295
// flop/byte ridge, so 3.35 TB/s of device memory sets the floor.
//
// What the design does about it: one warp per ray. The 32 lanes take 32
// consecutive samples at a time, so raw (16 B, one float4 per sample), z and
// the weights move as coalesced 512/128-byte lines, and the running
// log-transmittance is a warp inclusive scan (5 shuffles) plus a carry in
// place of the TPU's triangular-matmul cumsum. Transmittance only falls, so
// ERT is an early exit: once T at the next chunk is below the threshold,
// the rest of the ray's weights are written as 0 without reading its samples.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers; bound with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG_EPS = -23.025850929940457f;  // log(1e-10)

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
integrate_kernel(const float4* __restrict__ raw, const float* __restrict__ z,
                 const float* __restrict__ rays_d, float* __restrict__ rgb_map,
                 float* __restrict__ depth, float* __restrict__ acc,
                 float* __restrict__ weights, int N, int S, float ert, int softplus) {
  const long long n = (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= N) return;  // whole warps leave together

  const float dx = rays_d[n * 3], dy = rays_d[n * 3 + 1], dz = rays_d[n * 3 + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const long long row = n * S;

  float carry = 0.0f;  // log transmittance arriving at this chunk
  float r = 0.0f, g = 0.0f, b = 0.0f, dep = 0.0f, ac = 0.0f;
  bool done = false;  // warp-uniform
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int i = s0 + lane;
    const bool valid = i < S;
    float w = 0.0f;
    if (!done) {
      float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float zi = 0.0f, alpha = 0.0f, l1ma = 0.0f;
      if (valid) {
        q = raw[row + i];
        zi = z[row + i];
        const float dist = (i + 1 < S ? z[row + i + 1] - zi : 1e10f) * dnorm;
        const float dens = softplus
            ? fmaxf(q.w, 0.0f) + logf(1.0f + expf(-fabsf(q.w)))
            : fmaxf(q.w, 0.0f);
        const float lam = dens * dist;
        alpha = 1.0f - expf(-lam);
        // log(1 - alpha + 1e-10) = logaddexp(-lam, log 1e-10), stably
        const float hi = fmaxf(-lam, LOG_EPS), lo = fminf(-lam, LOG_EPS);
        l1ma = hi + logf(1.0f + expf(lo - hi));
      }
      float incl = l1ma;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += t;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = 0.0f;
      const float T = expf(carry + excl);
      if (valid) {
        w = alpha * T;
        if (ert > 0.0f && !(T >= ert)) w = 0.0f;
        r += w / (1.0f + expf(-q.x));
        g += w / (1.0f + expf(-q.y));
        b += w / (1.0f + expf(-q.z));
        dep += w * zi;
        ac += w;
      }
      carry += __shfl_sync(FULL, incl, 31);
      // T only falls: below the threshold here, below it for the rest
      if (ert > 0.0f && expf(carry) < ert) done = true;
    }
    if (valid) weights[row + i] = w;
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
}

}  // namespace

// raw: [N, S, 4] f32 (rgb_raw, sigma_raw), 16-byte aligned; z: [N, S];
// rays_d: [N, 3]; outputs rgb_map [N, 3] (before the background), depth [N],
// acc [N], weights [N, S]. ert <= 0 turns ERT off. Returns the CUDA error code.
extern "C" int launch_integrate(const void* raw, const void* z, const void* rays_d,
                                void* rgb_map, void* depth, void* acc, void* weights,
                                int N, int S, float ert, int softplus, void* stream) {
  if (N <= 0 || S <= 0) return 0;
  const int blocks = (N + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  integrate_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
      (const float4*)raw, (const float*)z, (const float*)rays_d, (float*)rgb_map,
      (float*)depth, (float*)acc, (float*)weights, N, S, ert, softplus);
  return (int)cudaGetLastError();
}
