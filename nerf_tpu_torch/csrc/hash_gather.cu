// Hash-table row gather and its scatter-add backward for Hopper.
//
// Replaces the Pallas TPU kernel nerf_tpu/ops/hash_gather.py:45
// (_gather_kernel, reached through gather_rows_pallas): out[i] = table[idx[i]]
// for a [R, W] table of bf16 or float32 rows. The backward, grad[idx[i]] +=
// cot[i], replaces what the JAX package leaves to XLA's scatter-add (the
// slotpack VJP, nerf_tpu/models/hashgrid.py:214). Plain PyTorch versions:
// nerf_tpu_torch/ops/hash_gather.py::gather_rows_plain, scatter_add_rows_plain.
//
// What bounds them on an H100: bytes. The gather moves one row in and one out
// per index (32 B each for the cellpack layout's 16 bf16 features, 4 B for
// the corner layout's 2) and computes nothing; the scatter-add reads one row
// of cotangents per index and adds it into the table's gradient. Rows are
// read at random, so each one costs a whole 32-byte sector; the hash-grid
// table (33.5 MB) fits the 50 MB L2, so repeated rows mostly hit there.
//
// What the design does about it. The TPU kernel pipelines one DMA per row
// eight deep, because a TPU core has no random per-lane load. Here every
// thread moves the widest aligned vector that divides a row, up to 16 bytes
// (a 32-byte row is two 16-byte vectors, a 4-byte row one 32-bit word), so a
// warp covers whole rows, neighbouring threads write neighbouring addresses, the table
// is read through the read-only path, and the many warps in flight on 132 SMs
// hide the latency the TPU hid with its DMA queue. Each thread reads its
// row's index once. The scatter-add accumulates in a float32 buffer with
// atomicAdd (one 32-bit atomic per element: no bf16 sums, so duplicates as
// heavy as the coarse levels' 4,096 cells lose nothing to rounding) and then
// rounds the buffer once to the table's dtype. The atomics' order changes
// from run to run, so the float32 sums may differ in their last bits between
// two runs on the same inputs.
//
// An index outside [0, R) traps (the launch then reports an error at the
// next synchronisation) rather than reading or writing outside the table.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers; bound with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// Vec: the vector type one thread moves (uint4 = 16 B ... uint16_t = 2 B).
template <typename Vec>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const Vec* __restrict__ table, const int* __restrict__ idx,
              Vec* __restrict__ out, long long n_rows, long long n_vecs, int vecs_per_row) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < n_vecs; t += stride) {
    const long long i = t / vecs_per_row;
    const int c = (int)(t - i * vecs_per_row);
    const int r = __ldg(idx + i);
    if (r < 0 || (long long)r >= n_rows) __trap();
    out[t] = __ldg(table + (long long)r * vecs_per_row + c);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One thread per cotangent element: acc[idx[i], j] += cot[i, j] in float32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
scatter_add_kernel(const int* __restrict__ idx, const T* __restrict__ cot,
                   float* __restrict__ acc, long long n_rows, long long n_elems, int width) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < n_elems; t += stride) {
    const long long i = t / width;
    const int j = (int)(t - i * width);
    const int r = __ldg(idx + i);
    if (r < 0 || (long long)r >= n_rows) __trap();
    atomicAdd(acc + (long long)r * width + j, to_float(cot[t]));
  }
}

__global__ void __launch_bounds__(THREADS)
round_to_bf16_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
                     long long n) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < n; t += stride)
    out[t] = __float2bfloat16_rn(acc[t]);
}

int blocks_for(long long work) {
  // enough blocks to fill the card many times over; the loops stride the rest
  long long b = (work + THREADS - 1) / THREADS;
  return (int)(b < 132LL * 64 ? (b > 0 ? b : 1) : 132LL * 64);
}

template <typename Vec>
void launch_gather(const void* table, const int* idx, void* out, long long n_rows, int n,
                   int row_bytes, cudaStream_t stream) {
  const int vpr = row_bytes / (int)sizeof(Vec);
  const long long n_vecs = (long long)n * vpr;
  gather_kernel<Vec><<<blocks_for(n_vecs), THREADS, 0, stream>>>(
      static_cast<const Vec*>(table), idx, static_cast<Vec*>(out), n_rows, n_vecs, vpr);
}

}  // namespace

// table [n_rows, row_bytes] (any dtype), idx [n] int32 -> out [n, row_bytes].
// row_bytes must be a multiple of 2; table and out aligned to 16 bytes.
// Returns the CUDA error of the launch (0 on success), or cudaErrorInvalidValue.
extern "C" int launch_gather_rows(const void* table, const int* idx, void* out,
                                  long long n_rows, int n, int row_bytes, void* stream) {
  if (n < 0 || row_bytes <= 0 || row_bytes % 2) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0)
    launch_gather<uint4>(table, idx, out, n_rows, n, row_bytes, s);
  else if (row_bytes % 8 == 0)
    launch_gather<uint2>(table, idx, out, n_rows, n, row_bytes, s);
  else if (row_bytes % 4 == 0)
    launch_gather<uint32_t>(table, idx, out, n_rows, n, row_bytes, s);
  else
    launch_gather<uint16_t>(table, idx, out, n_rows, n, row_bytes, s);
  return (int)cudaGetLastError();
}

// grad [n_rows, width] = sum over i of cot[i] at row idx[i]. acc: float32
// scratch [n_rows, width], zeroed here; out: the result in the table's dtype
// (bf16 = 1) or, for float32 (bf16 = 0), acc itself. cot has the same dtype.
extern "C" int launch_scatter_add_rows(const int* idx, const void* cot, float* acc, void* out,
                                       long long n_rows, int n, int width, int bf16,
                                       void* stream) {
  if (n < 0 || width <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_acc = n_rows * width;
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)n_acc * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const long long n_elems = (long long)n * width;
  if (n_elems > 0) {
    if (bf16)
      scatter_add_kernel<__nv_bfloat16><<<blocks_for(n_elems), THREADS, 0, s>>>(
          idx, static_cast<const __nv_bfloat16*>(cot), acc, n_rows, n_elems, width);
    else
      scatter_add_kernel<float><<<blocks_for(n_elems), THREADS, 0, s>>>(
          idx, static_cast<const float*>(cot), acc, n_rows, n_elems, width);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (bf16)
    round_to_bf16_kernel<<<blocks_for(n_acc), THREADS, 0, s>>>(
        acc, static_cast<__nv_bfloat16*>(out), n_acc);
  return (int)cudaGetLastError();
}
