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
// The gather. The TPU kernel pipelines one DMA per row eight deep, because a
// TPU core has no random per-lane load. Here every thread moves the widest
// aligned vector that divides a row, up to 16 bytes (a 32-byte row is two
// 16-byte vectors, a 4-byte row one 32-bit word), so a warp covers whole
// rows, neighbouring threads write neighbouring addresses, the table is read
// through the read-only path, and the many warps in flight on 132 SMs hide
// the latency the TPU hid with its DMA queue.
//
// The scatter-add accumulates in a float32 buffer (no bf16 sums, so
// duplicates as heavy as the coarse levels' 4,096 cells lose nothing to
// rounding) and then rounds the buffer once to the table's dtype, in three
// launches: a memset of the buffer, the accumulation, the rounding. In the
// accumulation each row's index is read once, and four neighbouring lanes
// share a 16-wide row, so a warp's loads read whole rows and its reductions
// go out as whole 32-byte sectors. The hash encoder's indices are
// level-major and, within a level, consecutive rows are consecutive samples
// of one ray, so at the dense levels long runs of neighbouring rows hit one
// cell; a warp sums each run of equal indices among its 32 rows in float32
// registers (a segmented scan over head flags, with only as many shuffle
// steps as its longest run needs) and only the run's last row is sent, as
// red.global.add.v4.f32 (.v2 or scalar for widths 4 does not divide). The
// rounding pass reads 32 bytes and writes 16 a thread.
// The reductions' order changes from run to run, so the float32 sums may
// differ in their last bits between two runs on the same inputs.
// launch_scatter_add_rows_atomic keeps the previous design (one scalar
// atomicAdd per element, a 2-byte rounding pass) for comparison.
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

// The previous design: one thread per cotangent element,
// acc[idx[i], j] += cot[i, j] in float32.
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

constexpr unsigned FULL = 0xffffffffu;
// Switched by nerf_tpu_torch/tools/scatter_variants.py: sum runs of equal
// indices in a warp before any atomics; vector reductions, not scalar
// atomics; lanes that share a row.
constexpr bool AGGREGATE = true;
constexpr bool VECTOR_RED = true;
constexpr int MAX_LANES_PER_ROW = 4;  // 1: a lane sends every chunk of its own row

template <int B> struct VecOf;  // an aligned vector of B bytes
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = uint32_t; };
template <> struct VecOf<2> { using type = uint16_t; };

// CW elements of type T at p (aligned to CW * sizeof(T) bytes, at most 16)
// as floats, read once (streaming); zeros where !valid.
template <typename T, int CW>
__device__ __forceinline__ void load_chunk(const T* p, bool valid, float (&v)[CW]) {
  constexpr int BYTES = CW * (int)sizeof(T), VB = BYTES < 16 ? BYTES : 16;
  using V = typename VecOf<VB>::type;
  using Raw = typename VecOf<(int)sizeof(T)>::type;
  union {
    V vec[BYTES / VB];
    Raw e[CW];
  } u;
#pragma unroll
  for (int k = 0; k < BYTES / VB; ++k)
    u.vec[k] = valid ? __ldcs(reinterpret_cast<const V*>(p) + k) : V{};
#pragma unroll
  for (int e = 0; e < CW; ++e)
    v[e] = sizeof(T) == 2 ? __uint_as_float((uint32_t)u.e[e] << 16) : __uint_as_float(u.e[e]);
}

__device__ __forceinline__ void red_v4(float* p, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}
__device__ __forceinline__ void red_v2(float* p, float a, float b) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" :: "l"(p), "f"(a), "f"(b) : "memory");
}

// acc[0:CW] += v, p aligned to CW * 4 bytes (at most 16).
template <int CW>
__device__ __forceinline__ void red_chunk(float* p, const float (&v)[CW]) {
  if constexpr (VECTOR_RED && CW % 4 == 0) {
#pragma unroll
    for (int e = 0; e < CW; e += 4) red_v4(p + e, v[e], v[e + 1], v[e + 2], v[e + 3]);
  } else if constexpr (VECTOR_RED && CW == 2) {
    red_v2(p, v[0], v[1]);
  } else {
#pragma unroll
    for (int e = 0; e < CW; ++e) atomicAdd(p + e, v[e]);
  }
}

// acc[idx[i]] += cot[i] for a [n, width] cotangent. A warp walks 32
// consecutive rows at a time, in P groups of G = 32 / P rows: in each group P
// neighbouring lanes share a row, each holding CW of its floats, so one load
// instruction reads G whole rows and one reduction instruction sends whole
// 32-byte sectors (a row chunk of P CW elements; wider rows loop over
// chunks). Rows of equal index that follow each other form runs: a
// segmented inclusive scan inside each group (shuffles of P lanes a row
// step, only as many steps as the warp's longest run needs) and a carry
// from the group before sum each run, and the lanes of its last row send
// the sum.
template <typename T, int CW, int P>
__global__ void __launch_bounds__(THREADS)
scatter_rows_kernel(const int* __restrict__ idx, const T* __restrict__ cot,
                    float* __restrict__ acc, long long n_rows, int n, int width) {
  constexpr int G = 32 / P;
  const int lane = threadIdx.x & 31, piece = lane % P, sub = lane / P;
  const long long stride = (long long)gridDim.x * THREADS;
  // the loop bound is the warp's first row, so a warp's lanes run it together
  for (long long w0 = (long long)blockIdx.x * THREADS + (threadIdx.x & ~31); w0 < n;
       w0 += stride) {
    const bool lane_valid = w0 + lane < n;
    const int r_lane = lane_valid ? __ldg(idx + w0 + lane) : -1;
    if (lane_valid && (r_lane < 0 || (long long)r_lane >= n_rows)) __trap();
    unsigned heads = FULL;  // bit k: row k of the 32 starts a run
    int longest = 1;
    if (AGGREGATE) {
      const int prev = __shfl_up_sync(FULL, r_lane, 1);
      heads = __ballot_sync(FULL, lane == 0 || r_lane != prev);
      const int start = 31 - __clz(heads & (FULL >> (31 - lane)));
      longest = (int)__reduce_max_sync(FULL, (unsigned)(lane - start + 1));
    }
    int r[P], start[P];  // this lane's row in each group, and where its run starts
    bool last[P];        // that row ends its run
#pragma unroll
    for (int g = 0; g < P; ++g) {
      const int rho = g * G + sub;
      r[g] = __shfl_sync(FULL, r_lane, rho);
      start[g] = 31 - __clz(heads & (FULL >> (31 - rho)));
      last[g] = rho == 31 || ((heads >> (rho + 1)) & 1u);
    }
    for (int c = piece * CW; c < width; c += P * CW) {
      float v[P][CW];
#pragma unroll
      for (int g = 0; g < P; ++g) {
        const long long i = w0 + g * G + sub;
        load_chunk<T, CW>(cot + i * width + c, i < n, v[g]);
      }
      float carry[CW];  // the run sum at the last row of the group before
#pragma unroll
      for (int g = 0; g < P; ++g) {
        const int rho = g * G + sub;
        for (int off = 1; off < G && off < longest; off <<= 1) {  // warp-uniform
#pragma unroll
          for (int e = 0; e < CW; ++e) {
            const float t = __shfl_up_sync(FULL, v[g][e], off * P);
            if (sub >= off && rho - off >= start[g]) v[g][e] += t;
          }
        }
        if (g > 0 && start[g] < g * G) {  // the run began in an earlier group
#pragma unroll
          for (int e = 0; e < CW; ++e) v[g][e] += carry[e];
        }
        if (g + 1 < P) {
#pragma unroll
          for (int e = 0; e < CW; ++e) carry[e] = __shfl_sync(FULL, v[g][e], 32 - P + piece);
        }
      }
#pragma unroll
      for (int g = 0; g < P; ++g)
        if (last[g] && r[g] >= 0) red_chunk<CW>(acc + (long long)r[g] * width + c, v[g]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;  // hi to the upper half, lo to the lower, round to nearest even
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// out = bf16(acc) over n elements: 8 a thread (32 bytes in, 16 out), the
// last n % 8 one a thread.
__global__ void __launch_bounds__(THREADS)
round_bf16_vec_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
                      long long n) {
  const long long n8 = n / 8, stride = (long long)gridDim.x * THREADS;
  const long long t0 = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (long long t = t0; t < n8; t += stride) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(acc) + 2 * t);
    const float4 b = __ldcs(reinterpret_cast<const float4*>(acc) + 2 * t + 1);
    reinterpret_cast<uint4*>(out)[t] = make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w),
                                                  pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w));
  }
  if (t0 < n - n8 * 8) out[n8 * 8 + t0] = __float2bfloat16_rn(acc[n8 * 8 + t0]);
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

template <typename T, int CW, int P>
void launch_scatter(const int* idx, const void* cot, float* acc, long long n_rows, int n,
                    int width, cudaStream_t s) {
  scatter_rows_kernel<T, CW, P><<<blocks_for(((long long)n + 31) / 32 * 32), THREADS, 0, s>>>(
      idx, static_cast<const T*>(cot), acc, n_rows, n, width);
}

// The widest layout that divides the width and whose loads the cotangent's
// address is aligned to: CW floats a lane (4, 2 or 1), P lanes a row chunk.
template <typename T>
void launch_scatter_layout(const int* idx, const void* cot, float* acc, long long n_rows, int n,
                           int width, cudaStream_t s) {
  const auto fits = [&](int cw, int p) {
    const int b = cw * (int)sizeof(T) < 16 ? cw * (int)sizeof(T) : 16;
    return p <= MAX_LANES_PER_ROW && width % (cw * p) == 0 &&
           reinterpret_cast<uintptr_t>(cot) % b == 0;
  };
  if (fits(4, 4)) launch_scatter<T, 4, 4>(idx, cot, acc, n_rows, n, width, s);
  else if (fits(4, 2)) launch_scatter<T, 4, 2>(idx, cot, acc, n_rows, n, width, s);
  else if (fits(4, 1)) launch_scatter<T, 4, 1>(idx, cot, acc, n_rows, n, width, s);
  else if (fits(2, 1)) launch_scatter<T, 2, 1>(idx, cot, acc, n_rows, n, width, s);
  else launch_scatter<T, 1, 1>(idx, cot, acc, n_rows, n, width, s);
}

// The scatter-add's three launches: 0 zeroes acc, 1 accumulates, 2 rounds.
int scatter_part(int part, const int* idx, const void* cot, float* acc, void* out,
                 long long n_rows, int n, int width, int bf16, cudaStream_t s) {
  const long long n_acc = n_rows * width;
  if (part == 0) return (int)cudaMemsetAsync(acc, 0, (size_t)n_acc * sizeof(float), s);
  if (part == 1 && n > 0) {
    if (bf16) launch_scatter_layout<__nv_bfloat16>(idx, cot, acc, n_rows, n, width, s);
    else launch_scatter_layout<float>(idx, cot, acc, n_rows, n, width, s);
  }
  if (part == 2 && bf16 && n_acc > 0)
    round_bf16_vec_kernel<<<blocks_for((n_acc + 7) / 8), THREADS, 0, s>>>(
        acc, static_cast<__nv_bfloat16*>(out), n_acc);
  return (int)cudaGetLastError();
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
// scratch [n_rows, width] (16-byte aligned), zeroed here; out: the result in
// the table's dtype (bf16 = 1; 16-byte aligned) or, for float32 (bf16 = 0),
// acc itself. cot has the same dtype.
extern "C" int launch_scatter_add_rows(const int* idx, const void* cot, float* acc, void* out,
                                       long long n_rows, int n, int width, int bf16,
                                       void* stream) {
  if (n < 0 || width <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = scatter_part(0, idx, cot, acc, out, n_rows, n, width, bf16, s);
  if (!err) err = scatter_part(1, idx, cot, acc, out, n_rows, n, width, bf16, s);
  if (!err) err = scatter_part(2, idx, cot, acc, out, n_rows, n, width, bf16, s);
  return err;
}

// One of launch_scatter_add_rows's three launches alone (part 0 the memset,
// 1 the accumulation, 2 the rounding), to time them apart.
extern "C" int launch_scatter_add_rows_part(const int* idx, const void* cot, float* acc,
                                            void* out, long long n_rows, int n, int width,
                                            int bf16, int part, void* stream) {
  if (n < 0 || width <= 0 || part < 0 || part > 2) return (int)cudaErrorInvalidValue;
  return scatter_part(part, idx, cot, acc, out, n_rows, n, width, bf16,
                      static_cast<cudaStream_t>(stream));
}

// The previous scatter-add, for comparison: the same arguments and result.
extern "C" int launch_scatter_add_rows_atomic(const int* idx, const void* cot, float* acc,
                                              void* out, long long n_rows, int n, int width,
                                              int bf16, void* stream) {
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
