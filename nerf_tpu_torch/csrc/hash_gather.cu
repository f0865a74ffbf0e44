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
// TPU core has no random per-lane load. Here the limit is bytes in flight: by
// Little's law 3.35 TB/s over 132 SMs at ~0.7 us of DRAM latency needs ~18 KB
// in flight per SM, and one 4-byte row a thread keeps ~8 KB there (such a
// kernel read under half of its bound on the corner layout's 4-byte rows:
// PERF.md). So a thread moves several rows (ROWS of 2-8 bytes; WIDE_VECS
// 16-byte vectors of wider rows), in three steps: all its indices (16-byte
// vectors where the rows are narrow and idx is aligned to them), then all its
// table loads, then all its stores as vectors (up to 16 bytes). A block takes
// one tile of THREADS x (vectors a thread) output vectors, item k of thread t
// at vector k THREADS + t, so neighbouring threads read neighbouring indices
// and write neighbouring addresses; no grid-stride loop and no 64-bit division
// on the paths' rows (2-32 bytes). Cache policy per access: indices and output
// are touched once and stream past the caches (ld/st.global.cs); table rows
// are read with an L2 evict_last policy, so the table (33.5 MB, in the 50 MB
// L2) stays there across the ~200 MB of indices and output that stream through
// L2 a launch, and from one launch to the next. The hints are per instruction:
// no stream or device attribute is set. What bounds it then: on rows of 4
// bytes every row is a table sector request (32 bytes) unless a neighbouring
// lane's row shares its sector, and those requests, not DRAM, are the limit
// (PERF.md, measured with nerf_tpu_torch/tools/gather_variants.py, which times
// the switches below).
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
//
// An index outside [0, R) traps (the launch then reports an error at the
// next synchronisation) rather than reading or writing outside the table.
//
// The hash encoder's arithmetic around them (models/hashgrid.py's corner
// layout at input dimension 3; plain PyTorch versions: nerf_tpu_torch/ops/
// hash_encode.py). The JAX package leaves it to XLA, which fuses it into the
// gather's neighbours; in eager PyTorch (models/hashgrid.py encode_torch) it is
// ~40 elementwise launches a forward whose int64 temporaries write ~10 GB at
// 2^18 points and 16 levels. Three kernels do it, one thread a (point, level),
// the level fastest, so that a warp reads and writes whole rows of the
// point-major features; each thread's 32-64 bytes of indices or table rows go
// as 16-byte pieces at level-strided addresses, half a sector an instruction,
// which holds hash_index and hash_interp_bwd near 40% of their bounds (PERF.md):
// - hash_index_kernel: a point's cell at a level (the float32 steps of
//   hashgrid_index as PyTorch runs them on the card: the box's corner
//   subtracted, a product with the float reciprocal of its size, which is how
//   PyTorch divides a tensor by a Python scalar there, the clamp to
//   [0, 1 - 1e-6] as a float, the product with the resolution, floor) and its
//   8 corner rows in product order, the level's base added: direct
//   (sum c_d (res + 1)^d) on dense levels, the XOR of c_d prime_d in wrapping
//   uint32 on hashed ones, mod T; 32 bytes out a thread. No int64 anywhere.
// - hash_interp_kernel: the 8 rows B4 gathered (one 16-byte vector load or
//   more), the corner weights (w0 w1) w2 of the recomputed fractions (1 - f
//   for a 0 corner), the 8 products summed in float32 as the tree
//   ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)), written point-major
//   [N, L F]: the layout the MLP reads, so no permute's copy follows.
// - hash_interp_bwd_kernel: g w for each corner, rounded once to the table's
//   dtype (the cast the PyTorch path's .float() takes on the way back), as
//   16-byte vectors, the rows B4' scatter-adds.
// Each recomputes the fractions from the points (12 bytes a point) rather
// than storing them (12 bytes a point and level). They are bound by bytes:
// at 2^18 points, 16 levels and 8-byte rows, 137 MB, 305 MB and 305 MB.
// Every product and sum is an explicit round-to-nearest intrinsic, so nvcc
// contracts none into a fused multiply-add: the indices and the cotangent
// rows equal the PyTorch path's bit for bit on the card.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers; bound with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// Switched by nerf_tpu_torch/tools/gather_variants.py, which also measured
// them (PERF.md): 4 rows and 2 vectors a thread were the fastest of 1-8.
constexpr int ROWS = 4;       // rows a thread, for rows of 2, 4 and 8 bytes
constexpr int WIDE_VECS = 2;  // 16-byte vectors a thread, for rows of 16 bytes and more
// indices: 0 through the read-only path, 1 ld.global.cs (streaming),
// 2 ld.global.nc.L1::no_allocate
constexpr int INDEX_HINT = 1;
constexpr bool STREAM_OUTPUT = true;     // st.global.cs
constexpr bool TABLE_EVICT_LAST = true;  // table rows with an L2 evict_last policy

template <int B> struct VecOf;  // an aligned vector of B bytes
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = uint32_t; };
template <> struct VecOf<2> { using type = uint16_t; };

__device__ __forceinline__ int ld_no_allocate(const int* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int2 ld_no_allocate(const int2* p) {
  int2 v;
  asm("ld.global.nc.L1::no_allocate.v2.s32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ int4 ld_no_allocate(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// Indices (int, int2 or int4), read once.
template <typename T>
__device__ __forceinline__ T load_once(const T* p) {
  if constexpr (INDEX_HINT == 1) return __ldcs(p);
  else if constexpr (INDEX_HINT == 2) return ld_no_allocate(p);
  else return __ldg(p);
}
template <typename T>
__device__ __forceinline__ void store_once(T* p, T v) {
  if constexpr (STREAM_OUTPUT) __stcs(p, v);
  else *p = v;
}

__device__ __forceinline__ uint64_t table_policy() {
  uint64_t pol = 0;
  if constexpr (TABLE_EVICT_LAST)
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// A table row (or a 16-byte part of one), read-only, kept in L2 by pol.
__device__ __forceinline__ uint4 load_table(const uint4* p, uint64_t pol) {
  if constexpr (!TABLE_EVICT_LAST) return __ldg(p);
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ uint2 load_table(const uint2* p, uint64_t pol) {
  if constexpr (!TABLE_EVICT_LAST) return __ldg(p);
  uint2 v;
  asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
      : "=r"(v.x), "=r"(v.y) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ uint32_t load_table(const uint32_t* p, uint64_t pol) {
  if constexpr (!TABLE_EVICT_LAST) return __ldg(p);
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ uint16_t load_table(const uint16_t* p, uint64_t pol) {
  if constexpr (!TABLE_EVICT_LAST) return __ldg(p);
  uint16_t v;
  asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void check_row(int r, long long n_rows) {
  if (r < 0 || (long long)r >= n_rows) __trap();
}

// N indices at p: 16-byte (or 8-byte) vectors if VEC (p aligned to them).
template <int N, bool VEC>
__device__ __forceinline__ void load_indices(const int* p, int (&r)[N]) {
  if constexpr (VEC && N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const int4 t = load_once(reinterpret_cast<const int4*>(p) + q);
      r[4 * q] = t.x, r[4 * q + 1] = t.y, r[4 * q + 2] = t.z, r[4 * q + 3] = t.w;
    }
  } else if constexpr (VEC && N == 2) {
    const int2 t = load_once(reinterpret_cast<const int2*>(p));
    r[0] = t.x, r[1] = t.y;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) r[e] = load_once(p + e);
  }
}

// Narrow rows (RB = 2, 4 or 8 bytes): each output vector is RPV whole rows
// (RB x RPV <= 16 bytes), U vectors a thread (RPV x U = ROWS rows). The
// last n % RPV rows, if any, are one short vector, copied row by row.
template <int RB, int RPV, int U, bool IDX_VEC>
__global__ void __launch_bounds__(THREADS)
gather_narrow_kernel(const typename VecOf<RB>::type* __restrict__ table,
                     const int* __restrict__ idx, void* __restrict__ out_v, long long n_rows,
                     long long n) {
  using Row = typename VecOf<RB>::type;
  using Vec = typename VecOf<RB * RPV>::type;
  union Pack {
    Vec vec;
    Row row[RPV];
  };
  Vec* out = static_cast<Vec*>(out_v);
  const long long n_full = n / RPV;
  const long long v0 = (long long)blockIdx.x * (THREADS * U) + threadIdx.x;
  int r[U][RPV];
#pragma unroll
  for (int k = 0; k < U; ++k)
    if (v0 + k * THREADS < n_full) load_indices<RPV, IDX_VEC>(idx + (v0 + k * THREADS) * RPV, r[k]);
  bool bad = false;  // one branch for all checks, so every table load can be in flight at once
#pragma unroll
  for (int k = 0; k < U; ++k)
    if (v0 + k * THREADS < n_full) {
#pragma unroll
      for (int e = 0; e < RPV; ++e) bad |= r[k][e] < 0 || (long long)r[k][e] >= n_rows;
    }
  if (bad) __trap();
  const uint64_t pol = table_policy();
  Pack got[U];
#pragma unroll
  for (int k = 0; k < U; ++k)
    if (v0 + k * THREADS < n_full) {
#pragma unroll
      for (int e = 0; e < RPV; ++e) got[k].row[e] = load_table(table + r[k][e], pol);
    }
#pragma unroll
  for (int k = 0; k < U; ++k)
    if (v0 + k * THREADS < n_full) store_once(out + v0 + k * THREADS, got[k].vec);
  if constexpr (RPV > 1) {
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (v0 + k * THREADS == n_full) {
        Row* out_rows = static_cast<Row*>(out_v);
        for (long long i = n_full * RPV; i < n; ++i) {
          const int ri = load_once(idx + i);
          check_row(ri, n_rows);
          store_once(out_rows + i, load_table(table + ri, pol));
        }
      }
  }
}

// Other rows: VPR vectors of type V each (VPR = 0: vpr at run time), U
// vectors a thread. The block's first vector is divided by the row width
// once; each item's row follows by a 32-bit division (shifts for VPR 1, 2).
template <typename V, int VPR, int U>
__global__ void __launch_bounds__(THREADS)
gather_wide_kernel(const V* __restrict__ table, const int* __restrict__ idx, V* __restrict__ out,
                   long long n_rows, long long n_vecs, int vpr_rt) {
  const unsigned vpr = VPR ? VPR : vpr_rt;
  const long long b0 = (long long)blockIdx.x * (THREADS * U);
  const long long row0 = b0 / vpr;
  const unsigned c0 = (unsigned)(b0 - row0 * vpr);
  int r[U];
  unsigned c[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const unsigned local = c0 + k * THREADS + threadIdx.x, dr = local / vpr;
    c[k] = local - dr * vpr;
    if (b0 + k * THREADS + threadIdx.x < n_vecs) r[k] = load_once(idx + row0 + dr);
  }
  bool bad = false;
#pragma unroll
  for (int k = 0; k < U; ++k)
    if (b0 + k * THREADS + threadIdx.x < n_vecs) bad |= r[k] < 0 || (long long)r[k] >= n_rows;
  if (bad) __trap();
  const uint64_t pol = table_policy();
  V got[U];
#pragma unroll
  for (int k = 0; k < U; ++k)
    if (b0 + k * THREADS + threadIdx.x < n_vecs)
      got[k] = load_table(table + (long long)r[k] * vpr + c[k], pol);
#pragma unroll
  for (int k = 0; k < U; ++k)
    if (b0 + k * THREADS + threadIdx.x < n_vecs)
      store_once(out + b0 + k * THREADS + threadIdx.x, got[k]);
}

constexpr unsigned FULL = 0xffffffffu;
// Switched by nerf_tpu_torch/tools/scatter_variants.py: sum runs of equal
// indices in a warp before any atomics; vector reductions, not scalar
// atomics; lanes that share a row.
constexpr bool AGGREGATE = true;
constexpr bool VECTOR_RED = true;
constexpr int MAX_LANES_PER_ROW = 4;  // 1: a lane sends every chunk of its own row


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

constexpr long long MAX_BLOCKS = 0x7fffffffLL;

// Rows of RB = 2, 4 or 8 bytes: ROWS a thread, as vectors of up to 16 bytes;
// the indices as vectors too where idx is aligned to them.
template <int RB>
int launch_narrow(const void* table, const int* idx, void* out, long long n_rows, int n,
                  cudaStream_t s) {
  constexpr int VB = RB * ROWS < 16 ? RB * ROWS : 16, RPV = VB / RB, U = ROWS / RPV;
  constexpr int IDX_ALIGN = 4 * RPV < 16 ? 4 * RPV : 16;
  const long long n_vecs = ((long long)n + RPV - 1) / RPV;
  const long long blocks = (n_vecs + THREADS * U - 1) / (THREADS * U);
  if (blocks > MAX_BLOCKS) return (int)cudaErrorInvalidValue;
  const auto* t = static_cast<const typename VecOf<RB>::type*>(table);
  if (reinterpret_cast<uintptr_t>(idx) % IDX_ALIGN == 0)
    gather_narrow_kernel<RB, RPV, U, true><<<(unsigned)blocks, THREADS, 0, s>>>(t, idx, out,
                                                                                n_rows, n);
  else
    gather_narrow_kernel<RB, RPV, U, false><<<(unsigned)blocks, THREADS, 0, s>>>(t, idx, out,
                                                                                 n_rows, n);
  return 0;
}

// Any other row: vectors of V (the widest that divides the row), WIDE_VECS a
// thread; VPR of them a row (0: at run time).
template <typename V, int VPR>
int launch_wide(const void* table, const int* idx, void* out, long long n_rows, int n,
                int row_bytes, cudaStream_t s) {
  const int vpr = row_bytes / (int)sizeof(V);
  const long long n_vecs = (long long)n * vpr;
  const long long blocks = (n_vecs + THREADS * WIDE_VECS - 1) / (THREADS * WIDE_VECS);
  if (blocks > MAX_BLOCKS) return (int)cudaErrorInvalidValue;
  gather_wide_kernel<V, VPR, WIDE_VECS><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), n_rows, n_vecs, vpr);
  return 0;
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


// ---- the hash encoder's arithmetic (hash_index, hash_interp, hash_interp_bwd)

constexpr int MAX_LEVELS = 32;
constexpr unsigned PRIME1 = 2654435761u, PRIME2 = 805459861u;

struct Levels {
  int n_levels;
  unsigned dense;   // bit l: level l indexes its lattice directly
  unsigned n_rows;  // T, a level's rows
  float lo, inv, top;  // the box's corner, 1 / its size as a float, the clamp's top
  int res[MAX_LEVELS];
};

// Thread t's point and level: the level fastest. False past the last.
__device__ __forceinline__ bool point_level(const Levels& lv, int n, unsigned& i, unsigned& l) {
  const unsigned t = blockIdx.x * THREADS + threadIdx.x, L = (unsigned)lv.n_levels;
  if (t >= (unsigned)n * L) return false;
  i = t / L;
  l = t - i * L;
  return true;
}

// Point i's cell at level l (c) and its place in it (f), in hashgrid_index's
// float32 steps as PyTorch runs them on the card. A NaN coordinate stays NaN
// through the clamp, as PyTorch's does; its cell is then 0.
__device__ __forceinline__ void cell(const float* __restrict__ pts, unsigned i, unsigned l,
                                     const Levels& lv, unsigned (&c)[3], float (&f)[3]) {
  const float r = (float)lv.res[l];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float x = __fmul_rn(__fsub_rn(__ldg(pts + 3 * (size_t)i + d), lv.lo), lv.inv);
    if (!(x != x)) x = fminf(fmaxf(x, 0.0f), lv.top);
    const float xl = __fmul_rn(x, r), x0 = floorf(xl);
    f[d] = __fsub_rn(xl, x0);
    c[d] = (unsigned)(int)x0;
  }
}

// The 8 corner weights in product order: (a0 a1) a2, a_d = f_d where corner
// k's bit for d (4, 2, 1) is set, else 1 - f_d.
__device__ __forceinline__ void corner_weights(const float (&f)[3], float (&w)[8]) {
  const float g[3] = {__fsub_rn(1.0f, f[0]), __fsub_rn(1.0f, f[1]), __fsub_rn(1.0f, f[2])};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = __fmul_rn(__fmul_rn(k & 4 ? f[0] : g[0], k & 2 ? f[1] : g[1]), k & 1 ? f[2] : g[2]);
}

__global__ void __launch_bounds__(THREADS)
hash_index_kernel(const float* __restrict__ pts, int* __restrict__ idx, int n, Levels lv) {
  unsigned i, l;
  if (!point_level(lv, n, i, l)) return;
  unsigned c[3];
  float f[3];
  cell(pts, i, l, lv, c, f);
  const bool dense = (lv.dense >> l) & 1u;
  const unsigned T = lv.n_rows, stride = (unsigned)lv.res[l] + 1u, base = l * T;
  const bool pow2 = (T & (T - 1u)) == 0u;
  int r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned a = c[0] + ((k >> 2) & 1), b = c[1] + ((k >> 1) & 1), e = c[2] + (k & 1);
    const unsigned h = dense ? a + stride * (b + stride * e) : a ^ (b * PRIME1) ^ (e * PRIME2);
    r[k] = (int)(base + (pow2 ? h & (T - 1u) : h % T));
  }
  int4* out = reinterpret_cast<int4*>(idx) + ((size_t)l * n + i) * 2;
  __stcs(out, make_int4(r[0], r[1], r[2], r[3]));  // B4 reads them once, streaming
  __stcs(out + 1, make_int4(r[4], r[5], r[6], r[7]));
}

template <int EB>
__device__ __forceinline__ float raw_to_float(typename VecOf<EB>::type v) {
  if constexpr (EB == 2) return __uint_as_float((uint32_t)v << 16);
  else return __uint_as_float(v);
}

// Rows of F elements of EB bytes (2: bfloat16, 4: float32); 8 F EB is a
// multiple of 16 for every F the launchers take.
template <int EB, int F>
__global__ void __launch_bounds__(THREADS)
hash_interp_kernel(const void* __restrict__ rows, const float* __restrict__ pts,
                   float* __restrict__ out, int n, Levels lv) {
  constexpr int NV = 8 * F * EB / 16;
  unsigned i, l;
  if (!point_level(lv, n, i, l)) return;
  unsigned c[3];
  float f[3], w[8];
  cell(pts, i, l, lv, c, f);
  corner_weights(f, w);
  union {
    uint4 v[NV];
    typename VecOf<EB>::type e[8 * F];
  } u;
  const uint4* src = static_cast<const uint4*>(rows) + ((size_t)l * n + i) * NV;
#pragma unroll
  for (int q = 0; q < NV; ++q) u.v[q] = __ldcs(src + q);  // read once, streaming
  float* dst = out + ((size_t)i * lv.n_levels + l) * F;
#pragma unroll
  for (int j = 0; j < F; ++j) {
    float p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = __fmul_rn(raw_to_float<EB>(u.e[k * F + j]), w[k]);
    dst[j] = __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3])),
                       __fadd_rn(__fadd_rn(p[4], p[5]), __fadd_rn(p[6], p[7])));
  }
}

template <int EB, int F>
__global__ void __launch_bounds__(THREADS)
hash_interp_bwd_kernel(const float* __restrict__ g, const float* __restrict__ pts,
                       void* __restrict__ cot, int n, Levels lv) {
  constexpr int NV = 8 * F * EB / 16;
  unsigned i, l;
  if (!point_level(lv, n, i, l)) return;
  unsigned c[3];
  float f[3], w[8], gv[F];
  cell(pts, i, l, lv, c, f);
  corner_weights(f, w);
  const float* gi = g + ((size_t)i * lv.n_levels + l) * F;
#pragma unroll
  for (int j = 0; j < F; ++j) gv[j] = __ldcs(gi + j);
  union {
    uint4 v[NV];
    typename VecOf<EB>::type e[8 * F];
  } u;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int j = 0; j < F; ++j) {
      const float v = __fmul_rn(gv[j], w[k]);
      if constexpr (EB == 2) u.e[k * F + j] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      else u.e[k * F + j] = __float_as_uint(v);
    }
  uint4* dst = static_cast<uint4*>(cot) + ((size_t)l * n + i) * NV;
#pragma unroll
  for (int q = 0; q < NV; ++q) __stcs(dst + q, u.v[q]);  // B4' reads them once
}

int make_levels(int n_levels, const int* res, unsigned dense, unsigned n_rows, float lo,
                float inv, float top, Levels& lv) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || n_rows == 0) return (int)cudaErrorInvalidValue;
  lv.n_levels = n_levels;
  lv.dense = dense;
  lv.n_rows = n_rows;
  lv.lo = lo;
  lv.inv = inv;
  lv.top = top;
  for (int l = 0; l < MAX_LEVELS; ++l) lv.res[l] = l < n_levels ? res[l] : 0;
  return 0;
}

unsigned encoder_blocks(int n, int n_levels) {
  return (unsigned)(((long long)n * n_levels + THREADS - 1) / THREADS);
}

// The interpolation (backward: bwd = 1) for rows of F elements of EB bytes.
template <int EB, int F>
void launch_interp(bool bwd, const void* a, const float* pts, void* b, int n, const Levels& lv,
                   cudaStream_t s) {
  const unsigned blocks = encoder_blocks(n, lv.n_levels);
  if (bwd)
    hash_interp_bwd_kernel<EB, F><<<blocks, THREADS, 0, s>>>(static_cast<const float*>(a), pts,
                                                              b, n, lv);
  else
    hash_interp_kernel<EB, F><<<blocks, THREADS, 0, s>>>(a, pts, static_cast<float*>(b), n, lv);
}

template <int EB>
int launch_interp_width(bool bwd, const void* a, const float* pts, void* b, int n,
                        int n_features, const Levels& lv, cudaStream_t s) {
  switch (n_features) {
    case 1: launch_interp<EB, 1>(bwd, a, pts, b, n, lv, s); break;
    case 2: launch_interp<EB, 2>(bwd, a, pts, b, n, lv, s); break;
    case 4: launch_interp<EB, 4>(bwd, a, pts, b, n, lv, s); break;
    case 8: launch_interp<EB, 8>(bwd, a, pts, b, n, lv, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int encoder_interp(bool bwd, const void* a, const float* pts, void* b, int n, int n_levels,
                   const int* res, unsigned dense, unsigned n_rows, float lo, float inv,
                   float top, int elem_bytes, int n_features, cudaStream_t s) {
  Levels lv;
  int err = make_levels(n_levels, res, dense, n_rows, lo, inv, top, lv);
  if (err) return err;
  if (n < 0 || (long long)n * n_levels > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (elem_bytes == 2) err = launch_interp_width<2>(bwd, a, pts, b, n, n_features, lv, s);
  else if (elem_bytes == 4) err = launch_interp_width<4>(bwd, a, pts, b, n, n_features, lv, s);
  else err = (int)cudaErrorInvalidValue;
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// table [n_rows, row_bytes] (any dtype), idx [n] int32 -> out [n, row_bytes].
// row_bytes must be a multiple of 2; table and out aligned to 16 bytes, idx
// to 4. Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue.
extern "C" int launch_gather_rows(const void* table, const int* idx, void* out,
                                  long long n_rows, int n, int row_bytes, void* stream) {
  if (n < 0 || row_bytes <= 0 || row_bytes % 2) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (row_bytes) {
    case 2: err = launch_narrow<2>(table, idx, out, n_rows, n, s); break;
    case 4: err = launch_narrow<4>(table, idx, out, n_rows, n, s); break;
    case 8: err = launch_narrow<8>(table, idx, out, n_rows, n, s); break;
    case 16: err = launch_wide<uint4, 1>(table, idx, out, n_rows, n, row_bytes, s); break;
    case 32: err = launch_wide<uint4, 2>(table, idx, out, n_rows, n, row_bytes, s); break;
    default:
      if (row_bytes % 16 == 0)
        err = launch_wide<uint4, 0>(table, idx, out, n_rows, n, row_bytes, s);
      else if (row_bytes % 8 == 0)
        err = launch_wide<uint2, 0>(table, idx, out, n_rows, n, row_bytes, s);
      else if (row_bytes % 4 == 0)
        err = launch_wide<uint32_t, 0>(table, idx, out, n_rows, n, row_bytes, s);
      else
        err = launch_wide<uint16_t, 0>(table, idx, out, n_rows, n, row_bytes, s);
  }
  return err ? err : (int)cudaGetLastError();
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

// The hash encoder's levels, passed to each of its three launches:
// n_levels resolutions (at most MAX_LEVELS) from the host array res, the
// dense levels' bits, T rows a level, the box's corner lo, inv = 1 / its size
// (a float computed as PyTorch computes a Python scalar's reciprocal), the
// clamp's top (the float nearest 1 - 1e-6). pts [n, 3] float32, 4-byte
// aligned. Each returns the CUDA error of its launch (0 on success), or
// cudaErrorInvalidValue.

// idx [n_levels, n, 8] int32 (16-byte aligned): each point's 8 corner rows
// at each level, in product order, plus the level's base l T.
extern "C" int launch_hash_index(const float* pts, int* idx, int n, int n_levels,
                                 const int* res, unsigned dense, unsigned n_rows, float lo,
                                 float inv, float top, void* stream) {
  Levels lv;
  const int err = make_levels(n_levels, res, dense, n_rows, lo, inv, top, lv);
  if (err) return err;
  if (n < 0 || (long long)n * n_levels > 0x7fffffffLL ||
      (long long)n_levels * n_rows > 0x80000000LL)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  hash_index_kernel<<<encoder_blocks(n, n_levels), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(pts, idx, n, lv);
  return (int)cudaGetLastError();
}

// rows [n_levels n 8, F] of elem_bytes (2: bfloat16, 4: float32; 16-byte
// aligned), F = n_features in {1, 2, 4, 8} -> out [n, n_levels F] float32.
extern "C" int launch_hash_interp(const void* rows, const float* pts, float* out, int n,
                                  int n_levels, const int* res, unsigned dense, unsigned n_rows,
                                  float lo, float inv, float top, int elem_bytes, int n_features,
                                  void* stream) {
  return encoder_interp(false, rows, pts, out, n, n_levels, res, dense, n_rows, lo, inv, top,
                        elem_bytes, n_features, static_cast<cudaStream_t>(stream));
}

// g [n, n_levels F] float32 -> cot [n_levels n 8, F] of elem_bytes (16-byte
// aligned): g w for each corner, rounded once.
extern "C" int launch_hash_interp_bwd(const float* g, const float* pts, void* cot, int n,
                                      int n_levels, const int* res, unsigned dense,
                                      unsigned n_rows, float lo, float inv, float top,
                                      int elem_bytes, int n_features, void* stream) {
  return encoder_interp(true, g, pts, cot, n, n_levels, res, dense, n_rows, lo, inv, top,
                        elem_bytes, n_features, static_cast<cudaStream_t>(stream));
}
