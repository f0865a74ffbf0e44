// Multi-tensor Adam: one optimizer step over every leaf of one dtype in one launch.
//
// Replaces no TPU kernel: the JAX package's update is optax's chain
// (nerf_tpu/train/optim.py), which XLA fuses by itself. The port's eager
// loop (nerf_tpu_torch/train/optim.py Optimizer.step_plain, its plain
// version) launches 15 elementwise kernels a leaf: 720 for lego's 48
// leaves, each one host dispatch while the card waits. This kernel does the
// loop's arithmetic for all of a step's leaves of one dtype in one launch
// (64 leaves a launch at most), and updates p, mu and nu in place.
//
// What bounds it on an H100: bytes. A float32 element reads p, g, mu, nu
// and writes p, mu, nu: 28 bytes (14 in bfloat16) against ~20 flops. Lego's
// 1,191,688 parameters move 33.4 MB: 10.0 us at 3.35 TB/s.
//
// What the design does about it: blocks of 256 threads over tiles of 2,048
// elements of one leaf, enough blocks to fill the card for any leaf mix; a
// block finds its leaf by a binary search of the leaves' first tiles. The
// table of leaves (pointers, element counts, first tiles) and the step's
// scalars travel by value in the launch's parameters, so nothing is copied
// from the host for them. 16-byte vector loads and stores where a leaf's
// four pointers are 16-byte aligned, consecutive threads on consecutive
// vectors, all of a thread's loads issued before its math; element by
// element otherwise, and on a tile's ragged tail.
//
// The arithmetic is the loop's as the card runs it, bit for bit: each of
// the loop's PyTorch ops is one rounding here, in the loop's order, with
// __fmul_rn/__fadd_rn (no FMA contraction), IEEE division and square root.
// PyTorch divides a CUDA tensor by a Python scalar as a product with the
// scalar's float reciprocal (div_true_kernel_cuda), so the host passes
// 1/bc1 and 1/bc2 as it computes them. In bfloat16 each op computes in
// float on bfloat16 operands and rounds its result to bfloat16 (PyTorch's
// opmath), with the constants the loop rounds to bfloat16.
//
// Per-leaf rules (Instant-NGP's optimizer, arXiv:2201.05989 section 4): an
// L2 term l2 * p added to the (clipped) gradient before the moments, set on
// the MLP weights alone; and a skip: where a leaf with the skip (the hash
// table) has a gradient of exactly 0, its p, mu and nu are left as they
// are. The loop does the same (step_plain). While a counter is given, each
// block of a skip leaf adds the elements it left to it with one atomic.
// Lego's leaves have neither rule and take the path they took before.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers; bound with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 64;  // leaves one launch's parameters carry (< 4 KB in all)
constexpr int THREADS = 256;
constexpr int TILE = THREADS * 8;  // elements a block: two float4 or one bf16 x 8 a thread
constexpr float CLIP = 40.0f;
enum Kind { ADAM = 0, RADAM = 1, SGD = 2 };

}  // namespace

struct AdamScalars {
  float omb1, b1, omb2, b2;  // 1 - b1, b1, 1 - b2, b2
  float inv_bc1, inv_bc2;    // float reciprocals of the bias corrections
  float eps, r, wd, neg_lr;  // eps, RAdam's r, weight decay, -lr
  int kind;   // Kind
  int bare;   // 1: no clip
  int rect;   // adam, or radam with ro >= 5: m_hat / (sqrt(v_hat) + eps)
  int decay;  // 1: weight decay > 0
};

struct AdamArgs {
  AdamScalars s;
  int n_leaves;
  int tile_start[MAX_LEAVES + 1];  // leaf i's tiles: [tile_start[i], tile_start[i + 1])
  long long numel[MAX_LEAVES];
  void* p[MAX_LEAVES];
  const void* g[MAX_LEAVES];
  void* m[MAX_LEAVES];  // null for SGD
  void* v[MAX_LEAVES];
  float l2[MAX_LEAVES];  // L2 factor on the gradient, 0 for none
  int skip[MAX_LEAVES];  // 1: no step for an element whose gradient is exactly 0
  unsigned long long* skipped;  // null, or the count of elements the skip left
};

namespace {

template <typename T>
struct alignas(16) Vec {
  T x[16 / sizeof(T)];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one op's result in the leaf's dtype: float stays, bfloat16 rounds
template <typename T>
__device__ __forceinline__ float R(float x) { return to_f(from_f<T>(x)); }

template <typename T, bool RULES>
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const AdamScalars& s, float l2) {
  if (!s.bare) g = isnan(g) ? g : fminf(fmaxf(g, -CLIP), CLIP);
  if (RULES && l2 != 0.0f) g = R<T>(__fadd_rn(g, R<T>(__fmul_rn(l2, p))));
  float u;
  if (s.kind == SGD) {
    u = g;
  } else {
    m = R<T>(__fadd_rn(R<T>(__fmul_rn(s.omb1, g)), R<T>(__fmul_rn(s.b1, m))));
    v = R<T>(__fadd_rn(R<T>(__fmul_rn(s.omb2, R<T>(__fmul_rn(g, g)))),
                       R<T>(__fmul_rn(s.b2, v))));
    const float m_hat = R<T>(__fmul_rn(m, s.inv_bc1));
    if (s.rect) {
      const float v_hat = R<T>(__fmul_rn(v, s.inv_bc2));
      u = R<T>(__fdiv_rn(m_hat, R<T>(__fadd_rn(R<T>(__fsqrt_rn(v_hat)), s.eps))));
      if (s.kind == RADAM) u = R<T>(__fmul_rn(s.r, u));
    } else {
      u = m_hat;
    }
  }
  if (s.decay) u = R<T>(__fadd_rn(u, R<T>(__fmul_rn(s.wd, p))));
  p = R<T>(__fadd_rn(p, R<T>(__fmul_rn(u, s.neg_lr))));
}

// Returns 1 where the skip left the element, else 0.
template <typename T, bool RULES>
__device__ __forceinline__ int update_one(T* p, const T* g, T* m, T* v, long long i,
                                          const AdamScalars& s, bool moments, float l2,
                                          bool skip) {
  const float gf = to_f(g[i]);
  if (RULES && skip && gf == 0.0f) return 1;
  float pf = to_f(p[i]), mf = 0.0f, vf = 0.0f;
  if (moments) mf = to_f(m[i]), vf = to_f(v[i]);
  update<T, RULES>(pf, gf, mf, vf, s, l2);
  p[i] = from_f<T>(pf);
  if (moments) m[i] = from_f<T>(mf), v[i] = from_f<T>(vf);
  return 0;
}

// RULES: some leaf of the launch has an L2 factor or the skip; without
// (lego's leaves) the kernel is the plain update, none of their code compiled in.
template <typename T, bool RULES>
__global__ void __launch_bounds__(THREADS) adam_kernel(const AdamArgs args) {
  const int tile = blockIdx.x;
  int lo = 0, hi = args.n_leaves - 1;  // the last leaf whose first tile is <= tile
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (args.tile_start[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  const long long base = (long long)(tile - args.tile_start[lo]) * TILE;
  const long long left = args.numel[lo] - base;
  const int len = left < TILE ? (int)left : TILE;
  const AdamScalars& s = args.s;
  const bool moments = s.kind != SGD;
  const float l2 = RULES ? args.l2[lo] : 0.0f;
  const bool skip = RULES && args.skip[lo] != 0;  // the same for the whole block
  int kept = 0;  // elements the skip left as they were, this thread's
  T* p = static_cast<T*>(args.p[lo]) + base;
  const T* g = static_cast<const T*>(args.g[lo]) + base;
  T* m = moments ? static_cast<T*>(args.m[lo]) + base : nullptr;
  T* v = moments ? static_cast<T*>(args.v[lo]) + base : nullptr;

  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPT = TILE / THREADS / VEC;  // vectors a thread: 2 float4, or 1 of 8 bf16
  uintptr_t bits = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g);
  if (moments) bits |= reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
  int done = 0;
  if ((bits & 15) == 0) {
    // every load of the thread's vectors first, then the math and the stores:
    // the loads of both float4 rounds are in flight together
    const int n_vec = len / VEC;
    Vec<T> pv[VPT], gv[VPT], mv[VPT], vv[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = threadIdx.x + k * THREADS;
      if (i < n_vec) {
        pv[k] = reinterpret_cast<const Vec<T>*>(p)[i];
        gv[k] = reinterpret_cast<const Vec<T>*>(g)[i];
        if (moments) {
          mv[k] = reinterpret_cast<const Vec<T>*>(m)[i];
          vv[k] = reinterpret_cast<const Vec<T>*>(v)[i];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = threadIdx.x + k * THREADS;
      if (i < n_vec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float gf = to_f(gv[k].x[e]);
          if (skip && gf == 0.0f) {  // the loaded values are stored back as they were
            ++kept;
            continue;
          }
          float pf = to_f(pv[k].x[e]), mf = moments ? to_f(mv[k].x[e]) : 0.0f;
          float vf = moments ? to_f(vv[k].x[e]) : 0.0f;
          update<T, RULES>(pf, gf, mf, vf, s, l2);
          pv[k].x[e] = from_f<T>(pf);
          if (moments) mv[k].x[e] = from_f<T>(mf), vv[k].x[e] = from_f<T>(vf);
        }
        reinterpret_cast<Vec<T>*>(p)[i] = pv[k];
        if (moments) {
          reinterpret_cast<Vec<T>*>(m)[i] = mv[k];
          reinterpret_cast<Vec<T>*>(v)[i] = vv[k];
        }
      }
    }
    done = n_vec * VEC;
  }
  for (int i = done + threadIdx.x; i < len; i += THREADS)
    kept += update_one<T, RULES>(p, g, m, v, i, s, moments, l2, skip);
  if (skip && args.skipped != nullptr) {  // block-uniform: every thread is here
    __shared__ int warp_kept[THREADS / 32];
    kept = __reduce_add_sync(0xffffffffu, kept);
    if ((threadIdx.x & 31) == 0) warp_kept[threadIdx.x >> 5] = kept;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long block = 0;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) block += warp_kept[w];
      if (block) atomicAdd(args.skipped, block);
    }
  }
}

}  // namespace

// The table's layout, for the ctypes mirror's check: sizeof(AdamArgs), the
// offsets of n_leaves, tile_start, numel, p, g, m, v, then MAX_LEAVES and
// TILE, then the offsets of l2, skip and skipped.
extern "C" void adam_layout(int* out) {
  out[0] = (int)sizeof(AdamArgs);
  out[1] = (int)offsetof(AdamArgs, n_leaves);
  out[2] = (int)offsetof(AdamArgs, tile_start);
  out[3] = (int)offsetof(AdamArgs, numel);
  out[4] = (int)offsetof(AdamArgs, p);
  out[5] = (int)offsetof(AdamArgs, g);
  out[6] = (int)offsetof(AdamArgs, m);
  out[7] = (int)offsetof(AdamArgs, v);
  out[8] = MAX_LEAVES;
  out[9] = TILE;
  out[10] = (int)offsetof(AdamArgs, l2);
  out[11] = (int)offsetof(AdamArgs, skip);
  out[12] = (int)offsetof(AdamArgs, skipped);
}

// One launch over args->tile_start[args->n_leaves] tiles; bf16 selects the
// bfloat16 instantiation, rules the one with the per-leaf rules (set when
// some leaf of the launch has an L2 factor or the skip). Returns
// cudaGetLastError().
extern "C" int launch_adam(const AdamArgs* args, int bf16, int rules, void* stream) {
  if (args->n_leaves < 1 || args->n_leaves > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  const int tiles = args->tile_start[args->n_leaves];
  if (tiles < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (rules) adam_kernel<__nv_bfloat16, true><<<tiles, THREADS, 0, st>>>(*args);
    else adam_kernel<__nv_bfloat16, false><<<tiles, THREADS, 0, st>>>(*args);
  } else {
    if (rules) adam_kernel<float, true><<<tiles, THREADS, 0, st>>>(*args);
    else adam_kernel<float, false><<<tiles, THREADS, 0, st>>>(*args);
  }
  return (int)cudaGetLastError();
}
