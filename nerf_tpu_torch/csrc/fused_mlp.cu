// Fused frequency encoding + NeRF-MLP forward for Hopper (sm_90a): the
// serving forward, on wgmma with the weights streamed through a shared-memory
// ring by bulk asynchronous copies, one persistent block per SM.
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
// tensor cores, not the 3.35 TB/s of device memory, set the floor. The
// 1.19 MB of weights do not fit one SM, so every tile of points streams all
// of them from L2: at 128 points a tile that is 9.3 KB of L2 traffic a point
// (measured on an H100: a variant that skips the copies is no faster, so L2
// does not bound it at this tile size).
//
// The design, and why:
// - Block = two consumer warpgroups (64 points each, so a tile is 128
//   points: m64 is wgmma's row count, and a 64x256 f32 accumulator is all
//   the registers a thread can spare) and one producer warpgroup, 384
//   threads, __launch_bounds__(384, 1): the 227 KB of shared memory below
//   fit one block per SM. The grid is one block per SM (at most),
//   persistent over the tiles: block b takes tiles b, b + grid, ... so the
//   weight ring never drains between tiles.
// - setmaxnreg: the producer warpgroup drops to 40 registers, the consumers
//   rise to 232 (384 x 168 at launch = 128 x 40 + 256 x 232). A consumer
//   thread holds the 128 accumulator registers and addressing; ptxas -v
//   shows no spills.
// - Weights: the eleven matrices of the ten layers, in layer order, repacked
//   on the host (ops/fused_mlp.py::pack_weight_stream) into wgmma's canonical
//   K-major layout without swizzle: [K/8, N, 8], so that 8 K-values of one
//   output column are 16 contiguous bytes and 8 columns one 128-byte core
//   matrix. Cut into chunks of 64 K-rows (32 KB for N = 256; the view layer's
//   N = 128 gives 16 KB chunks and a last one of 32 rows), 39 chunks a tile.
//   One producer thread copies each chunk with one 1-D bulk copy
//   (cp.async.bulk, completion counted in bytes on the stage's full
//   mbarrier), with no tensor map, into a ring of 4 stages of 32 KB (3 stages
//   measured 10% slower; 8 stages of 16 KB 4% slower). Every consumer warp
//   arrives on the stage's empty mbarrier when its products have read it.
//   Phases come from a running chunk count, so the ring runs on across
//   tiles: the next tile's first layers load while this tile's last run.
// - Products: wgmma.mma_async m64n256k16 (m64n128k16 for the view layer),
//   bf16 x bf16 -> f32, A and B from shared memory by descriptor. Each
//   consumer warpgroup keeps its 64-point activation tile in shared memory in
//   the same canonical layout: 44 slabs of 8 columns x 64 rows (1 KB each):
//   enc_x (slabs 0-7), h (8-39), enc_d (40-43), so the skip layer reads
//   slabs 0-39 and the view layer slabs 8-43 as one K = 320 / 288 product.
// - Ping-pong: the two warpgroups take turns issuing a layer's products
//   (Turns below), so one runs its epilogue while the other's products run.
// - Epilogue in registers: bias (from shared memory, loaded two steps ahead),
//   then ReLU and the bf16 rounding in one cvt.rn.relu.bf16x2 are applied to
//   the accumulator fragment, which each thread stores as 32-bit pairs
//   straight into the next layer's input slabs (a warp's stores fill whole
//   128-byte core matrices, so no bank conflicts), in place over the layer's
//   input once its products are done; no f32 staging. The sigma (256 -> 1)
//   and rgb (128 -> 3) heads are dot products of each thread's accumulator
//   columns, summed over the 4 lanes of a row.
// - Ragged last tile: loads of pts/dirs past P read zeros, stores past P are
//   skipped. P = 0 launches nothing.
//
// The kernel's code is in fused_mlp_wgmma.cuh (a template: the backward,
// fused_mlp_bwd.cu, recomputes its forward with the same code, which also
// writes the activation stash and the ReLU masks), the PTX helpers in
// hopper.cuh; the layout of the packed buffers in fused_mlp.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers; bound with ctypes).


#include "fused_mlp_wgmma.cuh"

namespace {

// Test of layer_product alone: out[128 x 256] f32 = a[128 x 256] @ B, where
// a is row-major bf16 and w is one 256 x 256 layer in the weight stream's
// layout ([32, 256, 8] bf16). The same block, ring and descriptors as above.
__global__ void __launch_bounds__(NTHR, 1)
wgmma_layer_test_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                        float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t *full, *empty;
  setup(smem, nullptr, full, empty);
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * 128) produce(w, smem, full, empty, 1, W / KC);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    unsigned char* act = smem + SM_ACT + wg * ACT_BYTES_WG;
    for (int i = threadIdx.x & 127; i < WG_ROWS * (W / 8); i += 128) {
      const int r = i % WG_ROWS, g = i / WG_ROWS;  // 16 bytes: 8 columns of one row
      *reinterpret_cast<uint4*>(act + (SLAB_H + g) * SLAB + (r >> 3) * 128 + (r & 7) * 16) =
          *reinterpret_cast<const uint4*>(a + (wg * WG_ROWS + r) * W + g * 8);
    }
    tile_written(wg);
    Ring ring{smem_addr(smem), full, empty};
    Turns turns{wg, turns_of<W>()};
    if (wg == 1) named_arrive(3, 256);
    float d[128];
    layer_product<W, W>(d, smem_addr(act) + SLAB_H * SLAB, ring, turns);
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int row = wg * WG_ROWS + warp * 16 + (lane >> 2), q = lane & 3;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = 8 * j + 2 * q;
      *reinterpret_cast<float2*>(out + row * W + col) = make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (row + 8) * W + col) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

}  // namespace

extern "C" void fused_nerf_buffer_sizes(int* wbuf, int* bbuf, int* wpack) {
  *wbuf = WBUF_SIZE;
  *bbuf = BBUF_SIZE;
  *wpack = WPACK_SIZE;
}

// pts, dirs: [P, 3] f32; wpack: WPACK_SIZE bf16, the weight stream (16-byte
// aligned); wbuf: WBUF_SIZE bf16 (for the heads); bbuf: BBUF_SIZE f32;
// out: [P, 4] f32 (16-byte aligned). Returns the CUDA error code.
extern "C" int launch_fused_nerf(const void* pts, const void* dirs, const void* wpack,
                                 const void* wbuf, const void* bbuf, void* out, int P,
                                 void* stream) {
  // above 48 KB of dynamic shared memory a kernel must opt in (per device)
  cudaError_t e = cudaFuncSetAttribute(fused_nerf_wgmma_kernel<false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (P <= 0) return 0;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int tiles = (P + TILE - 1) / TILE;
  fused_nerf_wgmma_kernel<false>
      <<<tiles < sms ? tiles : sms, NTHR, WG_SMEM, (cudaStream_t)stream>>>(
          (const float*)pts, (const float*)dirs, (const bf16*)wpack, (const bf16*)wbuf,
          (const float*)bbuf, (float*)out, P, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// a: [128, 256] bf16 row-major; w: [32, 256, 8] bf16 (one layer of the weight
// stream); out: [128, 256] f32. Returns the CUDA error code.
extern "C" int launch_wgmma_layer_test(const void* a, const void* w, void* out, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(wgmma_layer_test_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  wgmma_layer_test_kernel<<<1, NTHR, WG_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)w, (float*)out);
  return (int)cudaGetLastError();
}
