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
// The kernel is in fused_mlp.cuh, which the backward (fused_mlp_bwd.cu) shares.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers; bound with ctypes).

#include "fused_mlp.cuh"

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
      fused_nerf_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  if (P <= 0) return 0;
  const int blocks = (P + TP - 1) / TP;
  fused_nerf_kernel<false><<<blocks, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)dirs, (const bf16*)wbuf, (const float*)bbuf,
      (float*)out, P, nullptr);
  return (int)cudaGetLastError();
}
