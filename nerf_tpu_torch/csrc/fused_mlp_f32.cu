// Fused frequency encoding + NeRF-MLP forward with float32 weights (B1-f32),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nerf_tpu/ops/fused_mlp.py:129 (_fused_kernel)
// in its float32 mode: there the products run in the packed weights' dtype,
// so network.dtype float32 gives a float32 MLP. Plain PyTorch version:
// nerf_tpu_torch/ops/fused_mlp.py::fused_nerf_eval_plain with float32 weights.
//
// What it computes, per point: the phases a = x * 2^f (exact), the encoding
// [x, sin a, cos a], the 8x256 ReLU trunk with the skip at layer 5, sigma,
// the feature, the 128-wide view layer on [feat, d, sin b, cos b] and rgb;
// out[p] = [rgb, sigma]. Every product is a float32 multiply-add (fmaf), in
// order of the reduction index: true float32, not TF32 (Hopper's tensor
// cores take no float32 operands; their TF32 mode rounds them to 10 bits).
//
// What bounds it on an H100: operations. 593,408 multiply-adds (1.187 MFLOP)
// a point at 67 TFLOP/s (float32 on the CUDA cores, data sheet) is 17.7 ns a
// point, 27.9 ms for a lego fine tile of 1,572,864 points; its 40 bytes of
// input and output a point are 0.019 ms of memory time there.
//
// The design (fused_mlp_f32.cuh), simple first:
// - A block of 256 threads takes a tile of 64 points. The tile's encodings
//   (24 KB) and its activations (64 KB) stay in shared memory as rows of 64
//   points, from the encoding to rgb; nothing but the points, directions
//   and outputs touches device memory.
// - Each layer's weights stream from L2 through shared memory in chunks of
//   8 rows, double-buffered, the next chunk held in registers while the
//   current one is multiplied (2.4 MB of weights a tile).
// - Register-blocked outer products: a thread owns 8 points x 8 outputs (64
//   float32 accumulators); per reduction step it reads two float4 of
//   activations and two of weights for 64 FFMAs.
// - 104 KB of shared memory a block and at most 128 registers a thread, so
//   two blocks share an SM and one's loads overlap the other's products.
// - Ragged last tile: points past P read zeros and are not written.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers; bound with ctypes).

#include "fused_mlp_f32.cuh"

extern "C" void fused_nerf_f32_sizes(int* wbuf, int* bbuf) {
  *wbuf = f32mlp::WBUF_SIZE;
  *bbuf = f32mlp::BBUF_SIZE;
}

// pts, dirs: [P, 3] f32; wbuf: WBUF_SIZE f32 (16-byte aligned); bbuf:
// BBUF_SIZE f32; out: [P, 4] f32. Returns the CUDA error code.
extern "C" int launch_fused_nerf_f32(const void* pts, const void* dirs, const void* wbuf,
                                     const void* bbuf, void* out, int P, void* stream) {
  return (int)f32mlp::launch_fwd((const float*)pts, (const float*)dirs, (const float*)wbuf,
                                 (const float*)bbuf, (float*)out, P, nullptr,
                                 (cudaStream_t)stream);
}
