// The fused NeRF MLP's data layout, shared by fused_mlp.cu (the serving
// forward), fused_mlp_bwd.cu (the backward) and fused_mlp_wgmma.cuh (the
// wgmma forward both run): the network's widths, the offsets of each layer
// in the packed bf16 weight buffer wbuf and the f32 bias buffer bbuf
// (ops/fused_mlp.py::repack_params writes them), and the columns of the
// backward's activation stash. The design note is in fused_mlp.cu.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int W = 256;                 // trunk width
constexpr int VW = 128;                // view layer width
constexpr int XF = 10;                 // xyz frequency bands
constexpr int DF = 4;                  // dir frequency bands
constexpr int EX = 64;                 // xyz encoding 3 + 2*30 = 63, padded to 64
constexpr int ED = 32;                 // dir encoding 3 + 2*12 = 27, padded to 32

// bf16 weight buffer: matrices [K, N] row-major, in this order
constexpr int OFF_W0 = 0;                       // [64, 256]: x, sin, cos, 0
constexpr int OFF_W1 = OFF_W0 + EX * W;
constexpr int OFF_W2 = OFF_W1 + W * W;
constexpr int OFF_W3 = OFF_W2 + W * W;
constexpr int OFF_W4 = OFF_W3 + W * W;
constexpr int OFF_W5 = OFF_W4 + W * W;          // [320, 256]: x, sin, cos, 0, h
constexpr int OFF_W6 = OFF_W5 + (EX + W) * W;
constexpr int OFF_W7 = OFF_W6 + W * W;
constexpr int OFF_WF = OFF_W7 + W * W;
constexpr int OFF_WV = OFF_WF + W * W;          // [288, 128]: feat, d, sin, cos, 0
constexpr int OFF_WA = OFF_WV + (W + ED) * VW;  // [256]
constexpr int OFF_WR = OFF_WA + W;              // [128, 3]
constexpr int WBUF_SIZE = OFF_WR + VW * 3;
// f32 bias buffer
constexpr int OFF_BF = 8 * W;
constexpr int OFF_BV = OFF_BF + W;
constexpr int OFF_BA = OFF_BV + VW;
constexpr int OFF_BR = OFF_BA + 1;
constexpr int BBUF_SIZE = OFF_BR + 3;

// Activation stash of the backward's recomputed forward: one bf16 row of SLD
// columns per point, holding each layer's input so that the skip and view
// inputs are adjacent columns as in the tile:
//   h1 h2 h3 h4 | enc_x h5 | h6 h7 h8 | feat enc_d | v
// (h_i is the output of trunk layer i-1, after its ReLU).
constexpr int S_EX = 4 * W;                     // 1024, enc_x; layer 5 reads [enc_x, h5]
constexpr int S_FEAT = S_EX + EX + 4 * W;      // 2112, after h5..h8; the view layer reads [feat, enc_d]
constexpr int S_ED = S_FEAT + W;               // 2368
constexpr int S_V = S_ED + ED;                 // 2400
constexpr int SLD = S_V + VW;                  // 2528 columns
// the stash column of h_{l+1}, the output of trunk layer l (0..7)
__host__ __device__ constexpr int s_h(int l) { return l < 4 ? l * W : S_EX + EX + (l - 4) * W; }

}  // namespace
