// The backward of the padded per-thread MLPs of march_common.cuh, shared by
// the renderer's recompute backward (renderer_bw.cu) and the splatter's
// adjoint (splatter_bw.cu): a layer's input gradient per thread, and its
// weight gradient as a sum over the block's rays of outer products, kept in
// a per-block row of partial sums that a second kernel reduces into the
// flat, unpadded gradient (see renderer_bw.cu for the design).

#pragma once

#include "march_common.cuh"

namespace lightplane {

// g_in[i] = sum_o layer[i][o] * g_out[o]: the input gradient of a layer.
template <int W>
__device__ __forceinline__ void dense_bwd(const float* __restrict__ layer,
                                          const float (&g_out)[W],
                                          float (&g_in)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float4* row = reinterpret_cast<const float4*>(layer + i * W);
    float a = 0.0f;
#pragma unroll
    for (int o4 = 0; o4 < W / 4; ++o4) {
      const float4 w = row[o4];
      a += w.x * g_out[4 * o4 + 0] + w.y * g_out[4 * o4 + 1] +
           w.z * g_out[4 * o4 + 2] + w.w * g_out[4 * o4 + 3];
    }
    g_in[i] = a;
  }
}

// The entries of a padded [W*W + W] layer gradient that thread `tid` of a
// block of `rays` threads owns: columns o = tid % cols, + cols, ... and rows
// [row0, row0 + rows), plus the bias of its columns when row0 == 0.
struct Owned {
  int cols, row0, rows;
};

template <int W>
__device__ __forceinline__ Owned owned_entries(int rays, int tid) {
  Owned e;
  e.cols = min(W, rays);
  const int groups = max(1, rays / W);
  e.rows = W / groups;
  e.row0 = (tid / e.cols) * e.rows;
  return e;
}

// part[i][o] += sum_r X[i][r] * G[o][r] and part[W*W + o] += sum_r G[o][r]
// over the block's rays, for the entries this thread owns.  X (and X2,
// added to it when given) is [W][rays]; G is [W][rays + 4], a stride that
// keeps a quarter-warp's float4 loads on distinct banks.
template <int W>
__device__ __forceinline__ void weight_grad(float* __restrict__ part,
                                            const float* X, const float* X2,
                                            const float* G, int rays,
                                            int tid) {
  const Owned e = owned_entries<W>(rays, tid);
  for (int o = tid % e.cols; o < W; o += e.cols) {
    const float* g_row = G + o * (rays + 4);
    for (int i0 = e.row0; i0 < e.row0 + e.rows; i0 += 8) {
      float acc[8], acc_b = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
      for (int r = 0; r < rays; r += 4) {
        const float4 g = *reinterpret_cast<const float4*>(g_row + r);
        acc_b += (g.x + g.y) + (g.z + g.w);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float4 x = *reinterpret_cast<const float4*>(X + (i0 + k) * rays + r);
          if (X2 != nullptr) {
            const float4 x2 =
                *reinterpret_cast<const float4*>(X2 + (i0 + k) * rays + r);
            x.x += x2.x;
            x.y += x2.y;
            x.z += x2.z;
            x.w += x2.w;
          }
          acc[k] += x.x * g.x + x.y * g.y + x.z * g.z + x.w * g.w;
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) part[(i0 + k) * W + o] += acc[k];
      if (i0 == 0) part[W * W + o] += acc_b;
    }
  }
}

// Zeroes the entries of the block's partial row (n_total padded layers)
// that thread `tid` owns: each thread only ever touches its own entries.
template <int W>
__device__ __forceinline__ void zero_owned_partial(float* __restrict__ part,
                                                   int n_total, int rays,
                                                   int tid) {
  constexpr int kLayer = W * W + W;
  const Owned e = owned_entries<W>(rays, tid);
  for (int l = 0; l < n_total; ++l)
    for (int o = tid % e.cols; o < W; o += e.cols) {
      for (int i = e.row0; i < e.row0 + e.rows; ++i)
        part[l * kLayer + i * W + o] = 0.0f;
      if (e.row0 == 0) part[l * kLayer + W * W + o] = 0.0f;
    }
}

// g_mlp[k] = the sum over blocks of the padded partial entry of flat index k.
template <int W>
__global__ void reduce_mlp_grad_kernel(const Params p, int n_blocks) {
  constexpr int kLayer = W * W + W;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.n_params) return;
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  int padded = 0;
  for (int L = 0; L < n_total; ++L) {
    const int d_in = p.layer_in[L], d_out = p.layer_out[L];
    const int w_off = p.layer_w_off[L], b_off = p.layer_b_off[L];
    if (k >= w_off && k < w_off + d_in * d_out) {
      const int e = k - w_off;
      padded = L * kLayer + (e / d_out) * W + e % d_out;
      break;
    }
    if (k >= b_off && k < b_off + d_out) {
      padded = L * kLayer + W * W + (k - b_off);
      break;
    }
  }
  const long long stride = (long long)n_total * kLayer;
  float acc = 0.0f;
  for (int b = 0; b < n_blocks; ++b) acc += p.g_mlp_partial[b * stride + padded];
  p.g_mlp[k] = acc;
}

}  // namespace lightplane
