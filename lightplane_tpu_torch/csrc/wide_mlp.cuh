// The dense layers of the wide builds (padded widths W = 96 and 128) of the
// renderer's forward march and recompute backward (renderer_wide.cu, R1 and
// R2) and the splatter's MLP adjoint (splatter_bw.cu, S2's pass A), over a
// chunk's [32][W + 4] tile of activations in shared memory (row j = step j).
//
// The 32- and 64-wide builds keep every layer in shared memory, in the
// tensor-core fragments' order.  At W = 128 a 2/2/2 MLP is ~400 KB and a
// Hopper block has 227 KB, so the wide builds keep none: the B fragments of
// a product are read straight from the flat, unpadded mlp_params in device
// memory (at most a few hundred KB, so they stay in L2 and mostly in L1),
// zero past a layer's widths.  A product is mma.sync m16n8k8 in 3xTF32 as
// warp_chunk.cuh::mma_rows's, one M-tile of 16 rows at a time (W / 2
// accumulators a lane), over a layer's own K and N rounded up to 8.  The
// weight gradient X^T G of a chunk is mlp_bwd.cuh::tc_weight_grad_rows's
// product, eight N-tiles at a time, added into a warp's own row of sums in
// device memory (the layout of splatter_bw.cu's MlpLayout: per layer mi x no
// accumulator tiles, tc_index(i, o, no), then 8 no bias sums).
//
// Everything is written against the template width, so a wider build
// (160-256) needs only its instantiation and the shared memory of its
// tiles.

#pragma once

#include "mlp_bwd.cuh"
#include "warp_chunk.cuh"

namespace lightplane {

// Element (k, n) of a layer's K x N operand: its weight (i = k, o = n), or
// with `transpose` (i = n, o = k); 0 outside the layer's [d_in, d_out].
__device__ __forceinline__ float layer_weight(const float* __restrict__ w,
                                              int d_in, int d_out, int k,
                                              int n, bool transpose) {
  const int i = transpose ? n : k, o = transpose ? k : n;
  return i < d_in && o < d_out ? __ldg(w + i * d_out + o) : 0.0f;
}

// out = epi(A @ B + bias) for the chunk's 32 rows on the tensor cores in
// 3xTF32, B the layer's [d_in, d_out] weights w in device memory (or their
// transpose: the input gradient's product, K = d_out, N = d_in), bias the
// layer's d_out biases or null for none.  The epilogue adds `add` (a tile
// like A, read at each output's own place) where given, takes relu where
// `relu`, and multiplies by (gate > 0) where `gate` is given.  Columns
// [0, 8 ceil(N / 8)) of out, and of out2 when given, get the rows; out may
// be A, gate or add (an M-tile's rows are all read before any is written).
template <int W>
__device__ __forceinline__ void wide_mma_rows(
    const float* A, const float* __restrict__ w, const float* __restrict__ bias,
    int d_in, int d_out, bool transpose, bool relu, const float* gate,
    const float* add, float* out, float* out2, int lane) {
  constexpr int S = W + 4, NT = W / 8;
  const int K = transpose ? d_out : d_in, N = transpose ? d_in : d_out;
  const int k_steps = (K + 7) / 8, n_tiles = (N + 7) / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int mt = 0; mt < 2; ++mt) {
    float d[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float b0 = 0.0f, b1 = 0.0f;
      const int o = nt * 8 + 2 * t;
      if (bias != nullptr && nt < n_tiles) {
        b0 = o < N ? __ldg(bias + o) : 0.0f;
        b1 = o + 1 < N ? __ldg(bias + o + 1) : 0.0f;
      }
      d[nt][0] = b0;
      d[nt][1] = b1;
      d[nt][2] = b0;
      d[nt][3] = b1;
    }
    // b0 (k t, n g), b1 (k t + 4, n g) of every N-tile: the next k-step's
    // are loaded before this one's MMAs, so that their latency overlaps
    float b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b[nt][0] = layer_weight(w, d_in, d_out, t, nt * 8 + g, transpose);
      b[nt][1] = layer_weight(w, d_in, d_out, t + 4, nt * 8 + g, transpose);
    }
#pragma unroll 1
    for (int ks = 0; ks < k_steps; ++ks) {
      // a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      const float* a = A + (mt * 16 + g) * S + ks * 8 + t;
      uint32_t ah[4], al[4];
      split_tf32(a[0], ah[0], al[0]);
      split_tf32(a[8 * S], ah[1], al[1]);
      split_tf32(a[4], ah[2], al[2]);
      split_tf32(a[8 * S + 4], ah[3], al[3]);
      const int k = (ks + 1) * 8 + t;  // the next k-step's (0 past K)
      float next[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        next[nt][0] = layer_weight(w, d_in, d_out, k, nt * 8 + g, transpose);
        next[nt][1] =
            layer_weight(w, d_in, d_out, k + 4, nt * 8 + g, transpose);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= n_tiles) continue;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b[nt][0], bh0, bl0);
        split_tf32(b[nt][1], bh1, bl1);
        mma_tf32(d[nt], al, bh0, bh1);
        mma_tf32(d[nt], ah, bl0, bl1);
        mma_tf32(d[nt], ah, bh0, bh1);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        b[nt][0] = next[nt][0];
        b[nt][1] = next[nt][1];
      }
    }
    __syncwarp();  // every lane's reads of these rows are done
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= n_tiles) continue;
      const int at = (mt * 16 + g) * S + nt * 8 + 2 * t;
      const int o[4] = {at, at + 1, at + 8 * S, at + 8 * S + 1};
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[e] = d[nt][e];
        if (add != nullptr) y[e] += add[o[e]];
        if (relu) y[e] = fmaxf(y[e], 0.0f);
        if (gate != nullptr && !(gate[o[e]] > 0.0f)) y[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) out[o[e]] = y[e];
      if (out2 != nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) out2[o[e]] = y[e];
      }
    }
  }
  __syncwarp();
}

// Output o of a layer with no activation (the heads' last layers) for the
// input `row` (a tile's row in shared memory, 16-byte aligned), in
// march_common.cuh::dense_out's order: the bias, then the products by
// ascending input.  o is the same in every lane (a broadcast of each
// weight).
template <int W>
__device__ __forceinline__ float wide_last_out(const float* row,
                                               const float* __restrict__ w,
                                               const float* __restrict__ bias,
                                               int d_in, int d_out, int o) {
  // 32 inputs at a time, each weight's load issued ahead of the products
  // (predicated: 0 past d_in, where adding x * 0 leaves the sum as it is)
  // and none behind a branch out of the loop, so their latencies overlap
  float acc = __ldg(bias + o);
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i0 = 0; i0 < W; i0 += 32) {
    float wv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      wv[i] = i0 + i < d_in ? __ldg(w + (i0 + i) * d_out + o) : 0.0f;
#pragma unroll
    for (int i4 = 0; i4 < 8; ++i4) {
      const float4 x = r4[i0 / 4 + i4];
      acc += x.x * wv[4 * i4];
      acc += x.y * wv[4 * i4 + 1];
      acc += x.z * wv[4 * i4 + 2];
      acc += x.w * wv[4 * i4 + 3];
    }
  }
  return acc;
}

// Layer l of p's MLPs, relu'd, over the tile X into out (and out2).
template <int W>
__device__ __forceinline__ void relu_layer(const Params& p, int l,
                                           const float* X, float* out,
                                           float* out2, int lane) {
  wide_mma_rows<W>(X, p.mlp + p.layer_w_off[l], p.mlp + p.layer_b_off[l],
                   p.layer_in[l], p.layer_out[l], false, true, nullptr,
                   nullptr, out, out2, lane);
}

// Output o of layer l of p's MLPs (no activation) for the input `row`.
template <int W>
__device__ __forceinline__ float layer_out(const Params& p, int l,
                                           const float* row, int o) {
  return wide_last_out<W>(row, p.mlp + p.layer_w_off[l],
                          p.mlp + p.layer_b_off[l], p.layer_in[l],
                          p.layer_out[l], o);
}

// The input gradient of layer l of p's MLPs: out = (G @ W_l^T [+ add]) x
// (gate > 0), gate and add as wide_mma_rows's.
template <int W>
__device__ __forceinline__ void layer_input_grad(const Params& p, int l,
                                                 const float* G,
                                                 const float* gate,
                                                 const float* add, float* out,
                                                 int lane) {
  wide_mma_rows<W>(G, p.mlp + p.layer_w_off[l], nullptr, p.layer_in[l],
                   p.layer_out[l], true, false, gate, add, out, nullptr, lane);
}

// acc += X^T G over the chunk's 32 rows for a [d_in, d_out] layer, and the
// bias sums acc[mi no 128 + o] += the column sums of G: the layer's sums in
// a warp's own row (device memory), mi = ceil(d_in / 16) M-tiles by no =
// ceil(d_out / 8) N-tiles of accumulator fragments (tc_index(i, o, no)).
// As tc_weight_grad_rows: per tile the products start at 0 over the 4
// k-steps of 8 rows and are then added to the sums in f32, three MMAs a
// tile, the small terms first; eight N-tiles at a time, so the
// accumulators and the split B fragments take 64 registers.  Those eight
// tiles' sums are loaded before the products and stored after them.
template <int W>
__device__ __forceinline__ void wide_weight_grad(float* acc, const float* X,
                                                 const float* G, int d_in,
                                                 int d_out, int lane) {
  constexpr int S = W + 4, kN = 8;
  const int mi = (d_in + 15) / 16, no = (d_out + 7) / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int mt = 0; mt < mi; ++mt) {
#pragma unroll 1
    for (int n0 = 0; n0 < no; n0 += kN) {
      float4* c = reinterpret_cast<float4*>(acc) + (mt * no + n0) * 32 + lane;
      // the sums' loads go out first, their latency behind the products
      float4 sum[kN];
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
        if (n0 + nt < no) sum[nt] = c[nt * 32];
      float d[kN][4];
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[nt][e] = 0.0f;
#pragma unroll 1
      for (int ks = 0; ks < 4; ++ks) {
        // A = X^T: a0 (i g, row t), a1 (g + 8, t), a2 (g, t + 4),
        // a3 (g + 8, t + 4)
        const float* a = X + (ks * 8 + t) * S + mt * 16 + g;
        uint32_t ah[4], al[4];
        split_tf32(a[0], ah[0], al[0]);
        split_tf32(a[8], ah[1], al[1]);
        split_tf32(a[4 * S], ah[2], al[2]);
        split_tf32(a[4 * S + 8], ah[3], al[3]);
        // B = G: b0 (row t, o g), b1 (t + 4, g)
        uint32_t bh[kN][2], bl[kN][2];
#pragma unroll
        for (int nt = 0; nt < kN; ++nt) {
          if (n0 + nt >= no) continue;
          const float* b = G + (ks * 8 + t) * S + (n0 + nt) * 8 + g;
          split_tf32(b[0], bh[nt][0], bl[nt][0]);
          split_tf32(b[4 * S], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int nt = 0; nt < kN; ++nt) {
            if (n0 + nt >= no) continue;
            if (term == 0) mma_tf32(d[nt], al, bh[nt][0], bh[nt][1]);
            if (term == 1) mma_tf32(d[nt], ah, bl[nt][0], bl[nt][1]);
            if (term == 2) mma_tf32(d[nt], ah, bh[nt][0], bh[nt][1]);
          }
      }
#pragma unroll
      for (int nt = 0; nt < kN; ++nt) {
        if (n0 + nt >= no) continue;
        float4 v = sum[nt];
        v.x += d[nt][0];
        v.y += d[nt][1];
        v.z += d[nt][2];
        v.w += d[nt][3];
        c[nt * 32] = v;
      }
    }
  }
  float* bias_acc = acc + mi * no * 128;
  for (int o = lane; o < 8 * no; o += 32) {
    float a = 0.0f;
    for (int j = 0; j < 32; ++j) a += G[j * S + o];
    bias_acc[o] += a;
  }
  __syncwarp();
}

// Floats of a layer's sums in a wide build's row (wide_weight_grad).
__host__ __device__ __forceinline__ int wide_sum_floats(int d_in, int d_out) {
  const int mi = (d_in + 15) / 16, no = (d_out + 7) / 8;
  return mi * no * 128 + 8 * no;
}

// The entry points of renderer_wide.cu that renderer_fw.cu's and
// renderer_bw.cu's C functions dispatch to at W = 96 and 128.
long long render_fw_wide_smem_bytes(int width, int warps);
cudaError_t launch_render_fw_wide(const Params& p, int width, int warps,
                                  cudaStream_t stream);
int render_fw_wide_attrs(int width, int* out);
// out[0] warps per block, out[1] rows of partial sums (the resident wave's
// warps), out[2] floats of a row, out[3] a block's shared memory in bytes;
// a cudaError_t code (cudaErrorInvalidValue where one warp's tiles exceed
// a block's shared memory).
int render_bw_wide_config(const Params& p, int width, bool color_grid,
                          int* out);
cudaError_t launch_render_bw_wide(const Params& p, int width,
                                  cudaStream_t stream);
int render_bw_wide_attrs(int width, int* out);

}  // namespace lightplane
