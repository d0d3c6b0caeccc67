// The backward of the MLPs of march_common.cuh and warp_chunk.cuh, shared by
// the renderer's recompute backward (renderer_bw.cu) and the splatter's
// adjoint (splatter_bw.cu): a layer's input gradient per thread, and its
// weight gradient as a sum over the block's rays of outer products, kept in
// a per-block row of partial sums that a second kernel reduces into the
// flat, unpadded gradient (see renderer_bw.cu for the design).  Two forms of
// the weight gradient: on the CUDA cores (weight_grad, any W; the row is
// the padded [W*W + W] layer) and on the tensor cores (R2's tc_weight_grad
// and tc_bias_grad at W = 32, the row holding mma fragments, tc_index;
// S2's tc_weight_grad_rows at W = 32 and 64, over a warp's chunk of
// samples).  Both kernels' recording builds (LIGHTPLANE_RELU_MASKS=1)
// write the relu branches their recomputed forward took (record_mask).
//
// The two tensor-core forms keep their sums in different rows, so each has
// its own reduce: R2's pads every layer to 32 x 32 with a bias row per warp
// (kTcLayer floats a layer, read by reduce_mlp_grad_kernel<32, true>);
// S2's holds each layer at its own M- and N-tiles (splatter_bw.cu's
// MlpLayout, read by its reduce_partial_kernel).  They stay apart until
// R2's redesign moves R2 onto MlpLayout and tc_weight_grad_rows; then
// tc_weight_grad, tc_bias_grad and the padded reduce go (ROADMAP.md,
// queue 2).

#pragma once

#include "march_common.cuh"

#ifndef LIGHTPLANE_RELU_MASKS
#define LIGHTPLANE_RELU_MASKS 0
#endif

namespace lightplane {

constexpr bool kReluMasks = LIGHTPLANE_RELU_MASKS != 0;

// The recording build: bit c of word w of relu'd vector k of (ray, step s)
// is v[32 w + c] > 0, the branch the recomputed forward took.  The masks
// are [R, tot, p.n_mask_vecs, W / 32] words.  v is the vector's W values
// in registers (R2) or a row of a tile in shared memory (S2).
template <int W, class V>
__device__ __forceinline__ void record_mask(const Params& p, int ray, int s,
                                            int tot, int k, const V& v) {
  uint32_t* dst = p.relu_masks +
                  (((long long)ray * tot + s) * p.n_mask_vecs + k) * (W / 32);
#pragma unroll
  for (int w = 0; w < W / 32; ++w) {
    uint32_t m = 0;
#pragma unroll
    for (int c = 0; c < 32; ++c) m |= (v[32 * w + c] > 0.0f ? 1u : 0u) << c;
    dst[w] = m;
  }
}

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
// added to it when given) is [W][xstride]; G is [W][rays + 4], a stride
// that keeps a quarter-warp's float4 loads on distinct banks.
template <int W>
__device__ __forceinline__ void weight_grad(float* __restrict__ part,
                                            const float* X, const float* X2,
                                            const float* G, int xstride,
                                            int rays, int tid) {
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
          float4 x =
              *reinterpret_cast<const float4*>(X + (i0 + k) * xstride + r);
          if (X2 != nullptr) {
            const float4 x2 =
                *reinterpret_cast<const float4*>(X2 + (i0 + k) * xstride + r);
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

// ---- the weight gradient on the tensor cores, W = 32 -------------------
// A layer's padded 32 x 32 gradient X^T G is eight 16 x 8 tiles (two along
// the input channel i, four along the output o) of mma.sync m16n8k8
// accumulators.  The block keeps them, per layer, as [tile][lane][4] floats
// in the register order of PTX's accumulator fragment, followed by one row
// of 32 bias sums per warp: kTcLayer floats.

constexpr int kTcWarps = 4;                        // warps of a 128-ray block
constexpr int kTcLayer = 32 * 32 + kTcWarps * 32;  // tiles, per-warp biases

// Where weight (i, o) of a layer lies in its tiles, n_tiles of them along
// o (4 for R2's padded 32 x 32 layer): tile n_tiles * (i / 16) + o / 8;
// lane 4 * (i % 8) + (o % 8) / 2; register 2 * (i % 16 / 8) + o % 2.
__host__ __device__ __forceinline__ int tc_index(int i, int o,
                                                 int n_tiles = 4) {
  const int tile = (i >> 4) * n_tiles + (o >> 3);
  const int lane = (i & 7) * 4 + ((o & 7) >> 1);
  const int reg = ((i >> 3) & 1) * 2 + (o & 1);
  return (tile * 32 + lane) * 4 + reg;
}

// acc += X^T G over the block's `rays` rays for one layer (acc: its
// kTcLayer floats), by the warp `warp` of lane `lane`.  X (plus X2 when
// given) is [32][stride] and G [32][stride] in shared memory, ray-major, so
// both are K-major for the product; stride = rays + 4 puts the eight rows
// of a fragment load on banks 4 apart, and with the four columns a warp's
// 32 loads hit 32 banks.  The eight tiles go as four pairs that share their
// X fragment (tiles 4 * mt + nt, nt + 1), pair k to warp k % warps; each
// k-step of 8 rays splits both operands into TF32 hi and lo parts and
// issues three MMAs per tile, the small terms first.
__device__ __forceinline__ void tc_weight_grad(float* acc, const float* X,
                                               const float* X2,
                                               const float* G, int stride,
                                               int rays, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int pair = warp; pair < 4; pair += rays >> 5) {
    const int mt = pair >> 1, nt = (pair & 1) * 2;
    float4* c = reinterpret_cast<float4*>(acc) + (mt * 4 + nt) * 32 + lane;
    const float4 c0 = c[0], c1 = c[32];
    float d[2][4] = {{c0.x, c0.y, c0.z, c0.w}, {c1.x, c1.y, c1.z, c1.w}};
    const int xo = (mt * 16 + g) * stride + t;  // a0's element (row g, col t)
    const int go = (nt * 8 + g) * stride + t;   // b0's element (row t, col g)
#pragma unroll 2
    for (int k = 0; k < rays; k += 8) {
      // a0: (g, t); a1: (g + 8, t); a2: (g, t + 4); a3: (g + 8, t + 4)
      const int ia[4] = {xo + k, xo + 8 * stride + k, xo + k + 4,
                         xo + 8 * stride + k + 4};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_tf32(X2 != nullptr ? X[ia[j]] + X2[ia[j]] : X[ia[j]], ah[j],
                   al[j]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        // b0: (t, g); b1: (t + 4, g) of the K x N operand G^T
        const float* gp = G + go + n * 8 * stride + k;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(gp[0], bh0, bl0);
        split_tf32(gp[4], bh1, bl1);
        mma_tf32(d[n], al, bh0, bh1);
        mma_tf32(d[n], ah, bl0, bl1);
        mma_tf32(d[n], ah, bh0, bh1);
      }
    }
    c[0] = make_float4(d[0][0], d[0][1], d[0][2], d[0][3]);
    c[32] = make_float4(d[1][0], d[1][1], d[1][2], d[1][3]);
  }
}

// acc += X^T G over a chunk's 32 samples (splatter_bw.cu, S2): X and G
// are [32][W + 4] tiles in shared memory, sample-major (row j = sample j,
// as warp_chunk.cuh's mma_rows writes them), so both operands are read
// transposed against tc_weight_grad's.  The layer's gradient is mi M-tiles
// of 16 inputs by no N-tiles of 8 outputs, kept in acc as [tile][lane][4]
// accumulator fragments (tc_index(i, o, no)), each lane its own four
// floats of every tile: one warp's sums, read and written by it alone.
// Per M-tile the no accumulators start at 0 and stay in registers over the
// 4 k-steps of 8 samples, then are added to the sums in f32: the tensor
// cores' f32 accumulation does not round to nearest, so a running sum kept
// as their C operand would drift by ~2^-23 of itself at every MMA.  Each
// k-step splits both operands into TF32 hi and lo parts and issues three
// MMAs per tile, the small terms first, term by term across the tiles.
template <int W>
__device__ __forceinline__ void tc_weight_grad_rows(float* acc, const float* X,
                                                    const float* G, int mi,
                                                    int no, int lane) {
  constexpr int S = W + 4, NT = W / 8;
  const int g = lane >> 2, t = lane & 3;
  for (int mt = 0; mt < mi; ++mt) {
    float4* c = reinterpret_cast<float4*>(acc) + mt * no * 32 + lane;
    float d[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[nt][e] = 0.0f;
#pragma unroll 1
    for (int ks = 0; ks < 4; ++ks) {
      // A = X^T: a0 (i g, sample t), a1 (g + 8, t), a2 (g, t + 4),
      // a3 (g + 8, t + 4)
      const float* a = X + (ks * 8 + t) * S + mt * 16 + g;
      uint32_t ah[4], al[4];
      split_tf32(a[0], ah[0], al[0]);
      split_tf32(a[8], ah[1], al[1]);
      split_tf32(a[4 * S], ah[2], al[2]);
      split_tf32(a[4 * S + 8], ah[3], al[3]);
      // B = G: b0 (sample t, o g), b1 (t + 4, g); a tile's three products
      // depend on each other, so they go as three sweeps over the tiles
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= no) continue;
        const float* b = G + (ks * 8 + t) * S + nt * 8 + g;
        split_tf32(b[0], bh[nt][0], bl[nt][0]);
        split_tf32(b[4 * S], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= no) continue;
          if (term == 0) mma_tf32(d[nt], al, bh[nt][0], bh[nt][1]);
          if (term == 1) mma_tf32(d[nt], ah, bl[nt][0], bl[nt][1]);
          if (term == 2) mma_tf32(d[nt], ah, bh[nt][0], bh[nt][1]);
        }
    }
    // the sums' loads stay behind the MMAs: hoisted above them, they would
    // hold 4 no more registers through the loop
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= no) continue;
      float4 v = c[nt * 32];
      v.x += d[nt][0];
      v.y += d[nt][1];
      v.z += d[nt][2];
      v.w += d[nt][3];
      c[nt * 32] = v;
    }
  }
}

// One stage of the butterfly below: a lane with bit kHalf set keeps the
// upper half of v[0, 2 kHalf) and sends the lower half to its partner, and
// both add what they get into v[0, kHalf).
template <int kHalf>
__device__ __forceinline__ void butterfly_stage(float (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = upper ? v[j] : v[j + kHalf];
    const float keep = upper ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// acc[32 * 32 + 32 * warp + lane] += the sum of v[lane] over the warp's 32
// lanes: a halving butterfly (31 shuffles) that leaves lane o the sum of
// entry o.  v is consumed.
__device__ __forceinline__ void tc_bias_grad(float* acc, float (&v)[32],
                                             int warp, int lane) {
  butterfly_stage<16>(v, lane);
  butterfly_stage<8>(v, lane);
  butterfly_stage<4>(v, lane);
  butterfly_stage<2>(v, lane);
  butterfly_stage<1>(v, lane);
  acc[32 * 32 + 32 * warp + lane] += v[0];
}

// g_mlp[k] = the sum over blocks of the partial entry of flat index k: in
// the padded [W*W + W] layer (kTc false) or in the tensor cores' tiles and
// per-warp bias rows (kTc, W = 32).
template <int W, bool kTc>
__global__ void reduce_mlp_grad_kernel(const Params p, int n_blocks) {
  constexpr int kLayer = kTc ? kTcLayer : W * W + W;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.n_params) return;
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  int entry = 0, n_sums = 1, step = 0;
  for (int L = 0; L < n_total; ++L) {
    const int d_in = p.layer_in[L], d_out = p.layer_out[L];
    const int w_off = p.layer_w_off[L], b_off = p.layer_b_off[L];
    if (k >= w_off && k < w_off + d_in * d_out) {
      const int i = (k - w_off) / d_out, o = (k - w_off) % d_out;
      entry = L * kLayer + (kTc ? tc_index(i, o) : i * W + o);
      break;
    }
    if (k >= b_off && k < b_off + d_out) {
      entry = L * kLayer + W * W + (k - b_off);
      if (kTc) {  // one bias row per warp
        n_sums = kTcWarps;
        step = 32;
      }
      break;
    }
  }
  const long long stride = (long long)n_total * kLayer;
  float acc = 0.0f;
  for (int b = 0; b < n_blocks; ++b)
    for (int w = 0; w < n_sums; ++w)
      acc += p.g_mlp_partial[b * stride + entry + w * step];
  p.g_mlp[k] = acc;
}

}  // namespace lightplane
