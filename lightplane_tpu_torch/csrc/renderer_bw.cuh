// R2's kernel at W = 32 and 64 (renderer_bw.cu has its design), its
// shared-memory plan and its launch: built at W = 32 by renderer_bw.cu,
// which holds R2's C entry points, and at W = 64 by renderer_bw_64.cu (one
// nvcc each, started together).

#pragma once

#include "wide_mlp.cuh"

namespace {

using namespace lightplane;

constexpr int kMaxRays = 128;  // rays (= threads) per block, at most
constexpr long long kMaxSmemBytes = 232448;  // a Hopper block's 227 KB

// Floats of a block's row of g_mlp_partial per layer.
long long partial_layer_floats(int W) {
  return W == 32 ? kTcLayer : (long long)W * W + W;
}

long long bw_smem_floats(int W, int rays, int n_total, int color_chn,
                         bool color_grid, bool acc_in_smem) {
  // the layer inputs, + relu of the colour grid sample
  const long long n_slots = n_total - 1 + (color_grid ? 1 : 0);
  const long long stride = rays + 4;
  return (long long)n_total * (W * W + W)                // padded layers
         + (n_slots + 2) * W * stride                    // inputs, enc, g_enc
         + (long long)((color_chn + 3) / 4 * 4) * rays   // feature cotangent
         + (long long)W * stride                         // one layer's G
         + (acc_in_smem ? n_total * partial_layer_floats(W) : 0);  // sums
}

// Whether a block keeps its weight-gradient sums in shared memory: on the
// tensor-core path (W = 32), wherever they fit.
bool acc_fits(int W, int rays, int n_total, int color_chn, bool color_grid) {
  return W == 32 && 4 * bw_smem_floats(W, rays, n_total, color_chn,
                                       color_grid, true) <= kMaxSmemBytes;
}

// Adds corner_weight * g[0:C) into every in-bounds corner row of the
// [V_total, C] grid-list gradient (m, dst) at the point of `st`, batch b:
// one float4 reduction per 4 channels (sm_90) when C % 4 == 0.
template <int W>
__device__ __forceinline__ void splat_grad(const GridMeta& m, float* dst,
                                           int C, int b, const Step& st,
                                           const float (&g)[W]) {
  const bool vec4 = float4_atomics(C);
  for_each_corner(m, b, st, [&](long long row, float wgt) {
    float* d = dst + row * C;
    if (vec4) {
#pragma unroll
      for (int c4 = 0; c4 < W / 4; ++c4)
        if (4 * c4 < C)
          atomicAdd(reinterpret_cast<float4*>(d) + c4,
                    make_float4(wgt * g[4 * c4], wgt * g[4 * c4 + 1],
                                wgt * g[4 * c4 + 2], wgt * g[4 * c4 + 3]));
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c < C) atomicAdd(d + c, wgt * g[c]);
    }
  });
}

template <int W>
__global__ void __launch_bounds__(kMaxRays) render_bw_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLayer = W * W + W;
  // the weight gradient on the tensor cores at W = 32 (mlp_bwd.cuh)
  constexpr bool kTc = W == 32;
  constexpr int kPartLayer = kTc ? kTcLayer : kLayer;
  const int rays = blockDim.x;
  const int stride = rays + 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_t = p.n_layers[0], n_o = p.n_layers[1], n_c = p.n_layers[2];
  const int n_total = n_t + n_o + n_c;
  const bool cgrid = p.color_grid != nullptr;
  // the layer inputs, then relu of the colour grid sample (slot cslot)
  const int n_slots = n_total - 1 + (cgrid ? 1 : 0);
  float* s_act = smem + n_total * kLayer;        // [n_slots][W][stride]
  float* s_enc = s_act + n_slots * W * stride;   // [W][stride]
  float* s_genc = s_enc + W * stride;            // [W][stride]
  float* s_gfeat = s_genc + W * stride;          // [color_chn][rays]
  float* s_G = s_gfeat + (p.color_chn + 3) / 4 * 4 * rays;  // [W][stride]
  float* part =
      p.g_mlp_partial + (long long)blockIdx.x * n_total * kPartLayer;
  // the weight-gradient sums: in shared memory after s_G, or the row itself
  float* acc = p.acc_in_smem ? s_G + W * stride : part;

  stage_layers<W>(p, smem, n_total);
  if (kTc) {
    for (int k = tid; k < n_total * kPartLayer; k += rays) acc[k] = 0.0f;
  } else {
    zero_owned_partial<W>(part, n_total, rays, tid);
  }

  // threads past the last ray march a copy of it with zero cotangents, so
  // every gradient they add to the block's sums is 0
  const int ray_in = blockIdx.x * rays + tid;
  const bool valid = ray_in < p.num_rays;
  const int ray = valid ? ray_in : p.num_rays - 1;
  const Ray r = load_ray(p, ray);
  for (int c = 0; c < W; ++c) {
    s_enc[c * stride + tid] =
        c < p.enc_chn ? p.enc[(long long)ray * p.enc_chn + c] : 0.0f;
    s_genc[c * stride + tid] = 0.0f;
  }
  for (int c = 0; c < p.color_chn; ++c)
    s_gfeat[c * rays + tid] =
        valid ? p.g_feat[(long long)ray * p.color_chn + c] : 0.0f;
  const float g_depth = valid ? p.g_depth[ray] : 0.0f;
  const float g_nlt = valid ? p.g_nlt[ray] : 0.0f;
  __syncthreads();

  // Layers in shared memory: trunk [0, n_t), opacity [n_t, n_t + n_o),
  // color [n_t + n_o, n_total).  Slot k of s_act holds the input of relu
  // layer k of the forward loop below (slot 0: the feature, or relu of it
  // with no trunk); layer L reads slot L, except the colour head, whose
  // first layer reads slot n_t (+ the encoding) and the others slot L - 1.
  // With a colour grid the colour head's first layer reads slot cslot (+
  // the encoding), relu of the colour grid sample.  Every slot but the raw
  // feature's is a relu'd vector; the recording build numbers them from 0
  // in slot order (mask vector = slot - 1 with a trunk).
  const int opacity_first = n_t, color_first = n_t + n_o;
  const int cslot = cgrid ? n_total - 1 : n_t;
  const int opacity_end = n_t + n_o - 1;
  const int n_relu_layers = n_total - 2;
  const int mask0 = n_t > 0 ? 1 : 0;
  const float* opacity_last = smem + opacity_end * kLayer;
  const float* color_last = smem + (n_total - 1) * kLayer;
  const int tot = p.num_samples + p.num_samples_inf;
  const bool record = kReluMasks && valid;
#define ACT(k, c) s_act[((k) * W + (c)) * stride + tid]

  float nlt_run = p.nlt_final[ray], suffix = 0.0f;
  float x[W], y[W];
  for (int s = tot - 1; s >= 0; --s) {
    const Step st = march_step(p, r, s);
    // a step that no ray of the block passes is skipped by the whole block
    // (every thread reaches the barriers below, or none does)
    const float gate = scaffold_gate(p, r.b, st);
    if (p.scaffold != nullptr && !__syncthreads_or(gate != 0.0f)) continue;

    // ---- forward recompute, keeping every layer's input ----
    // (a gated ray samples nothing: its zero gate zeroes every cotangent)
#pragma unroll
    for (int c = 0; c < W; ++c) x[c] = 0.0f;
    const bool sampled =
        gate != 0.0f && (!p.mask_out_of_bounds || st.in_bounds);
    if (sampled) sample_grids<W>(p, r.b, st, x);
    if (n_t == 0) {
#pragma unroll
      for (int c = 0; c < W; ++c) x[c] = fmaxf(x[c], 0.0f);
      if (record) record_mask<W>(p, ray, s, tot, 0, x);
    }
#pragma unroll
    for (int c = 0; c < W; ++c) ACT(0, c) = x[c];
    if (cgrid) {
#pragma unroll
      for (int c = 0; c < W; ++c) y[c] = 0.0f;
      if (sampled)
        sample_grids<W>(p.cgrids, p.color_grid, p.grid_chn, r.b, st, y);
#pragma unroll
      for (int c = 0; c < W; ++c) {
        y[c] = fmaxf(y[c], 0.0f);
        ACT(cslot, c) = y[c];
      }
      if (record) record_mask<W>(p, ray, s, tot, cslot - mask0, y);
    }
    float opacity_raw = 0.0f;
    for (int j = 0;; ++j) {
      if (j == opacity_end) {
        opacity_raw = dense_out<W>(opacity_last, x, 0);
#pragma unroll
        for (int c = 0; c < W; ++c)
          x[c] = ACT(cslot, c) + s_enc[c * stride + tid];
      }
      if (j == n_relu_layers) break;
      const int layer = j < opacity_end ? j : j + 1;
      dense_relu<W>(smem + layer * kLayer, x, y);
#pragma unroll
      for (int c = 0; c < W; ++c) {
        x[c] = y[c];
        ACT(j + 1, c) = y[c];
      }
      if (record) record_mask<W>(p, ray, s, tot, j + 1 - mask0, y);
    }
    if (p.noise_sigma > 0.0f) opacity_raw += step_noise(p, ray, s);
    const float sigma = p.gain * softplus(opacity_raw) * gate;
    // the colours (before the gate) wait in this thread's column of s_G for
    // the EA adjoint (every read of s_G by the last step's weight gradient
    // is behind a barrier)
    float g_feat_dot_color = 0.0f;
    for (int c = 0; c < p.color_chn; ++c) {
      const float col = sigmoid(dense_out<W>(color_last, x, c));
      s_G[c * stride + tid] = col;
      g_feat_dot_color += s_gfeat[c * rays + tid] * (col * gate);
    }

    // ---- transmittance rewind + EA adjoint ----
    const float nlt_prev = nlt_run - sigma * st.delta;
    const float T = expf(-nlt_run);         // T_s (includes step s)
    const float w = expf(-nlt_prev) - T;    // T_{s-1} - T_s
    const float g_w = g_depth * st.t + g_feat_dot_color;
    const float g_sigma = (g_w * T - suffix + g_nlt) * st.delta;
    suffix += g_w * w;
    nlt_run = nlt_prev;
    const float g_opacity = g_sigma * p.gain * sigmoid(opacity_raw) * gate;

    // ---- decoder backward, last layer first ----
    // G: gradient of the current layer's output (before its relu);
    // g_trunk: the colour head's input gradient (with a colour grid, the
    // gradient of its sample, through its relu)
    float G[W], g_trunk[W], g_in[W];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      float g = 0.0f;
      if (c < p.color_chn) {
        const float col = s_G[c * stride + tid];
        g = w * s_gfeat[c * rays + tid] * gate * col * (1.0f - col);
      }
      G[c] = g;
    }
    for (int L = n_total - 1;; --L) {
#pragma unroll
      for (int o = 0; o < W; ++o) s_G[o * stride + tid] = G[o];
      __syncthreads();
      const float* X = s_act + (L == color_first  ? cslot
                                : L > color_first ? L - 1
                                                  : L) * W * stride;
      const float* X2 = L == color_first ? s_enc : nullptr;
      const bool wgrad = part_runs(kAblateNoWeightGrad, X[tid]);
      if (wgrad) {
        if constexpr (kTc)
          tc_weight_grad(acc + L * kPartLayer, X, X2, s_G, stride, rays,
                         warp, lane);
        else
          weight_grad<W>(part + L * kLayer, X, X2, s_G, stride, rays, tid);
      }
      __syncthreads();
      dense_bwd<W>(smem + L * kLayer, G, g_in);
      if constexpr (kTc) {
        // the bias sums of the warp's rays (G is dead past dense_bwd)
        if (wgrad) tc_bias_grad(acc + L * kPartLayer, G, warp, lane);
      }
      if (L == color_first) {
        // the colour head's input is trunk + encoding
#pragma unroll
        for (int c = 0; c < W; ++c) {
          s_genc[c * stride + tid] += g_in[c];
          g_trunk[c] = !cgrid || ACT(cslot, c) > 0.0f ? g_in[c] : 0.0f;
          G[c] = c == 0 ? g_opacity : 0.0f;
        }
      } else if (L == opacity_first) {
        // the trunk output went through a relu (relu of the feature with
        // no trunk MLP); with a colour grid only the opacity head reads it
#pragma unroll
        for (int c = 0; c < W; ++c)
          G[c] = ACT(n_t, c) > 0.0f ? (cgrid ? 0.0f : g_trunk[c]) + g_in[c]
                                    : 0.0f;
        if (n_t == 0) break;  // G is the feature gradient
      } else if (L == 0) {
#pragma unroll
        for (int c = 0; c < W; ++c) G[c] = g_in[c];  // the feature gradient
        break;
      } else {
        // the layer's input is the relu output of the layer before it
        const int in_slot = L > color_first ? L - 1 : L;
#pragma unroll
        for (int c = 0; c < W; ++c)
          G[c] = ACT(in_slot, c) > 0.0f ? g_in[c] : 0.0f;
      }
    }

    // ---- grid-gradient splats ----
    if (valid && sampled && part_runs(kAblateNoAtomics, G[0])) {
      splat_grad<W>(p.grids, p.g_grid, p.grid_chn, r.b, st, G);
      if (cgrid)
        splat_grad<W>(p.cgrids, p.g_color_grid, p.grid_chn, r.b, st,
                      g_trunk);
    }
  }
#undef ACT

  if (valid)
    for (int c = 0; c < p.enc_chn; ++c)
      p.g_enc[(long long)ray * p.enc_chn + c] = s_genc[c * stride + tid];

  // the block's weight-gradient sums, kept in shared memory, go to its row
  // once
  if (kTc && p.acc_in_smem) {
    __syncthreads();
    const float4* src = reinterpret_cast<const float4*>(acc);
    float4* dst = reinterpret_cast<float4*>(part);
    for (int k = tid; k < n_total * kPartLayer / 4; k += rays) dst[k] = src[k];
  }
}

template <int W>
cudaError_t launch(const Params& p, int rays, size_t smem_bytes,
                   cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        render_bw_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (p.num_rays + rays - 1) / rays;
  if (blocks > 0) {
    render_bw_kernel<W><<<blocks, rays, smem_bytes, stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  reduce_mlp_grad_kernel<W, W == 32>
      <<<(p.n_params + 255) / 256, 256, 0, stream>>>(p, blocks);
  return cudaGetLastError();
}

}  // namespace

namespace lightplane {

// R2 at W = 64 (renderer_bw_64.cu): its launch, and its kernel's registers,
// spilled bytes and thread limit into out[3].
cudaError_t launch_render_bw_64(const Params& p, int rays, size_t smem_bytes,
                                cudaStream_t stream);
int render_bw_attrs_64(int* out);

}  // namespace lightplane
