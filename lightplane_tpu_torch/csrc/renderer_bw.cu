// Recompute backward of the fused Emission-Absorption march of the
// Lightplane renderer, for Hopper (sm_90a).
//
// Replaces lightplane_tpu/ops/kernels/renderer_pallas.py::_build_bw_kernel
// (launched by pallas_render_bwd).  From the forward's final negative log
// transmittance it walks every ray's steps far to near: per step it
// recomputes the point, the grid-list sample and the decoder (keeping each
// layer's input), rewinds the transmittance (nlt_prev = nlt - sigma*delta),
// forms the EA adjoint with a running suffix sum exactly as the JAX scan
// core's _render_bwd writes it, and runs the decoder backward.  Nothing of
// size R x S is stored: memory is O(R) whatever the number of samples.
//
// Design.  One thread per ray, `rays` (128, 64 or 32) rays per block; the
// MLP layers are staged in shared memory as zero-padded W x W tiles (W = 32
// or 64, a template parameter) as in renderer_fw.cu.  Every layer input of
// the current step lives in shared memory, transposed ([slot][channel][ray])
// so that a warp's per-ray accesses hit distinct banks.  The three gradient
// outputs take three reductions:
//   - g_rays_encoding [R, C_enc]: per ray; the thread sums the colour head's
//     input gradient over its steps in shared memory and writes it once.
//   - g_mlp_params: a sum over every ray-sample of outer products X_l^T G_l.
//     After each layer's per-ray backward the block writes G_l to shared
//     memory and forms X_l^T G_l cooperatively: each thread owns W*W/rays
//     entries of the layer's padded gradient and the biases' column sums,
//     accumulated in its block's row of a [blocks, layers * (W*W + W)]
//     buffer that only it touches.  A second kernel sums the rows into the
//     flat, unpadded g_mlp.  (This is the GPU form of the TPU kernel's
//     `ref[...] += g` across sequential grid steps: GPU blocks run in
//     parallel, so that carry does not exist.)
//   - g_grid [V, C]: atomicAdd of corner_weight * g_feature into the corner
//     rows in device memory, one float4 reduction per 4 channels (sm_90);
//     the caller zero-fills it.
//
// What bounds it.  At the slice config (triplane 3 x 32^2 x 32ch, MLPs 2/2/2
// with hidden 32, 256 samples, 65,536 rays) the recomputed forward, the
// input-gradient pass and the weight-gradient pass are each ~8.4k FLOP per
// ray-sample of FP32 CUDA-core work, ~0.45 TFLOP per step in all, ~6.7 ms at
// the 67 TFLOP/s FP32 peak.  On top come 65,536 x 256 x 12 corner rows x 32
// channels = 6.4e9 float reductions into a 98k-row grid that neighbouring
// rays hit together.  Timed with parts switched off on an H100 (700 W,
// `chip_smoke.py --ablate`): 90.2 ms as built; 180.1 ms with one scalar
// atomicAdd per channel, so scalar reductions cost ~104 ms; 76.6 ms with no
// grid reductions; 53.1 ms with no weight-gradient pass.  The float4
// reductions (below) cut the reductions to ~14 ms, and the weight-gradient
// pass, ~37 ms, now bounds the kernel: 2 block barriers and a 128-ray outer
// product per layer per step, at one 128-ray block per SM (the per-ray layer
// inputs take ~1 KB of shared memory).  The recomputed forward and the
// input-gradient pass take the rest, at a third of R1's occupancy.  Keeping
// partial outer products in registers across steps, a smaller per-ray
// footprint and warp-aggregated grid reductions are later work.
//
// The timings with parts switched off build it with march_common.cuh's
// LIGHTPLANE_ABLATE: 1 = one scalar atomicAdd per grid channel, 2 = no
// grid-gradient reductions, 4 = no MLP weight-gradient pass.
//
// Numerics: f32 throughout, IEEE transcendentals (no --use_fast_math).  The
// grid gradient's atomics make its sums order-dependent from run to run.

#include "march_common.cuh"
#include "mlp_bwd.cuh"

namespace {

using namespace lightplane;

constexpr int kMaxRays = 128;  // rays (= threads) per block, at most

long long bw_smem_floats(int W, int rays, int n_total, int color_chn) {
  const long long n_slots = n_total - 1;
  return (long long)n_total * (W * W + W)          // padded layers
         + (n_slots + 2) * W * rays                // layer inputs, enc, g_enc
         + (long long)((color_chn + 3) / 4 * 4) * rays  // feature cotangent
         + (long long)W * (rays + 4);              // one layer's G
}

template <int W>
__global__ void __launch_bounds__(kMaxRays) render_bw_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLayer = W * W + W;
  const int rays = blockDim.x;
  const int tid = threadIdx.x;
  const int n_t = p.n_layers[0], n_o = p.n_layers[1], n_c = p.n_layers[2];
  const int n_total = n_t + n_o + n_c;
  const int n_slots = n_total - 1;
  float* s_act = smem + n_total * kLayer;        // [n_slots][W][rays]
  float* s_enc = s_act + n_slots * W * rays;     // [W][rays]
  float* s_genc = s_enc + W * rays;              // [W][rays]
  float* s_gfeat = s_genc + W * rays;            // [color_chn][rays]
  float* s_G = s_gfeat + (p.color_chn + 3) / 4 * 4 * rays;  // [W][rays + 4]
  const int gstride = rays + 4;
  float* part =
      p.g_mlp_partial + (long long)blockIdx.x * n_total * kLayer;

  stage_layers<W>(p, smem, n_total);
  zero_owned_partial<W>(part, n_total, rays, tid);

  // threads past the last ray march a copy of it with zero cotangents, so
  // every gradient they add to the block's sums is 0
  const int ray_in = blockIdx.x * rays + tid;
  const bool valid = ray_in < p.num_rays;
  const int ray = valid ? ray_in : p.num_rays - 1;
  const Ray r = load_ray(p, ray);
  for (int c = 0; c < W; ++c) {
    s_enc[c * rays + tid] =
        c < p.enc_chn ? p.enc[(long long)ray * p.enc_chn + c] : 0.0f;
    s_genc[c * rays + tid] = 0.0f;
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
  const int opacity_first = n_t, color_first = n_t + n_o;
  const int opacity_end = n_t + n_o - 1;
  const int n_relu_layers = n_total - 2;
  const float* opacity_last = smem + opacity_end * kLayer;
  const float* color_last = smem + (n_total - 1) * kLayer;
  const int tot = p.num_samples + p.num_samples_inf;
#define ACT(k, c) s_act[((k) * W + (c)) * rays + tid]

  float nlt_run = p.nlt_final[ray], suffix = 0.0f;
  float x[W], y[W];
  for (int s = tot - 1; s >= 0; --s) {
    const Step st = march_step(p, r, s);

    // ---- forward recompute, keeping every layer's input ----
#pragma unroll
    for (int c = 0; c < W; ++c) x[c] = 0.0f;
    const bool sampled = !p.mask_out_of_bounds || st.in_bounds;
    if (sampled) sample_grids<W>(p, r.b, st, x);
    if (n_t == 0) {
#pragma unroll
      for (int c = 0; c < W; ++c) x[c] = fmaxf(x[c], 0.0f);
    }
#pragma unroll
    for (int c = 0; c < W; ++c) ACT(0, c) = x[c];
    float opacity_raw = 0.0f;
    for (int j = 0;; ++j) {
      if (j == opacity_end) {
        opacity_raw = dense_out<W>(opacity_last, x, 0);
#pragma unroll
        for (int c = 0; c < W; ++c) x[c] = ACT(n_t, c) + s_enc[c * rays + tid];
      }
      if (j == n_relu_layers) break;
      const int layer = j < opacity_end ? j : j + 1;
      dense_relu<W>(smem + layer * kLayer, x, y);
#pragma unroll
      for (int c = 0; c < W; ++c) {
        x[c] = y[c];
        ACT(j + 1, c) = y[c];
      }
    }
    if (p.noise_sigma > 0.0f) opacity_raw += step_noise(p, ray, s);
    const float sigma = p.gain * softplus(opacity_raw);
    // the colours wait in this thread's column of s_G for the EA adjoint
    // (every read of s_G by the last step's weight_grad is behind a barrier)
    float g_feat_dot_color = 0.0f;
    for (int c = 0; c < p.color_chn; ++c) {
      const float col = sigmoid(dense_out<W>(color_last, x, c));
      s_G[c * gstride + tid] = col;
      g_feat_dot_color += s_gfeat[c * rays + tid] * col;
    }

    // ---- transmittance rewind + EA adjoint ----
    const float nlt_prev = nlt_run - sigma * st.delta;
    const float T = expf(-nlt_run);         // T_s (includes step s)
    const float w = expf(-nlt_prev) - T;    // T_{s-1} - T_s
    const float g_w = g_depth * st.t + g_feat_dot_color;
    const float g_sigma = (g_w * T - suffix + g_nlt) * st.delta;
    suffix += g_w * w;
    nlt_run = nlt_prev;
    const float g_opacity = g_sigma * p.gain * sigmoid(opacity_raw);

    // ---- decoder backward, last layer first ----
    // G: gradient of the current layer's output (before its relu)
    float G[W], g_trunk[W], g_in[W];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      float g = 0.0f;
      if (c < p.color_chn) {
        const float col = s_G[c * gstride + tid];
        g = w * s_gfeat[c * rays + tid] * col * (1.0f - col);
      }
      G[c] = g;
    }
    for (int L = n_total - 1;; --L) {
#pragma unroll
      for (int o = 0; o < W; ++o) s_G[o * gstride + tid] = G[o];
      __syncthreads();
      const float* X = s_act + (L == color_first  ? n_t
                                : L > color_first ? L - 1
                                                  : L) * W * rays;
      if (part_runs(kAblateNoWeightGrad, X[tid]))
        weight_grad<W>(part + L * kLayer, X,
                       L == color_first ? s_enc : nullptr, s_G, rays, tid);
      __syncthreads();
      dense_bwd<W>(smem + L * kLayer, G, g_in);
      if (L == color_first) {
        // the colour head's input is trunk + encoding
#pragma unroll
        for (int c = 0; c < W; ++c) {
          s_genc[c * rays + tid] += g_in[c];
          g_trunk[c] = g_in[c];
          G[c] = c == 0 ? g_opacity : 0.0f;
        }
      } else if (L == opacity_first) {
        // the trunk output went through a relu (relu of the feature with
        // no trunk MLP)
#pragma unroll
        for (int c = 0; c < W; ++c)
          G[c] = ACT(n_t, c) > 0.0f ? g_trunk[c] + g_in[c] : 0.0f;
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

    // ---- grid-gradient splat ----
    // (sm_90's float4 atomicAdd: one 16-byte reduction per 4 channels)
    if (valid && sampled && part_runs(kAblateNoAtomics, G[0])) {
      const int C = p.grid_chn;
      const bool vec4 = float4_atomics(C);
      for_each_corner(p, r.b, st, [&](long long row, float wgt) {
        float* dst = p.g_grid + row * C;
        if (vec4) {
#pragma unroll
          for (int c4 = 0; c4 < W / 4; ++c4)
            if (4 * c4 < C)
              atomicAdd(reinterpret_cast<float4*>(dst) + c4,
                        make_float4(wgt * G[4 * c4], wgt * G[4 * c4 + 1],
                                    wgt * G[4 * c4 + 2], wgt * G[4 * c4 + 3]));
        } else {
#pragma unroll
          for (int c = 0; c < W; ++c)
            if (c < C) atomicAdd(dst + c, wgt * G[c]);
        }
      });
    }
  }
#undef ACT

  if (valid)
    for (int c = 0; c < p.enc_chn; ++c)
      p.g_enc[(long long)ray * p.enc_chn + c] = s_genc[c * rays + tid];
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
  reduce_mlp_grad_kernel<W><<<(p.n_params + 255) / 256, 256, 0, stream>>>(
      p, blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of `rays` rays needs.
long long lightplane_render_bw_smem_bytes(int width, int rays,
                                          int n_layers_total, int color_chn) {
  return 4LL * bw_smem_floats(width, rays, n_layers_total, color_chn);
}

// Launches the recompute backward on `stream`; returns a cudaError_t code.
// Arguments as lightplane_render_fw's, plus the saved nlt_final and the
// cotangents in, the gradients and the [blocks, layers * (W*W + W)] partial
// buffer out, and `rays_per_block` (128, 64 or 32).  The caller validates
// shapes, devices and limits and zero-fills g_grid.
int lightplane_render_bw(
    const float* origins, const float* directions, const float* near,
    const float* far, const int* grid_idx, const float* enc, const float* grid,
    const float* mlp, const float* nlt_final, const float* g_depth,
    const float* g_nlt, const float* g_feat, float* g_grid, float* g_mlp,
    float* g_enc, float* g_mlp_partial, int num_rays, int num_grids,
    const int* grid_meta, int grid_chn, int n_t, int n_o, int n_c,
    const int* mlp_widths, int enc_chn, int color_chn, int width,
    int rays_per_block, int num_samples, int num_samples_inf,
    float disparity_at_inf, float gain, int mask_out_of_bounds,
    int contract_coords, float noise_sigma, int noise_seed, int noise_stride,
    int num_rays_noise, void* stream) {
  if (rays_per_block != 128 && rays_per_block != 64 && rays_per_block != 32)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const int rc = fill_params(
      p, num_rays, num_grids, grid_meta, grid_chn, n_t, n_o, n_c, mlp_widths,
      enc_chn, color_chn, width, num_samples, num_samples_inf,
      disparity_at_inf, gain, mask_out_of_bounds, contract_coords,
      noise_sigma, noise_seed, noise_stride, num_rays_noise);
  if (rc != (int)cudaSuccess) return rc;
  p.origins = origins;
  p.directions = directions;
  p.near = near;
  p.far = far;
  p.grid_idx = grid_idx;
  p.enc = enc;
  p.grid = grid;
  p.mlp = mlp;
  p.nlt_final = nlt_final;
  p.g_depth = g_depth;
  p.g_nlt = g_nlt;
  p.g_feat = g_feat;
  p.g_grid = g_grid;
  p.g_mlp = g_mlp;
  p.g_enc = g_enc;
  p.g_mlp_partial = g_mlp_partial;

  const size_t smem = (size_t)lightplane_render_bw_smem_bytes(
      width, rays_per_block, n_t + n_o + n_c, color_chn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = width == 32 ? launch<32>(p, rays_per_block, smem, s)
                                    : launch<64>(p, rays_per_block, smem, s);
  return (int)e;
}

}  // extern "C"
