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
// the current step lives in shared memory, transposed ([slot][channel][ray],
// ray stride rays + 4) so that a warp's per-ray accesses hit distinct banks
// and a tensor-core fragment load does too (mlp_bwd.cuh::tc_weight_grad).
// The three gradient outputs take three reductions:
//   - g_rays_encoding [R, C_enc]: per ray; the thread sums the colour head's
//     input gradient over its steps in shared memory and writes it once.
//   - g_mlp_params: a sum over every ray-sample of outer products X_l^T G_l.
//     After each layer's per-ray backward the block writes G_l to shared
//     memory ([W][rays + 4]) and, behind a barrier, forms X_l^T G_l over its
//     rays.  At W = 32 that product runs on the tensor cores: mma.sync
//     m16n8k8 in TF32 with the 3xTF32 split (x = hi + lo; hi*hi + hi*lo +
//     lo*hi in f32, so the sum keeps f32 accuracy where one TF32 pass keeps
//     ~3 digits), the layer's 8 tiles of 16 x 8 as 4 pairs over the block's
//     warps; the bias sums are a butterfly over each warp's lanes.  The
//     sums stay in shared memory for the whole march, in the accumulators'
//     fragment order (6 layers: 27.6 KB), and the block writes its row of
//     g_mlp_partial once, after the last step.  (An MLP too deep for that
//     shared memory keeps the sums in the row itself.)  At W = 64 each
//     thread owns W*W/rays entries and adds its sums into the row at every
//     layer of every step, on the CUDA cores.  A second kernel sums the rows
//     into the flat, unpadded g_mlp.  (This is the GPU form of the TPU
//     kernel's `ref[...] += g` across sequential grid steps: GPU blocks run
//     in parallel, so that carry does not exist.)
//   - g_grid [V, C]: atomicAdd of corner_weight * g_feature into the corner
//     rows in device memory, one float4 reduction per 4 channels (sm_90);
//     the caller zero-fills it.
// Two barriers per layer per step remain (G written -> product -> G free).
//
// What bounds it.  At the slice config (triplane 3 x 32^2 x 32ch, MLPs 2/2/2
// with hidden 32, 256 samples, 65,536 rays) the recomputed forward and the
// input-gradient pass are each ~8.4k FLOP per ray-sample of FP32 CUDA-core
// work, ~0.3 TFLOP per step, ~4.5 ms at the 67 TFLOP/s FP32 peak; the
// weight-gradient pass is as many FLOPs again, three times over in 3xTF32,
// ~0.43 TFLOP of TF32 at 495 TFLOP/s, ~0.9 ms.  On top come 65,536 x 256 x
// 12 corner rows x 32 channels = 6.4e9 float reductions into a 98k-row grid
// that neighbouring rays hit together.  Timed with parts switched off on an
// H100 (700 W, `chip_smoke.py --ablate`): 72.1 ms as built, 51.7 ms with no
// grid reductions, 57.0 ms with no weight-gradient pass, 37.3 ms with
// neither.  So the recomputed forward and the input-gradient pass, one
// thread per ray (255 registers, 704 bytes spilled) at one 128-ray block
// per SM, take about half; the grid reductions ~20 ms; the weight-gradient
// pass ~15 ms, most of it the two block barriers per layer per step that
// order it against the per-ray backward, not its ~0.9 ms of tensor-core
// work.
//
// The timings with parts switched off build it with march_common.cuh's
// LIGHTPLANE_ABLATE: 1 = one scalar atomicAdd per grid channel, 2 = no
// grid-gradient reductions, 4 = no MLP weight-gradient pass.
// LIGHTPLANE_RELU_MASKS=1 builds the variant that records, per ray and
// step, one bit per unit of every relu'd vector its recomputed forward took
// (x > 0), so the plain version can be held to it on every ray: a relu
// kink within rounding of 0 can otherwise send the two down different
// branches (renderer_bw.py::render_bwd_cuda_relu_masks).
//
// The two optional branches of renderer_fw.cu, backward:
//   - scaffold gating (R3): the gate multiplies sigma and the colour, so it
//     scales their cotangents; a gated step leaves nlt unchanged, so the
//     rewind stays exact when the step is skipped.  The weight-gradient pass
//     has block barriers inside the step, so a step is skipped only when no
//     ray of the block passes its gate (__syncthreads_or, as splatter_bw.cu
//     skips a step); a gated ray in a running block samples nothing, adds
//     zero to the weight-gradient sums and no grid atomics.  No gradient
//     flows into the scaffold.
//   - the relu-field colour grid (R1-rf): relu(colour grid sample) takes an
//     extra layer-input slot; the colour head's input gradient goes through
//     its relu mask into g_color_grid (float4 atomics, zero-filled by the
//     caller) and the opacity head's through the grid sample's into g_grid.
//
// Numerics: f32 throughout, IEEE transcendentals (no --use_fast_math); the
// weight gradient's products in 3xTF32 with f32 sums.  The grid gradient's
// atomics make its sums order-dependent from run to run; g_mlp and g_enc
// are not.

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

extern "C" {

// Bytes of dynamic shared memory one block of `rays` rays needs (with its
// weight-gradient sums in shared memory wherever they fit).
long long lightplane_render_bw_smem_bytes(int width, int rays,
                                          int n_layers_total, int color_chn,
                                          int has_color_grid) {
  const bool cg = has_color_grid != 0;
  return 4LL * bw_smem_floats(
                   width, rays, n_layers_total, color_chn, cg,
                   acc_fits(width, rays, n_layers_total, color_chn, cg));
}

// Floats of one block's row of the partial buffer.
long long lightplane_render_bw_partial_floats(int width, int n_layers_total) {
  return n_layers_total * partial_layer_floats(width);
}

// Registers, spilled bytes and the thread limit of the kernel at `width`,
// into out[3]; a cudaError_t code.
int lightplane_render_bw_attrs(int width, int* out) {
  if (width > 64) return render_bw_wide_attrs(width, out);
  return width == 32 ? kernel_attrs(render_bw_kernel<32>, out)
                     : kernel_attrs(render_bw_kernel<64>, out);
}

// The wide build's (W = 96 or 128, renderer_wide.cu) launch at these MLP
// widths (mlp_widths: host int[n_t + 1 + n_o + 1 + n_c + 1]) and with a
// colour grid or not: out[0] warps per block, out[1] the rows of
// g_mlp_partial (one per block of the resident wave; the caller zero-fills
// them), out[2] the floats of a row, out[3] a block's shared memory in
// bytes, out[4] the bytes of the workspace lightplane_render_bw takes; a
// cudaError_t code (cudaErrorInvalidValue where one warp's region and the
// ring of layer slices exceed a block's shared memory).
int lightplane_render_bw_wide_config(int width, int n_t, int n_o, int n_c,
                                     const int* mlp_widths,
                                     int has_color_grid, int* out) {
  if (n_o < 1 || n_c < 1 || n_t > kMaxLayers || n_o > kMaxLayers ||
      n_c > kMaxLayers || (width != 96 && width != 128))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const int counts[3] = {n_t, n_o, n_c};
  fill_layers(p, counts, mlp_widths);
  return render_bw_wide_config(p, width, has_color_grid != 0, out);
}

// The wide builds' pre-pass alone, on `stream`: the products of R1's chunk
// (R2's with `backward`) packed from the flat `mlp` into `workspace` (the
// bytes of lightplane_render_fw_wide_config or _bw_wide_config); a
// cudaError_t code.
int lightplane_render_wide_pack(const float* mlp, int n_t, int n_o, int n_c,
                                const int* mlp_widths, int backward,
                                void* workspace, void* stream) {
  if (n_o < 1 || n_c < 1 || n_t > kMaxLayers || n_o > kMaxLayers ||
      n_c > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const int counts[3] = {n_t, n_o, n_c};
  fill_layers(p, counts, mlp_widths);
  p.mlp = mlp;
  return (int)launch_wide_pack(p, backward != 0, workspace,
                               static_cast<cudaStream_t>(stream));
}

// Launches the recompute backward on `stream`; returns a cudaError_t code.
// Arguments as lightplane_render_fw's, plus the saved nlt_final and the
// cotangents in, the gradients and the [blocks, partial floats] buffer out,
// `rays_per_block` (128, 64 or 32; not read by the wide build, whose
// g_mlp_partial has lightplane_render_bw_wide_config's rows, zero-filled),
// with a colour grid its gradient
// g_color_grid, for the recording build the zero-filled
// [R, steps, vectors, width / 32] mask words (null otherwise), and the
// wide build's workspace (lightplane_render_bw_wide_config's bytes, 16-byte
// aligned; null for the others).  The caller
// validates shapes, devices and limits and zero-fills g_grid and
// g_color_grid.
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
    int num_rays_noise, const float* scaffold, const int* scaffold_dims,
    const float* color_grid, int num_color_grids, const int* color_grid_meta,
    float* g_color_grid, uint32_t* relu_masks, void* workspace,
    void* stream) {
  if (rays_per_block != 128 && rays_per_block != 64 && rays_per_block != 32)
    return (int)cudaErrorInvalidValue;
  if ((relu_masks != nullptr) != kReluMasks) return (int)cudaErrorInvalidValue;
  Params p = {};
  int rc = fill_params(
      p, num_rays, num_grids, grid_meta, grid_chn, n_t, n_o, n_c, mlp_widths,
      enc_chn, color_chn, width, num_samples, num_samples_inf,
      disparity_at_inf, gain, mask_out_of_bounds, contract_coords,
      noise_sigma, noise_seed, noise_stride, num_rays_noise);
  if (rc == (int)cudaSuccess)
    rc = fill_render_extras(p, scaffold, scaffold_dims, color_grid,
                            num_color_grids, color_grid_meta);
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
  p.g_color_grid = g_color_grid;
  p.relu_masks = relu_masks;
  const int n_total = n_t + n_o + n_c;
  p.n_mask_vecs = n_total - 2 + (n_t == 0 ? 1 : 0) + (color_grid ? 1 : 0);
  const bool cg = color_grid != nullptr;
  p.acc_in_smem = acc_fits(width, rays_per_block, n_total, color_chn, cg);
  if (width > 64)
    return (int)launch_render_bw_wide(p, width, workspace,
                                      static_cast<cudaStream_t>(stream));

  const size_t smem = (size_t)lightplane_render_bw_smem_bytes(
      width, rays_per_block, n_total, color_chn, cg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = width == 32 ? launch<32>(p, rays_per_block, smem, s)
                                    : launch<64>(p, rays_per_block, smem, s);
  return (int)e;
}

}  // extern "C"
