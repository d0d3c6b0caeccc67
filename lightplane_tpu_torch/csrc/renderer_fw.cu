// Fused Emission-Absorption forward march of the Lightplane renderer, for
// Hopper (sm_90a).
//
// Replaces lightplane_tpu/ops/kernels/renderer_pallas.py::_build_fw_kernel
// (launched by pallas_render_fwd).  Per ray and per march step it computes
// the depth and step size, the point (optionally MeRF-contracted), the sum of
// the grid-list's tri/bi-linear samples, the trunk -> opacity and color MLPs,
// sigma = gain * softplus(opacity + noise) with the counter RNG, and the EA
// accumulation of depth, negative log transmittance and features.
//
// Design.  One thread marches one ray through all steps; 128 rays per block.
// The TPU kernel's stencil matmuls, W1/W2/W3 windows, sample packing, packed
// ray table and trunk-layer-1 fold exist because a TPU has no gather; here
// the sampler gathers the corner rows straight from device memory (the
// grid-list of the slice config is 393 KB and stays in L2).  The block stages
// every MLP layer in shared memory, zero-padded to a W x W tile (W = 32 or
// 64, a template parameter), so the per-thread dense layers run fully
// unrolled on register arrays with float4 shared-memory reads and no bounds
// tests.  The ray encoding, the trunk output and the feature accumulators
// live in shared memory, transposed so that a warp's accesses hit distinct
// banks.
//
// What bounds it.  At the slice config (triplane 3 x 32^2 x 32ch, MLPs 2/2/2
// with hidden 32, 256 samples, 65,536 rays) the decoder costs about 5k f32
// MACs per ray-sample: about 170 GFLOP per frame of FP32 CUDA-core work,
// against a 393 KB gather working set.  The kernel is compute-bound on the
// CUDA cores; moving the MLPs onto the tensor cores (wgmma over a tile of
// samples) is later work.
//
// Two optional branches (the TPU kernel's scaffold gates,
// renderer_pallas.py::_scaffold_gate_base / _chunk_gates /
// _scaffold_chunk_skip, and its `cinfos` colour grid):
//   - scaffold gating (R3): each step's gate is the scaffold's value at the
//     nearest cell (march_common.cuh::scaffold_gate) and multiplies sigma
//     and the colour, as the plain version does; a step whose gate is 0
//     changes nothing and is skipped, sampling and MLPs included.  With no
//     barrier in the step loop the skip is per thread.  (The TPU kernel
//     thresholds the gate at 0.5 and packs it into bits; the two agree on
//     the binary scaffolds that calculate_scaffold makes.)
//   - the relu-field colour grid (R1-rf): with no trunk MLP, the opacity
//     head reads relu(grid sample) and the colour head relu(colour grid
//     sample) + encoding, both grid-lists sampled at the same point.
//
// Numerics follow the JAX scan path: w = exp(-nlt) - exp(-nlt_new) as
// written there, and the shared helpers of march_common.cuh (bit-exact
// counter hash, IEEE transcendentals: no --use_fast_math).

#include "march_common.cuh"

namespace {

using namespace lightplane;

constexpr int kThreads = 128;

template <int W>
__global__ void __launch_bounds__(kThreads)
    render_fw_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int n_t = p.n_layers[0], n_o = p.n_layers[1], n_c = p.n_layers[2];
  const int n_total = n_t + n_o + n_c;
  constexpr int kLayer = W * W + W;
  float* s_enc = smem + n_total * kLayer;    // [W][kThreads]
  float* s_trunk = s_enc + W * kThreads;     // [W][kThreads]
  float* s_feat = s_trunk + W * kThreads;    // [color_chn][kThreads]
  const int tid = threadIdx.x;

  stage_layers<W>(p, smem, n_total);
  __syncthreads();

  const int ray = blockIdx.x * kThreads + tid;
  if (ray >= p.num_rays) return;

  const Ray r = load_ray(p, ray);
  for (int c = 0; c < W; ++c)
    s_enc[c * kThreads + tid] =
        c < p.enc_chn ? p.enc[(long long)ray * p.enc_chn + c] : 0.0f;
  for (int c = 0; c < p.color_chn; ++c) s_feat[c * kThreads + tid] = 0.0f;

  // shared-memory layer order: trunk, opacity (hidden, last), color
  // (hidden, last)
  const int trunk_end = n_t;
  const int opacity_end = n_t + n_o - 1;
  const int n_relu_layers = n_total - 2;
  const float* opacity_last = smem + opacity_end * kLayer;
  const float* color_last = smem + (n_total - 1) * kLayer;
  const int tot = p.num_samples + p.num_samples_inf;
  const bool cgrid = p.color_grid != nullptr;

  float nlt = 0.0f, depth = 0.0f;
  float x[W], y[W];
  for (int s = 0; s < tot; ++s) {
    const Step st = march_step(p, r, s);
    const float gate = scaffold_gate(p, r.b, st);
    if (gate == 0.0f) continue;  // sigma = colour = 0: nothing to add

    const bool sampled = !p.mask_out_of_bounds || st.in_bounds;
#pragma unroll
    for (int c = 0; c < W; ++c) x[c] = 0.0f;
    if (sampled) sample_grids<W>(p, r.b, st, x);

    // The decoder's relu layers run in one loop, so the unrolled dense layer
    // is compiled once: j walks the trunk layers (relu after each, and
    // relu(feature) with no trunk layer), then the opacity head's hidden
    // layers, then the color head's hidden layers on trunk + encoding.  At
    // j == trunk_end the trunk output is kept (with a colour grid, relu of
    // its sample is kept instead); at j == opacity_end the opacity head's
    // last layer (no relu, output 0) reads x.
    if (n_t == 0) {
#pragma unroll
      for (int c = 0; c < W; ++c) x[c] = fmaxf(x[c], 0.0f);
    }
    if (cgrid) {
#pragma unroll
      for (int c = 0; c < W; ++c) y[c] = 0.0f;
      if (sampled)
        sample_grids<W>(p.cgrids, p.color_grid, p.grid_chn, r.b, st, y);
#pragma unroll
      for (int c = 0; c < W; ++c)
        s_trunk[c * kThreads + tid] = fmaxf(y[c], 0.0f);
    }
    float opacity_raw = 0.0f;
    for (int j = 0;; ++j) {
      if (j == trunk_end && !cgrid) {
#pragma unroll
        for (int c = 0; c < W; ++c) s_trunk[c * kThreads + tid] = x[c];
      }
      if (j == opacity_end) {
        opacity_raw = dense_out<W>(opacity_last, x, 0);
#pragma unroll
        for (int c = 0; c < W; ++c)
          x[c] = s_trunk[c * kThreads + tid] + s_enc[c * kThreads + tid];
      }
      if (j == n_relu_layers) break;
      // the opacity head's last layer sits between the two heads' hidden
      // layers in shared memory
      const int layer = j < opacity_end ? j : j + 1;
      dense_relu<W>(smem + layer * kLayer, x, y);
#pragma unroll
      for (int c = 0; c < W; ++c) x[c] = y[c];
    }
    if (p.noise_sigma > 0.0f) opacity_raw += step_noise(p, ray, s);
    const float sigma = p.gain * softplus(opacity_raw) * gate;

    // Emission-Absorption
    const float nlt_new = nlt + sigma * st.delta;
    const float w = expf(-nlt) - expf(-nlt_new);
    depth += w * st.t;
    for (int c = 0; c < p.color_chn; ++c)
      s_feat[c * kThreads + tid] +=
          w * (sigmoid(dense_out<W>(color_last, x, c)) * gate);
    nlt = nlt_new;
  }

  p.depth[ray] = depth;
  p.nlt[ray] = nlt;
  for (int c = 0; c < p.color_chn; ++c)
    p.feat[(long long)ray * p.color_chn + c] = s_feat[c * kThreads + tid];
}

template <int W>
cudaError_t launch(const Params& p, size_t smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        render_fw_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (p.num_rays + kThreads - 1) / kThreads;
  render_fw_kernel<W><<<blocks, kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long long lightplane_render_fw_smem_bytes(int width, int n_layers_total,
                                          int color_chn) {
  return 4LL * ((long long)n_layers_total * (width * width + width) +
                (long long)kThreads * (2 * width + color_chn));
}

// Launches the forward march on `stream`; returns a cudaError_t code.
//   grid_meta: host int[5 * num_grids], per sub-grid (row offset, B, D, H, W)
//   mlp_widths: host int[n_t + 1 + n_o + 1 + n_c + 1], the n_hidden tuples
//   width: the padded activation width, 32 or 64
//   scaffold, scaffold_dims: the [B, D, H, W] scaffold and its host int[4]
//     shape, or null
//   color_grid, num_color_grids, color_grid_meta: the relu-field colour
//     grid-list [Vc_total, grid_chn] and its table (as grid_meta's), or null
// The caller validates shapes, devices and limits.
int lightplane_render_fw(
    const float* origins, const float* directions, const float* near,
    const float* far, const int* grid_idx, const float* enc, const float* grid,
    const float* mlp, float* depth, float* nlt, float* feat, int num_rays,
    int num_grids, const int* grid_meta, int grid_chn, int n_t, int n_o,
    int n_c, const int* mlp_widths, int enc_chn, int color_chn, int width,
    int num_samples, int num_samples_inf, float disparity_at_inf, float gain,
    int mask_out_of_bounds, int contract_coords, float noise_sigma,
    int noise_seed, int noise_stride, int num_rays_noise,
    const float* scaffold, const int* scaffold_dims, const float* color_grid,
    int num_color_grids, const int* color_grid_meta, void* stream) {
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
  if (num_rays == 0) return (int)cudaSuccess;
  p.origins = origins;
  p.directions = directions;
  p.near = near;
  p.far = far;
  p.grid_idx = grid_idx;
  p.enc = enc;
  p.grid = grid;
  p.mlp = mlp;
  p.depth = depth;
  p.nlt = nlt;
  p.feat = feat;

  const size_t smem = (size_t)lightplane_render_fw_smem_bytes(
      width, n_t + n_o + n_c, color_chn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      width == 32 ? launch<32>(p, smem, s) : launch<64>(p, smem, s);
  return (int)e;
}

const char* lightplane_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
