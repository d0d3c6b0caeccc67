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

#include "renderer_bw.cuh"

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
                     : lightplane::render_bw_attrs_64(out);
}

// The wide build's (W = 96-768, renderer_wide.cuh) launch at these MLP
// widths (mlp_widths: host int[n_t + 1 + n_o + 1 + n_c + 1]) and with a
// colour grid or not: out[0] warps per block, out[1] the rows of
// g_mlp_partial (one per block of the resident wave; the caller zero-fills
// them), out[2] the floats of a row, out[3] a block's shared memory in
// bytes, out[4] the bytes of the packed layers, out[5] a block's scratch
// bytes (past W = 256; 0 below): the workspace lightplane_render_bw takes
// is out[4] + out[1] out[5] bytes; a cudaError_t code
// (cudaErrorInvalidValue where one warp's region and the ring of layer
// slices exceed a block's shared memory).
int lightplane_render_bw_wide_config(int width, int n_t, int n_o, int n_c,
                                     const int* mlp_widths,
                                     int has_color_grid, int* out) {
  if (n_o < 1 || n_c < 1 || n_t > kMaxLayers || n_o > kMaxLayers ||
      n_c > kMaxLayers || width <= 64 || !known_width(width))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const int counts[3] = {n_t, n_o, n_c};
  fill_layers(p, counts, mlp_widths);
  return render_bw_wide_config(p, width, has_color_grid != 0, out);
}

// The wide builds' pre-pass alone, on `stream`: the products of a chunk of
// `schedule` (wide_mlp.cuh::WideSchedule: 0 R1's, 1 R2's, 2 the splatter
// MLP's forward, S1's pass F, 3 its adjoint, S2's pass A; the splatter's
// MLP in n_t layers, n_o = n_c = 0) packed from the flat `mlp` into
// `workspace` (the bytes of the kernel's config); a cudaError_t code.
int lightplane_render_wide_pack(const float* mlp, int n_t, int n_o, int n_c,
                                const int* mlp_widths, int schedule,
                                void* workspace, void* stream) {
  const bool splat = schedule == kSplatFw || schedule == kSplatBw;
  if (schedule < kRenderFw || schedule > kSplatBw || n_t > kMaxLayers ||
      n_o > kMaxLayers || n_c > kMaxLayers ||
      (splat ? n_t < 1 || n_o != 0 || n_c != 0 : n_o < 1 || n_c < 1))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const int counts[3] = {n_t, n_o, n_c};
  fill_layers(p, counts, mlp_widths);
  p.mlp = mlp;
  return (int)launch_wide_pack(p, schedule, workspace,
                               static_cast<cudaStream_t>(stream));
}

// Launches the recompute backward on `stream`; returns a cudaError_t code.
// Arguments as lightplane_render_fw's, plus the saved nlt_final and the
// cotangents in, the gradients and the [blocks, partial floats] buffer out,
// `rays_per_block` (128, 64 or 32; not read by the wide build, whose
// g_mlp_partial has lightplane_render_bw_wide_config's rows, zero-filled),
// with a colour grid its gradient
// g_color_grid, for the recording build the zero-filled
// [R, steps, vectors, width / 32] mask words (null otherwise), the
// wide build's workspace (lightplane_render_bw_wide_config's bytes, 16-byte
// aligned; null for the others), and in the wide build's recording build
// its [R, steps, 2] zero-filled probe (renderer_wide.cuh::write_probe) or
// null.  The caller
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
    float* probe, void* stream) {
  if (rays_per_block != 128 && rays_per_block != 64 && rays_per_block != 32)
    return (int)cudaErrorInvalidValue;
  if ((relu_masks != nullptr) != kReluMasks) return (int)cudaErrorInvalidValue;
  if (probe != nullptr && (!kReluMasks || width <= 64))
    return (int)cudaErrorInvalidValue;
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
    return (int)launch_render_bw_wide(p, width, workspace, probe,
                                      static_cast<cudaStream_t>(stream));

  const size_t smem = (size_t)lightplane_render_bw_smem_bytes(
      width, rays_per_block, n_total, color_chn, cg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      width == 32 ? launch<32>(p, rays_per_block, smem, s)
                  : lightplane::launch_render_bw_64(p, rays_per_block, smem, s);
  return (int)e;
}

}  // extern "C"
