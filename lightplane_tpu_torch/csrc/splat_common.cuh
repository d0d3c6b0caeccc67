// What the splatter's forward (splatter_fw.cu) and adjoint (splatter_bw.cu)
// share: their launch parameters and host-side setup.

#pragma once

#include "march_common.cuh"

namespace lightplane {

struct SplatParams {
  // The rays and the march schedule; with an MLP also the input grid-list
  // (m.grid, m.grids, m.grid_chn) and the MLP (m.mlp, its layer tables in
  // m.n_layers[0] layers).  m.enc is the encoding [R, enc_chn]; the
  // adjoint's m.g_enc, m.g_grid (the input grid's gradient, zero-filled by
  // the caller), m.g_mlp and m.g_mlp_partial.
  Params m;
  GridMeta out;  // the output grid-list [V_out, out_chn]
  int out_chn;
  float* feat;          // forward: [V_out, out_chn], zero-filled by the caller
  float* w;             // forward: [V_out], zero-filled by the caller
  const float* g_out;   // adjoint: the gradient of feat, [V_out, out_chn]
  float* stage;         // adjoint with the MLP: g_in [R, steps, enc_chn]
  float* gvec;          // adjoint with the MLP: g_vec [R, steps, out_chn]
};

// Fills everything but the tensors; returns a cudaError_t code.
//   out_meta, in_meta: host int[5 * n], per sub-grid (row offset, B, D, H, W)
//   n_layers: the MLP's layer count, 0 without an MLP (then the input
//     grid-list and mlp_widths are not read)
//   mlp_widths: host int[n_layers + 1], the MLP's n_hidden
//   width: the padded activation width, 32, 64, 96, 128, 192, 256, 384,
//   512 or 768 (with an MLP)
inline int fill_splat_params(SplatParams& sp, int num_rays, int num_out_grids,
                             const int* out_meta, int out_chn,
                             int num_in_grids, const int* in_meta, int in_chn,
                             int n_layers, const int* mlp_widths, int width,
                             int num_samples, int num_samples_inf,
                             float disparity_at_inf, int mask_out_of_bounds,
                             int contract_coords) {
  Params& p = sp.m;
  if (!fill_grid_meta(sp.out, num_out_grids, out_meta) || out_chn < 1 ||
      n_layers < 0 || n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  p.num_rays = num_rays;
  p.num_batches = min_batch(sp.out, sp.out.dims[0][0]);
  if (n_layers > 0) {
    if (!known_width(width) ||
        !fill_grid_meta(p.grids, num_in_grids, in_meta))
      return (int)cudaErrorInvalidValue;
    p.num_batches = min_batch(p.grids, p.num_batches);
    const int counts[3] = {n_layers, 0, 0};
    fill_layers(p, counts, mlp_widths);
    p.grid_chn = in_chn;
    p.enc_chn = in_chn;
  } else {
    p.enc_chn = out_chn;
  }
  fill_march(p, num_samples, num_samples_inf, disparity_at_inf,
             mask_out_of_bounds, contract_coords);
  sp.out_chn = out_chn;
  return (int)cudaSuccess;
}

}  // namespace lightplane
