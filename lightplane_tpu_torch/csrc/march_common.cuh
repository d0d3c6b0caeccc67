// What the renderer's forward march (renderer_fw.cu) and recompute backward
// (renderer_bw.cu) and the splatter's two kernels (splatter_fw.cu,
// splatter_bw.cu) share: the launch parameters and their host-side setup,
// the counter RNG, the per-step geometry, the grid-list corner walk and the
// padded dense layers of the MLPs.
//
// Numerics follow the JAX scan path: the counter hash in uint32_t / int32_t
// so that it is bit-exact with JAX's wrapping int32 arithmetic, and IEEE
// expf / logf / log1pf / cosf (the sources must be compiled without
// --use_fast_math).  The step geometry (depth, point, grid coordinate) is
// written with __fmul_rn / __fadd_rn, which nvcc does not contract into
// fused multiply-adds, so it rounds as the plain versions' separate
// elementwise operations do: a corner weight near a cell boundary, tiny
// and so relatively sensitive to one rounding, is then the same in both,
// and so is a splat normalised by a sum of such weights.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lightplane {

constexpr int kMaxGrids = 16;
constexpr int kMaxLayers = 16;  // per MLP
constexpr int kMaxTotalLayers = 3 * kMaxLayers;

// LIGHTPLANE_ABLATE, a bit mask that only `chip_smoke.py --ablate` sets,
// switches parts of R1 (renderer_fw.cu), R2 (renderer_bw.cu), their wide
// builds (renderer_wide.cuh: bits 2, 4, 8 and 16), S1 (splatter_fw.cu) and
// S2 (splatter_bw.cu) off to time them.  The shipped build has none of it.
#ifndef LIGHTPLANE_ABLATE
#define LIGHTPLANE_ABLATE 0
#endif
constexpr int kAblate = LIGHTPLANE_ABLATE;
constexpr int kAblateScalarAtomics = 1;  // scalar atomicAdd per channel (R2)
constexpr int kAblateNoAtomics = 2;      // no atomics into the grid (R2)
constexpr int kAblateNoWeightGrad = 4;   // no MLP weight-gradient pass (R2)
constexpr int kAblateNoSampling = 8;     // no grid-list sampling (R1)
constexpr int kAblateNoMlp = 16;         // no decoder MLP (R1)
constexpr int kAblateNoSplat = 32;       // the plan alone, no splat pass (S1)
constexpr int kAblateNoFlush = 64;       // no flush of the tiles (S1)
constexpr int kAblateS2NoScatter = 128;  // no input-grid gradient (S2)
constexpr int kAblateS2NoWeightGrad = 256;  // no MLP weight gradient (S2)
constexpr int kAblateS2GatherOnly = 512;    // neither MLP nor scatter (S2)

// Whether the part `bit` runs.  A part switched off keeps a guard on data
// `x` that never holds, so the compiler keeps the work that feeds it.
__device__ __forceinline__ bool part_runs(int bit, float x) {
  return !(kAblate & bit) || x == 1234.5f;
}

// Whether C channels are reduced as float4 atomics (16-byte rows).
__device__ __forceinline__ bool float4_atomics(int C) {
  return (C & 3) == 0 && !(kAblate & kAblateScalarAtomics);
}

// The sub-grid shapes of a grid-list and the row where each starts in the
// flattened [V_total, C] tensor.
struct GridMeta {
  int num_grids;
  long long row_offset[kMaxGrids];
  int dims[kMaxGrids][4];  // B, D, H, W
};

// Fills m from host int[5 * num_grids], per sub-grid (row offset, B, D, H,
// W); false for a sub-grid count outside 1..kMaxGrids.
inline bool fill_grid_meta(GridMeta& m, int num_grids, const int* grid_meta) {
  if (num_grids < 1 || num_grids > kMaxGrids) return false;
  m.num_grids = num_grids;
  for (int g = 0; g < num_grids; ++g) {
    m.row_offset[g] = grid_meta[5 * g];
    for (int k = 0; k < 4; ++k) m.dims[g][k] = grid_meta[5 * g + 1 + k];
  }
  return true;
}

// The smallest batch of the sub-grids of m, and `limit`.
inline int min_batch(const GridMeta& m, int limit) {
  for (int g = 0; g < m.num_grids; ++g)
    limit = m.dims[g][0] < limit ? m.dims[g][0] : limit;
  return limit;
}

struct Params {
  const float* origins;     // [R, 3]
  const float* directions;  // [R, 3]
  const float* near;        // [R]
  const float* far;         // [R]
  const int* grid_idx;      // [R]
  const float* enc;         // [R, enc_chn]
  const float* grid;        // [V_total, grid_chn]
  const float* mlp;         // flat mlp_params

  // forward outputs
  float* depth;  // [R]
  float* nlt;    // [R]
  float* feat;   // [R, color_chn]

  // backward inputs and outputs
  const float* nlt_final;  // [R]
  const float* g_depth;    // [R]
  const float* g_nlt;      // [R]
  const float* g_feat;     // [R, color_chn]
  float* g_grid;           // [V_total, grid_chn], zero-filled by the caller
  float* g_mlp;            // flat, like mlp
  float* g_enc;            // [R, enc_chn]
  float* g_mlp_partial;    // [blocks, n_layers_total * per-layer partials]
  // R2 only: whether the block keeps its weight-gradient sums in shared
  // memory (else in its row of g_mlp_partial).  R2 and S2: the relu masks
  // that their recording builds write (mlp_bwd.cuh::record_mask,
  // LIGHTPLANE_RELU_MASKS), with the number of relu'd vectors per step
  int acc_in_smem;
  uint32_t* relu_masks;
  int n_mask_vecs;

  int num_rays;
  GridMeta grids;  // of `grid`
  int grid_chn;
  // The smallest batch of every grid-list (and scaffold) the kernel reads:
  // a ray whose grid_idx lies outside [0, num_batches) samples and splats
  // nothing (load_ray), so no index the caller passes reads or writes
  // outside a grid.
  int num_batches;

  // The renderer's scaffold (R3): a [B, D, H, W] occupancy sampled at the
  // nearest cell that multiplies each step's sigma and colour; null for none.
  const float* scaffold;
  int scaffold_dims[4];  // B, D, H, W
  // The renderer's relu-field colour grid-list: [Vc_total, grid_chn],
  // sampled at the same points as `grid`, relu'd into the colour head; null
  // for none.  Its gradient (backward) is zero-filled by the caller.
  const float* color_grid;
  GridMeta cgrids;  // of `color_grid`
  float* g_color_grid;

  int n_layers[3];  // trunk, opacity, color (the splatter: its MLP, 0, 0)
  int layer_in[kMaxTotalLayers];
  int layer_out[kMaxTotalLayers];
  int layer_w_off[kMaxTotalLayers];
  int layer_b_off[kMaxTotalLayers];
  int n_params;
  int enc_chn;
  int color_chn;

  int num_samples;
  int num_samples_inf;
  float disparity_at_inf;
  float gain;
  int mask_out_of_bounds;
  int contract_coords;
  float noise_sigma;
  int noise_seed;
  int noise_stride;
  int num_rays_noise;
};

// Per-layer widths and offsets into the flat parameter vector of up to
// three MLPs of counts[m] layers each, whose n_hidden tuples follow each
// other in mlp_widths; each MLP is [W_0, ..., W_{L-1}, b_0, ..., b_{L-1}].
inline void fill_layers(Params& p, const int counts[3],
                        const int* mlp_widths) {
  int layer = 0, w_at = 0, param_off = 0;
  for (int m = 0; m < 3; ++m) {
    p.n_layers[m] = counts[m];
    const int* nh = mlp_widths + w_at;
    int w_numel = 0;
    for (int l = 0; l < counts[m]; ++l) w_numel += nh[l] * nh[l + 1];
    int w_off = param_off, b_off = param_off + w_numel;
    for (int l = 0; l < counts[m]; ++l, ++layer) {
      p.layer_in[layer] = nh[l];
      p.layer_out[layer] = nh[l + 1];
      p.layer_w_off[layer] = w_off;
      p.layer_b_off[layer] = b_off;
      w_off += nh[l] * nh[l + 1];
      b_off += nh[l + 1];
    }
    param_off = b_off;
    w_at += counts[m] + (counts[m] > 0 ? 1 : 0);
  }
  p.n_params = param_off;
}

// Fills the march schedule: samples, background, masking, contraction.
inline void fill_march(Params& p, int num_samples, int num_samples_inf,
                       float disparity_at_inf, int mask_out_of_bounds,
                       int contract_coords) {
  p.num_samples = num_samples;
  p.num_samples_inf = num_samples_inf;
  p.disparity_at_inf = disparity_at_inf;
  p.mask_out_of_bounds = mask_out_of_bounds;
  p.contract_coords = contract_coords;
}

// The padded activation widths the kernels are built for: 32 and 64 keep
// every MLP layer in shared memory; 96, 128, 192 and 256 are the wide
// builds (wide_mlp.cuh), which pass the layers through shared memory a
// slice at a time; the renderer's (R1, R2) also at 384 and 512, the
// splatter MLP's (S1, S2) up to 256.
inline bool known_splat_width(int width) {
  return width == 32 || width == 64 || width == 96 || width == 128 ||
         width == 192 || width == 256;
}

inline bool known_width(int width) {
  return known_splat_width(width) || width == 384 || width == 512;
}

// Fills everything but the tensors; returns a cudaError_t code.
//   grid_meta: host int[5 * num_grids], per sub-grid (row offset, B, D, H, W)
//   mlp_widths: host int[n_t + 1 + n_o + 1 + n_c + 1], the n_hidden tuples
//   width: the padded activation width, 32, 64, 96, 128, 192, 256, 384 or
//   512
inline int fill_params(Params& p, int num_rays, int num_grids,
                       const int* grid_meta, int grid_chn, int n_t, int n_o,
                       int n_c, const int* mlp_widths, int enc_chn,
                       int color_chn, int width, int num_samples,
                       int num_samples_inf, float disparity_at_inf, float gain,
                       int mask_out_of_bounds, int contract_coords,
                       float noise_sigma, int noise_seed, int noise_stride,
                       int num_rays_noise) {
  if (n_o < 1 || n_c < 1 || n_t > kMaxLayers || n_o > kMaxLayers ||
      n_c > kMaxLayers || !known_width(width) ||
      !fill_grid_meta(p.grids, num_grids, grid_meta))
    return (int)cudaErrorInvalidValue;
  p.num_rays = num_rays;
  p.grid_chn = grid_chn;
  p.num_batches = min_batch(p.grids, p.grids.dims[0][0]);
  const int counts[3] = {n_t, n_o, n_c};
  fill_layers(p, counts, mlp_widths);
  p.enc_chn = enc_chn;
  p.color_chn = color_chn;
  fill_march(p, num_samples, num_samples_inf, disparity_at_inf,
             mask_out_of_bounds, contract_coords);
  p.gain = gain;
  p.noise_sigma = noise_sigma;
  p.noise_seed = noise_seed;
  p.noise_stride = noise_stride;
  p.num_rays_noise = num_rays_noise;
  return (int)cudaSuccess;
}

// Fills the renderer's optional inputs (after fill_params): the scaffold
// and its host int[4] shape (B, D, H, W), and the colour grid-list with its
// host int[5 * num_color_grids] table (as fill_grid_meta's), each null for
// none.  A colour grid takes no trunk MLP.  Returns a cudaError_t code.
inline int fill_render_extras(Params& p, const float* scaffold,
                              const int* scaffold_dims,
                              const float* color_grid, int num_color_grids,
                              const int* color_grid_meta) {
  p.scaffold = scaffold;
  if (scaffold != nullptr) {
    for (int k = 0; k < 4; ++k) p.scaffold_dims[k] = scaffold_dims[k];
    if (scaffold_dims[0] < p.num_batches) p.num_batches = scaffold_dims[0];
  }
  p.color_grid = color_grid;
  if (color_grid != nullptr) {
    if (p.n_layers[0] != 0 ||
        !fill_grid_meta(p.cgrids, num_color_grids, color_grid_meta))
      return (int)cudaErrorInvalidValue;
    p.num_batches = min_batch(p.cgrids, p.num_batches);
  }
  return (int)cudaSuccess;
}

// Stages every MLP layer in shared memory as a zero-padded [W, W] weight
// tile (row i = input i) followed by W biases.  No barrier.
template <int W>
__device__ __forceinline__ void stage_layers(const Params& p, float* smem,
                                             int n_total) {
  constexpr int kLayer = W * W + W;
  for (int l = 0; l < n_total; ++l) {
    float* dst = smem + l * kLayer;
    const int d_in = p.layer_in[l], d_out = p.layer_out[l];
    const float* w_src = p.mlp + p.layer_w_off[l];
    for (int k = threadIdx.x; k < W * W; k += blockDim.x) {
      const int i = k / W, o = k % W;
      dst[k] = (i < d_in && o < d_out) ? w_src[i * d_out + o] : 0.0f;
    }
    for (int o = threadIdx.x; o < W; o += blockDim.x)
      dst[W * W + o] = o < d_out ? p.mlp[p.layer_b_off[l] + o] : 0.0f;
  }
}

// Kernel attributes for the report: registers per thread, local (spilled)
// bytes per thread, the most threads a block may have.
template <class K>
inline int kernel_attrs(K kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  return (int)cudaSuccess;
}

// ---- counter RNG (lightplane_tpu/ops/rand.py) ---------------------------
// Multiplies and left shifts in uint32_t (wrapping), right shifts on int32_t
// (arithmetic), as JAX's int32 operators behave.

__device__ __forceinline__ int32_t hash_i32(int32_t x) {
  x = (int32_t)((uint32_t)((x >> 16) ^ x) * 0x45D9F3Bu);
  x = (int32_t)((uint32_t)((x >> 16) ^ x) * 0x45D9F3Bu);
  return (x >> 16) ^ x;
}

__device__ __forceinline__ int32_t pair_hash(int32_t x, int32_t h) {
  h = h ^ x;
  return (int32_t)(((uint32_t)h << 24) + (uint32_t)h * 0x193u);
}

__device__ __forceinline__ float hash_to_unit(int32_t h) {
  // JAX adds the f32 roundings of 2147483647.0 (= 2^31) and 3.0, then
  // divides by the f32 rounding of 4294967298.0 (= 2^32).
  return (((float)h + 2147483648.0f) + 3.0f) / 4294967296.0f;
}

__device__ __forceinline__ float int_to_randn(int32_t i1, int32_t i2,
                                              int32_t seed) {
  const int32_t prime = 105097564;
  const int32_t seed1 = (int32_t)((uint32_t)seed + 1u);
  const int32_t h1 = pair_hash(pair_hash(prime, seed), hash_i32(i1));
  const int32_t h2 = pair_hash(pair_hash(prime, seed1), hash_i32(i2));
  const float u1 = hash_to_unit(h1);
  const float u2 = hash_to_unit(h2);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.28318530718f * u2);
}

// Injected opacity noise of `ray` at step `s` (get_sample_randn's counters).
__device__ __forceinline__ float step_noise(const Params& p, int ray, int s) {
  const uint32_t i1 = (uint32_t)p.noise_stride *
                          (uint32_t)min(ray, p.num_rays_noise - 1) +
                      (uint32_t)s + 1u;
  const uint32_t i2 =
      i1 + (uint32_t)max(p.num_rays_noise, 16) * (uint32_t)p.noise_stride;
  return int_to_randn((int32_t)i1, (int32_t)i2, p.noise_seed) * p.noise_sigma;
}

// ---- per-step geometry (lightplane_tpu/ops/renderer.py) -----------------

__device__ __forceinline__ float lin_depth(const Params& p, float near,
                                          float far, float si) {
  if (p.num_samples > 1)
    return __fadd_rn(near, __fmul_rn(far - near,
                                     si / (float)(p.num_samples - 1)));
  return near;
}

__device__ __forceinline__ float inf_depth(const Params& p, float far,
                                          float si) {
  const float frac = (si - (float)p.num_samples + 1.0f) /
                     (float)p.num_samples_inf;
  const float n_disp = __fadd_rn(__fmul_rn(p.disparity_at_inf, frac),
                                 1.0f - frac);
  return far * (1.0f / n_disp);
}

__device__ __forceinline__ float step_depth(const Params& p, float near,
                                           float far, float si) {
  if (p.num_samples_inf > 0 && !(si < (float)p.num_samples))
    return inf_depth(p, far, si);
  return lin_depth(p, near, far, si);
}

__device__ __forceinline__ float contract_one(float x, float n) {
  const float a = fabsf(x);
  const float safe_abs = a > 0.0f ? a : 1.0f;
  if (fabsf(a - n) <= 1e-7f) return (2.0f - 1.0f / safe_abs) * (x / safe_abs);
  return x / n;
}

// One ray's constants; b is its batch, -1 where grid_idx lies outside
// [0, num_batches): such a ray samples, gates and splats nothing.
struct Ray {
  float ox, oy, oz, dx, dy, dz, near, far, delta0;
  int b;
};

__device__ __forceinline__ Ray load_ray(const Params& p, int ray) {
  Ray r;
  r.ox = p.origins[3 * ray + 0];
  r.oy = p.origins[3 * ray + 1];
  r.oz = p.origins[3 * ray + 2];
  r.dx = p.directions[3 * ray + 0];
  r.dy = p.directions[3 * ray + 1];
  r.dz = p.directions[3 * ray + 2];
  r.near = p.near[ray];
  r.far = p.far[ray];
  // an index outside every grid's batch marks the ray as reading nothing
  const int b = p.grid_idx[ray];
  r.b = b >= 0 && b < p.num_batches ? b : -1;
  const int ns = p.num_samples;
  r.delta0 = ns > 1 ? (r.far - r.near) / (float)(ns - 1) : 1.0f;
  return r;
}

// Depth t and step size delta of step s, and the (contracted) point.
struct Step {
  float t, delta, px, py, pz;
  bool in_bounds;
};

__device__ __forceinline__ Step march_step(const Params& p, const Ray& r,
                                           int s) {
  Step st;
  const float sf = (float)s;
  st.t = step_depth(p, r.near, r.far, sf);
  st.delta = sf < 1.0f ? r.delta0
                       : st.t - step_depth(p, r.near, r.far, sf - 1.0f);
  float px = __fadd_rn(r.ox, __fmul_rn(st.t, r.dx)),
        py = __fadd_rn(r.oy, __fmul_rn(st.t, r.dy)),
        pz = __fadd_rn(r.oz, __fmul_rn(st.t, r.dz));
  if (p.contract_coords) {
    const float n = fmaxf(fmaxf(fabsf(px), fabsf(py)), fabsf(pz));
    if (n > 1.0f) {
      px = contract_one(px, n);
      py = contract_one(py, n);
      pz = contract_one(pz, n);
    }
    px = px / 2.0f;
    py = py / 2.0f;
    pz = pz / 2.0f;
  }
  st.px = px;
  st.py = py;
  st.pz = pz;
  st.in_bounds = fabsf(px) <= 1.0f && fabsf(py) <= 1.0f && fabsf(pz) <= 1.0f;
  return st;
}

// ---- grid-list corners (lightplane_tpu/ops/grid_sample.py) --------------

__device__ __forceinline__ float grid_coord(float p, int size) {
  return size > 1 ? __fmul_rn((p + 1.0f) * 0.5f, (float)size) - 0.5f : 0.0f;
}

// The linear-interpolation cell of sub-grid g of `m` that holds the point
// of `st`: its lower corner (x0, y0, z0; -1 in the lower border half-cell)
// and the point's fractions in it, by for_each_corner's arithmetic.  S1
// keys and splats its samples by it.  for_each_corner keeps its own copy:
// calling this made S2 slower at the splat headline on an H100 (PERF.md,
// section 6).
struct Cell {
  float x0, y0, z0, tx, ty, tz;
};

__device__ __forceinline__ Cell grid_cell(const GridMeta& m, int g,
                                          const Step& st) {
  const float fx = grid_coord(st.px, m.dims[g][3]);
  const float fy = grid_coord(st.py, m.dims[g][2]);
  const float fz = grid_coord(st.pz, m.dims[g][1]);
  Cell c;
  c.x0 = floorf(fx);
  c.y0 = floorf(fy);
  c.z0 = floorf(fz);
  c.tx = fx - c.x0;
  c.ty = fy - c.y0;
  c.tz = fz - c.z0;
  return c;
}

// Calls f(row, weight) for every in-bounds linear-interpolation corner of
// every sub-grid of `m` at the point of `st`, for batch b (none for b < 0,
// a ray whose grid_idx was out of range); `row` indexes the flattened
// [V_total, C] grid-list.
template <class F>
__device__ __forceinline__ void for_each_corner(const GridMeta& m, int b,
                                                const Step& st, F&& f) {
  if (b < 0) return;
  for (int g = 0; g < m.num_grids; ++g) {
    const int D = m.dims[g][1];
    const int H = m.dims[g][2];
    const int Wd = m.dims[g][3];
    const float fx = grid_coord(st.px, Wd);
    const float fy = grid_coord(st.py, H);
    const float fz = grid_coord(st.pz, D);
    const float x0 = floorf(fx), y0 = floorf(fy), z0 = floorf(fz);
    const float tx = fx - x0, ty = fy - y0, tz = fz - z0;
    // a singleton axis maps to index 0 with weight 1; its second corner has
    // weight 0 and is out of bounds, so it is skipped
    const int nz = D > 1 ? 2 : 1, ny = H > 1 ? 2 : 1, nx = Wd > 1 ? 2 : 1;
    for (int dz = 0; dz < nz; ++dz) {
      const float cz = z0 + (float)dz;
      if (!(cz >= 0.0f && cz < (float)D)) continue;
      const float wz = dz ? tz : (1.0f - tz);
      for (int dy = 0; dy < ny; ++dy) {
        const float cy = y0 + (float)dy;
        if (!(cy >= 0.0f && cy < (float)H)) continue;
        const float wy = dy ? ty : (1.0f - ty);
        for (int dx = 0; dx < nx; ++dx) {
          const float cx = x0 + (float)dx;
          if (!(cx >= 0.0f && cx < (float)Wd)) continue;
          const float wx = dx ? tx : (1.0f - tx);
          const long long row =
              m.row_offset[g] +
              (((long long)b * D + (int)cz) * H + (int)cy) * (long long)Wd +
              (int)cx;
          f(row, wx * wy * wz);
        }
      }
    }
  }
}

// The scaffold's gate at the point of `st` for batch b (1 without a
// scaffold), as the plain versions' nearest sample with out-of-bounds
// masking (lightplane_tpu/ops/grid_sample.py, mode="nearest"): 0 outside
// the [-1, 1] cube; else the cell at the rounded grid coordinate, rounded
// half to even by rintf as torch.round and jnp.round do (roundf rounds
// halves away from zero), 0 where that index falls outside the scaffold
// and for b < 0 (a ray whose grid_idx was out of range).
__device__ __forceinline__ float scaffold_gate(const Params& p, int b,
                                               const Step& st) {
  if (p.scaffold == nullptr) return 1.0f;
  if (!st.in_bounds || b < 0) return 0.0f;
  const int D = p.scaffold_dims[1], H = p.scaffold_dims[2],
            Wd = p.scaffold_dims[3];
  const float x = rintf(grid_coord(st.px, Wd));
  const float y = rintf(grid_coord(st.py, H));
  const float z = rintf(grid_coord(st.pz, D));
  if (!(x >= 0.0f && x < (float)Wd && y >= 0.0f && y < (float)H &&
        z >= 0.0f && z < (float)D))
    return 0.0f;
  return __ldg(p.scaffold +
               (((long long)b * D + (int)z) * H + (int)y) * (long long)Wd +
               (int)x);
}

// The corner walk of the renderer's grid-list.
template <class F>
__device__ __forceinline__ void for_each_corner(const Params& p, int b,
                                                const Step& st, F&& f) {
  for_each_corner(p.grids, b, st, f);
}

// Adds the linear sample of every sub-grid of the [V_total, C] grid-list
// (`m`, `grid`) at the point of `st` into x[0:C), C <= W.  Rows are read as
// float4 when C % 4 == 0 (the caller passes a 16-byte aligned `grid`).
template <int W>
__device__ __forceinline__ void sample_grids(const GridMeta& m,
                                             const float* grid, int C, int b,
                                             const Step& st, float (&x)[W]) {
  const bool vec4 = (C & 3) == 0;
  for_each_corner(m, b, st, [&](long long row, float w) {
    const float* src = grid + row * C;
    if (vec4) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll
      for (int c4 = 0; c4 < W / 4; ++c4) {
        if (c4 * 4 < C) {
          const float4 v = __ldg(src4 + c4);
          x[4 * c4 + 0] += w * v.x;
          x[4 * c4 + 1] += w * v.y;
          x[4 * c4 + 2] += w * v.z;
          x[4 * c4 + 3] += w * v.w;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c < C) x[c] += w * __ldg(src + c);
    }
  });
}

// The renderer's sample of its grid-list into x[0:grid_chn).
template <int W>
__device__ __forceinline__ void sample_grids(const Params& p, int b,
                                             const Step& st, float (&x)[W]) {
  sample_grids<W>(p.grids, p.grid, p.grid_chn, b, st, x);
}

// ---- decoder MLPs --------------------------------------------------------
// A layer is a zero-padded [W, W] weight tile followed by W biases, in
// shared memory (stage_layers).

// y = x @ layer + bias, then relu when kRelu.
template <int W, bool kRelu>
__device__ __forceinline__ void dense(const float* __restrict__ layer,
                                      const float (&x)[W], float (&y)[W]) {
  const float* bias = layer + W * W;
#pragma unroll
  for (int o = 0; o < W; ++o) y[o] = bias[o];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float xi = x[i];
    const float4* row = reinterpret_cast<const float4*>(layer + i * W);
#pragma unroll
    for (int o4 = 0; o4 < W / 4; ++o4) {
      const float4 w = row[o4];
      y[4 * o4 + 0] += xi * w.x;
      y[4 * o4 + 1] += xi * w.y;
      y[4 * o4 + 2] += xi * w.z;
      y[4 * o4 + 3] += xi * w.w;
    }
  }
  if (kRelu) {
#pragma unroll
    for (int o = 0; o < W; ++o) y[o] = fmaxf(y[o], 0.0f);
  }
}

template <int W>
__device__ __forceinline__ void dense_relu(const float* __restrict__ layer,
                                           const float (&x)[W], float (&y)[W]) {
  dense<W, true>(layer, x, y);
}

// Output o of a layer with no activation (the heads' last layers).
template <int W>
__device__ __forceinline__ float dense_out(const float* __restrict__ layer,
                                          const float (&x)[W], int o) {
  float acc = layer[W * W + o];
#pragma unroll
  for (int i = 0; i < W; ++i) acc += x[i] * layer[i * W + o];
  return acc;
}

// ---- the tensor cores: mma.sync m16n8k8 in TF32 ---------------------------
// A's fragment: a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); B's (K x N): b0 (k t, n g), b1 (t + 4, g); the accumulators: d0
// (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1), for lane
// 4 g + t.  R1 (renderer_fw.cu) runs its dense layers on them, R2 its weight
// gradient (mlp_bwd.cuh).

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (the "3xTF32" split): hi * hi + hi * lo + lo * hi
// keeps the product to ~2^-21 of its size where TF32 alone keeps ~2^-11.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));  // exact: x and hi share the top
}

// d += a * b, one m16n8k8 TF32 product accumulated in f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- activations ----------------------------------------------------------

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

}  // namespace lightplane
