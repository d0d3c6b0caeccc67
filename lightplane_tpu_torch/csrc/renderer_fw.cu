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
// Numerics follow the JAX scan path: w = exp(-nlt) - exp(-nlt_new) as
// written there, the counter hash in uint32_t / int32_t so that it is
// bit-exact with JAX's wrapping int32 arithmetic, and IEEE expf / logf /
// cosf (this file must be compiled without --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGrids = 8;
constexpr int kMaxLayers = 8;  // per MLP
constexpr int kMaxTotalLayers = 3 * kMaxLayers;

struct Params {
  const float* origins;     // [R, 3]
  const float* directions;  // [R, 3]
  const float* near;        // [R]
  const float* far;         // [R]
  const int* grid_idx;      // [R]
  const float* enc;         // [R, enc_chn]
  const float* grid;        // [V_total, grid_chn]
  const float* mlp;         // flat mlp_params
  float* depth;             // [R]
  float* nlt;               // [R]
  float* feat;              // [R, color_chn]

  int num_rays;
  int num_grids;
  int grid_chn;
  long long grid_row_offset[kMaxGrids];
  int grid_dims[kMaxGrids][4];  // B, D, H, W

  int n_layers[3];  // trunk, opacity, color
  int layer_in[kMaxTotalLayers];
  int layer_out[kMaxTotalLayers];
  int layer_w_off[kMaxTotalLayers];
  int layer_b_off[kMaxTotalLayers];
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

// ---- per-step geometry (lightplane_tpu/ops/renderer.py) -----------------

__device__ __forceinline__ float lin_depth(const Params& p, float near,
                                          float far, float si) {
  if (p.num_samples > 1)
    return near + (far - near) * (si / (float)(p.num_samples - 1));
  return near;
}

__device__ __forceinline__ float inf_depth(const Params& p, float far,
                                          float si) {
  const float frac = (si - (float)p.num_samples + 1.0f) /
                     (float)p.num_samples_inf;
  const float n_disp = p.disparity_at_inf * frac + (1.0f - frac);
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

// ---- grid-list sampling (lightplane_tpu/ops/grid_sample.py) -------------

__device__ __forceinline__ float grid_coord(float p, int size) {
  return size > 1 ? ((p + 1.0f) * 0.5f) * (float)size - 0.5f : 0.0f;
}

// Adds the linear sample of every sub-grid at (px, py, pz) into x[0:C).
template <int W>
__device__ __forceinline__ void sample_grids(const Params& p, int b, float px,
                                             float py, float pz, float (&x)[W]) {
  const int C = p.grid_chn;
  const bool vec4 = (C & 3) == 0;
  for (int g = 0; g < p.num_grids; ++g) {
    const int D = p.grid_dims[g][1];
    const int H = p.grid_dims[g][2];
    const int Wd = p.grid_dims[g][3];
    const float fx = grid_coord(px, Wd);
    const float fy = grid_coord(py, H);
    const float fz = grid_coord(pz, D);
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
          const float w = wx * wy * wz;
          const long long row =
              p.grid_row_offset[g] +
              (((long long)b * D + (int)cz) * H + (int)cy) * (long long)Wd +
              (int)cx;
          const float* src = p.grid + row * C;
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
        }
      }
    }
  }
}

// ---- decoder MLPs --------------------------------------------------------
// A layer is a zero-padded [W, W] weight tile (row i = input i) followed by
// W biases, in shared memory.

template <int W>
__device__ __forceinline__ void dense_relu(const float* __restrict__ layer,
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
#pragma unroll
  for (int o = 0; o < W; ++o) y[o] = fmaxf(y[o], 0.0f);
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

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

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

  for (int l = 0; l < n_total; ++l) {
    float* dst = smem + l * kLayer;
    const int d_in = p.layer_in[l], d_out = p.layer_out[l];
    const float* w_src = p.mlp + p.layer_w_off[l];
    for (int k = tid; k < W * W; k += kThreads) {
      const int i = k / W, o = k % W;
      dst[k] = (i < d_in && o < d_out) ? w_src[i * d_out + o] : 0.0f;
    }
    for (int o = tid; o < W; o += kThreads)
      dst[W * W + o] = o < d_out ? p.mlp[p.layer_b_off[l] + o] : 0.0f;
  }
  __syncthreads();

  const int ray = blockIdx.x * kThreads + tid;
  if (ray >= p.num_rays) return;

  const float ox = p.origins[3 * ray + 0], oy = p.origins[3 * ray + 1],
              oz = p.origins[3 * ray + 2];
  const float dx = p.directions[3 * ray + 0], dy = p.directions[3 * ray + 1],
              dz = p.directions[3 * ray + 2];
  const float near = p.near[ray], far = p.far[ray];
  const int b = p.grid_idx[ray];
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
  const int ns = p.num_samples;
  const int tot = ns + p.num_samples_inf;
  const float delta0 = ns > 1 ? (far - near) / (float)(ns - 1) : 1.0f;
  const uint32_t noise_i1_base =
      (uint32_t)p.noise_stride * (uint32_t)min(ray, p.num_rays_noise - 1);
  const uint32_t noise_i2_shift =
      (uint32_t)max(p.num_rays_noise, 16) * (uint32_t)p.noise_stride;

  float nlt = 0.0f, depth = 0.0f;
  float x[W], y[W];
  for (int s = 0; s < tot; ++s) {
    const float sf = (float)s;
    const float t = step_depth(p, near, far, sf);
    const float delta = sf < 1.0f ? delta0 : t - step_depth(p, near, far, sf - 1.0f);
    float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
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

#pragma unroll
    for (int c = 0; c < W; ++c) x[c] = 0.0f;
    const bool in_bounds =
        fabsf(px) <= 1.0f && fabsf(py) <= 1.0f && fabsf(pz) <= 1.0f;
    if (!p.mask_out_of_bounds || in_bounds) sample_grids<W>(p, b, px, py, pz, x);

    // The decoder's relu layers run in one loop, so the unrolled dense layer
    // is compiled once: j walks the trunk layers (relu after each, and
    // relu(feature) with no trunk layer), then the opacity head's hidden
    // layers, then the color head's hidden layers on trunk + encoding.  At
    // j == trunk_end the trunk output is kept; at j == opacity_end the
    // opacity head's last layer (no relu, output 0) reads x.
    if (n_t == 0) {
#pragma unroll
      for (int c = 0; c < W; ++c) x[c] = fmaxf(x[c], 0.0f);
    }
    float opacity_raw = 0.0f;
    for (int j = 0;; ++j) {
      if (j == trunk_end) {
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
    if (p.noise_sigma > 0.0f) {
      const uint32_t i1 = noise_i1_base + (uint32_t)s + 1u;
      const uint32_t i2 = i1 + noise_i2_shift;
      opacity_raw += int_to_randn((int32_t)i1, (int32_t)i2, p.noise_seed) *
                     p.noise_sigma;
    }
    const float sigma = p.gain * softplus(opacity_raw);

    // Emission-Absorption
    const float nlt_new = nlt + sigma * delta;
    const float w = expf(-nlt) - expf(-nlt_new);
    depth += w * t;
    for (int c = 0; c < p.color_chn; ++c)
      s_feat[c * kThreads + tid] += w * sigmoid(dense_out<W>(color_last, x, c));
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
// The caller validates shapes, devices and limits.
int lightplane_render_fw(
    const float* origins, const float* directions, const float* near,
    const float* far, const int* grid_idx, const float* enc, const float* grid,
    const float* mlp, float* depth, float* nlt, float* feat, int num_rays,
    int num_grids, const int* grid_meta, int grid_chn, int n_t, int n_o,
    int n_c, const int* mlp_widths, int enc_chn, int color_chn, int width,
    int num_samples, int num_samples_inf, float disparity_at_inf, float gain,
    int mask_out_of_bounds, int contract_coords, float noise_sigma,
    int noise_seed, int noise_stride, int num_rays_noise, void* stream) {
  if (num_grids < 1 || num_grids > kMaxGrids || n_o < 1 || n_c < 1 ||
      n_t > kMaxLayers || n_o > kMaxLayers || n_c > kMaxLayers ||
      (width != 32 && width != 64))
    return (int)cudaErrorInvalidValue;
  if (num_rays == 0) return (int)cudaSuccess;
  Params p;
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
  p.num_rays = num_rays;
  p.num_grids = num_grids;
  p.grid_chn = grid_chn;
  for (int g = 0; g < num_grids; ++g) {
    p.grid_row_offset[g] = grid_meta[5 * g];
    for (int k = 0; k < 4; ++k) p.grid_dims[g][k] = grid_meta[5 * g + 1 + k];
  }
  // per-layer widths and offsets into the flat parameter vector: each MLP
  // is [W_0, ..., W_{L-1}, b_0, ..., b_{L-1}]; trunk, opacity, color
  const int counts[3] = {n_t, n_o, n_c};
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
  p.enc_chn = enc_chn;
  p.color_chn = color_chn;
  p.num_samples = num_samples;
  p.num_samples_inf = num_samples_inf;
  p.disparity_at_inf = disparity_at_inf;
  p.gain = gain;
  p.mask_out_of_bounds = mask_out_of_bounds;
  p.contract_coords = contract_coords;
  p.noise_sigma = noise_sigma;
  p.noise_seed = noise_seed;
  p.noise_stride = noise_stride;
  p.num_rays_noise = num_rays_noise;

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
