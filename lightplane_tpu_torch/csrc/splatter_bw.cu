// Adjoint of the fused splat of the Lightplane splatter, for Hopper
// (sm_90a).
//
// Replaces lightplane_tpu/ops/kernels/splatter_pallas.py::_build_bw_kernel
// (launched by pallas_splat_bwd), and with it the TPU's big-grid variants
// splatter_big.py::_build_big_bw_kernel and splatter_sorted.py's
// _build_bw_kernel and pad_grad_grid_fast.  The adjoint of a splat is a
// gather: each ray marches again and samples the incoming gradient of the
// output grid-list g_out [V, C] at every step (g_vec).  The weight grid
// carries no gradient (its collision features depend on no input), so only
// g_out comes in.
//   - Without the MLP, g_enc[ray] = sum over steps of g_vec: each thread sums
//     in registers and writes its row once; no atomics.  Channels go 32 at a
//     time (a register chunk), re-marching the ray per chunk, so any C runs.
//   - With the MLP, per step the thread recomputes the sample and the MLP
//     forward, keeping each layer's input in shared memory, backpropagates
//     g_vec through the MLP, adds the input gradient g_in to its g_enc and
//     splats corner_weight * g_in into the input grid's gradient with
//     float4 atomics.  The MLP's weight gradient is R2's design
//     (renderer_bw.cu, mlp_bwd.cuh): per step and layer the block writes the
//     output gradients of its rays to shared memory and forms the outer
//     products cooperatively into its own row of per-block partial sums,
//     which a second kernel sums into the flat g_mlp.  A step where no ray
//     of the block has a non-zero g_vec is skipped by the whole block.
// Masked steps (mask_out_of_bounds and the point outside [-1, 1]^3) get no
// gradient, as in the JAX package.
//
// LIGHTPLANE_RELU_MASKS=1 builds the variant that records, per ray and
// step, one bit per unit of every relu'd vector of the recomputed MLP
// forward (x > 0; mlp_bwd.cuh::record_mask), as R2's recording build does,
// so the plain version can be held to it on every ray: a relu input within
// rounding of 0 can otherwise send the two down different branches
// (splatter_bw.py::splat_bwd_cuda_relu_masks).  A step that the whole
// block skips (no ray has a non-zero g_vec) records nothing.
//
// What bounds it.  Without the MLP, at bench.py's splatter headline
// (262,144 rays, 96 samples, 160^3 x 64ch) it gathers ~1.1e8 corner rows
// of 256 bytes from a 1.05 GB gradient grid: the gather's sectors from L2
// and device memory.  It takes 9.7 ms on an H100 (700 W, `chip_smoke.py`),
// a fifth of the forward's atomics over the same corners.  With the MLP
// the per-step MLP backward and the block's barriers add ~3x the forward
// MLP's FP32 work.
//
// Numerics: f32; the input grid's gradient sums are order-dependent from
// run to run (atomics), g_enc and g_mlp are not.

#include "mlp_bwd.cuh"
#include "splat_common.cuh"

namespace {

using namespace lightplane;

constexpr int kThreads = 128;
constexpr int kChunk = 32;  // channels per register chunk, no-MLP adjoint
constexpr int kMaxRays = 128;

// g_enc = sum over steps of the sampled g_out (no MLP), any channel count.
__global__ void __launch_bounds__(kThreads)
    splat_bw_enc_kernel(const SplatParams sp) {
  const Params& p = sp.m;
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  if (ray >= p.num_rays) return;
  const Ray r = load_ray(p, ray);
  const int C = sp.out_chn;
  const bool vec4 = (C & 3) == 0;
  const int tot = p.num_samples + p.num_samples_inf;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc[k] = 0.0f;
    for (int s = 0; s < tot; ++s) {
      const Step st = march_step(p, r, s);
      if (p.mask_out_of_bounds && !st.in_bounds) continue;
      for_each_corner(sp.out, r.b, st, [&](long long row, float wgt) {
        const float* src = sp.g_out + row * C + c0;
        if (vec4) {
          const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll
          for (int k4 = 0; k4 < kChunk / 4; ++k4) {
            if (c0 + 4 * k4 < C) {
              const float4 g = __ldg(src4 + k4);
              acc[4 * k4 + 0] += wgt * g.x;
              acc[4 * k4 + 1] += wgt * g.y;
              acc[4 * k4 + 2] += wgt * g.z;
              acc[4 * k4 + 3] += wgt * g.w;
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            if (c0 + k < C) acc[k] += wgt * __ldg(src + k);
        }
      });
    }
    float* dst = p.g_enc + (long long)ray * C + c0;
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (c0 + k < C) dst[k] = acc[k];
  }
}

long long bw_smem_floats(int W, int rays, int n_layers) {
  return (long long)n_layers * (W * W + W)      // padded layers
         + (long long)(n_layers + 2) * W * rays  // layer inputs, enc, g_enc
         + (long long)W * (rays + 4);            // one layer's G
}

// The MLP adjoint: g_enc, the input grid's gradient and per-block partial
// sums of the MLP's weight gradient.
template <int W>
__global__ void __launch_bounds__(kMaxRays)
    splat_bw_mlp_kernel(const SplatParams sp) {
  extern __shared__ __align__(16) float smem[];
  const Params& p = sp.m;
  constexpr int kLayer = W * W + W;
  const int rays = blockDim.x;
  const int tid = threadIdx.x;
  const int L = p.n_layers[0];
  float* s_act = smem + L * kLayer;          // [L][W][rays]: layer inputs
  float* s_enc = s_act + L * W * rays;       // [W][rays]
  float* s_genc = s_enc + W * rays;          // [W][rays]
  float* s_G = s_genc + W * rays;            // [W][rays + 4]
  const int gstride = rays + 4;
  float* part = p.g_mlp_partial + (long long)blockIdx.x * L * kLayer;

  stage_layers<W>(p, smem, L);
  zero_owned_partial<W>(part, L, rays, tid);

  // threads past the last ray march a copy of it with a zero g_vec, so
  // every gradient they add to the block's sums is 0
  const int ray_in = blockIdx.x * rays + tid;
  const bool valid = ray_in < p.num_rays;
  const int ray = valid ? ray_in : p.num_rays - 1;
  const Ray r = load_ray(p, ray);
  const int C = sp.out_chn, C_in = p.grid_chn;
  for (int c = 0; c < W; ++c) {
    s_enc[c * rays + tid] =
        c < C_in ? p.enc[(long long)ray * C_in + c] : 0.0f;
    s_genc[c * rays + tid] = 0.0f;
  }
  __syncthreads();
#define ACT(k, c) s_act[((k) * W + (c)) * rays + tid]

  const int tot = p.num_samples + p.num_samples_inf;
  const bool out_vec4 = (C & 3) == 0;
  const bool record = kReluMasks && valid;
  float x[W], y[W], G[W], g_in[W];
  for (int s = 0; s < tot; ++s) {
    const Step st = march_step(p, r, s);
    const bool sampled = valid && (!p.mask_out_of_bounds || st.in_bounds);

    // g_vec: the gather of g_out, the gradient of the MLP's output
#pragma unroll
    for (int c = 0; c < W; ++c) G[c] = 0.0f;
    if (sampled) {
      for_each_corner(sp.out, r.b, st, [&](long long row, float wgt) {
        const float* src = sp.g_out + row * C;
        if (out_vec4) {
          const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll
          for (int c4 = 0; c4 < W / 4; ++c4) {
            if (4 * c4 < C) {
              const float4 g = __ldg(src4 + c4);
              G[4 * c4 + 0] += wgt * g.x;
              G[4 * c4 + 1] += wgt * g.y;
              G[4 * c4 + 2] += wgt * g.z;
              G[4 * c4 + 3] += wgt * g.w;
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < W; ++c)
            if (c < C) G[c] += wgt * __ldg(src + c);
        }
      });
    }
    bool active = false;
#pragma unroll
    for (int c = 0; c < W; ++c) active |= G[c] != 0.0f;
    if (!__syncthreads_or(active)) continue;

    // ---- forward recompute, keeping every layer's input ----
#pragma unroll
    for (int c = 0; c < W; ++c) x[c] = s_enc[c * rays + tid];
    if (sampled) sample_grids<W>(p.grids, p.grid, C_in, r.b, st, x);
#pragma unroll
    for (int c = 0; c < W; ++c) ACT(0, c) = x[c];
    for (int l = 0; l + 1 < L; ++l) {
      dense<W, true>(smem + l * kLayer, x, y);
#pragma unroll
      for (int c = 0; c < W; ++c) {
        x[c] = y[c];
        ACT(l + 1, c) = y[c];
      }
      if (record) record_mask<W>(p, ray, s, tot, l, y);
    }

    // ---- MLP backward, last layer first ----
    for (int l = L - 1;; --l) {
#pragma unroll
      for (int o = 0; o < W; ++o) s_G[o * gstride + tid] = G[o];
      __syncthreads();
      weight_grad<W>(part + l * kLayer, s_act + l * W * rays, nullptr, s_G,
                     rays, rays, tid);
      __syncthreads();
      dense_bwd<W>(smem + l * kLayer, G, g_in);
      if (l == 0) break;
      // the layer's input is the relu output of the layer before it
#pragma unroll
      for (int c = 0; c < W; ++c) G[c] = ACT(l, c) > 0.0f ? g_in[c] : 0.0f;
    }

    // ---- the MLP input is sample + encoding ----
#pragma unroll
    for (int c = 0; c < W; ++c) s_genc[c * rays + tid] += g_in[c];
    if (sampled) {
      for_each_corner(p.grids, r.b, st, [&](long long row, float wgt) {
        atomic_add_row<W>(p.g_grid + row * C_in, C_in, wgt, g_in);
      });
    }
  }
#undef ACT

  if (valid)
    for (int c = 0; c < C_in; ++c)
      p.g_enc[(long long)ray * C_in + c] = s_genc[c * rays + tid];
}

template <int W>
cudaError_t launch_mlp(const SplatParams& sp, int rays, size_t smem_bytes,
                       cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        splat_bw_mlp_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (sp.m.num_rays + rays - 1) / rays;
  if (blocks > 0) {
    splat_bw_mlp_kernel<W><<<blocks, rays, smem_bytes, stream>>>(sp);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  reduce_mlp_grad_kernel<W, false>
      <<<(sp.m.n_params + 255) / 256, 256, 0, stream>>>(sp.m, blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of `rays` rays of the MLP
// adjoint needs.
long long lightplane_splat_bw_smem_bytes(int width, int rays, int n_layers) {
  return 4LL * bw_smem_floats(width, rays, n_layers);
}

// Registers, spilled bytes and the thread limit of the adjoint without the
// MLP (mlp = 0) or with it at `width`, into out[3]; a cudaError_t code.
int lightplane_splat_bw_attrs(int mlp, int width, int* out) {
  if (!mlp) return kernel_attrs(splat_bw_enc_kernel, out);
  return width == 32 ? kernel_attrs(splat_bw_mlp_kernel<32>, out)
                     : kernel_attrs(splat_bw_mlp_kernel<64>, out);
}

// Launches the splat adjoint on `stream`; returns a cudaError_t code.
// Arguments as lightplane_splat_fw's, with g_out [V_out, out_chn] in and
// g_enc [R, enc_chn], the input grid's gradient (zero-filled by the
// caller), g_mlp and the [blocks, n_layers * (W*W + W)] partial buffer out
// (the last three only with the MLP), `rays_per_block` (128, 64 or 32)
// for the MLP adjoint, and for the recording build the zero-filled [R,
// steps, n_layers - 1, width / 32] mask words (null otherwise, and without
// the MLP).
int lightplane_splat_bw(
    const float* origins, const float* directions, const float* near,
    const float* far, const int* grid_idx, const float* enc,
    const float* input_grid, const float* mlp, const float* g_out,
    float* g_enc, float* g_input_grid, float* g_mlp, float* g_mlp_partial,
    int num_rays, int num_out_grids, const int* out_meta, int out_chn,
    int num_in_grids, const int* in_meta, int in_chn, int n_layers,
    const int* mlp_widths, int width, int rays_per_block, int num_samples,
    int num_samples_inf, float disparity_at_inf, int mask_out_of_bounds,
    int contract_coords, uint32_t* relu_masks, void* stream) {
  if (n_layers > 0 && rays_per_block != 128 && rays_per_block != 64 &&
      rays_per_block != 32)
    return (int)cudaErrorInvalidValue;
  if ((relu_masks != nullptr) != (kReluMasks && n_layers > 0))
    return (int)cudaErrorInvalidValue;
  SplatParams sp = {};
  const int rc = fill_splat_params(
      sp, num_rays, num_out_grids, out_meta, out_chn, num_in_grids, in_meta,
      in_chn, n_layers, mlp_widths, width, num_samples, num_samples_inf,
      disparity_at_inf, mask_out_of_bounds, contract_coords);
  if (rc != (int)cudaSuccess) return rc;
  Params& p = sp.m;
  p.origins = origins;
  p.directions = directions;
  p.near = near;
  p.far = far;
  p.grid_idx = grid_idx;
  p.enc = enc;
  p.grid = input_grid;
  p.mlp = mlp;
  p.g_enc = g_enc;
  p.g_grid = g_input_grid;
  p.g_mlp = g_mlp;
  p.g_mlp_partial = g_mlp_partial;
  p.relu_masks = relu_masks;
  p.n_mask_vecs = n_layers - 1;
  sp.g_out = g_out;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_layers == 0) {
    if (num_rays == 0) return (int)cudaSuccess;
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    splat_bw_enc_kernel<<<blocks, kThreads, 0, s>>>(sp);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)lightplane_splat_bw_smem_bytes(
      width, rays_per_block, n_layers);
  const cudaError_t e =
      width == 32 ? launch_mlp<32>(sp, rays_per_block, smem, s)
                  : launch_mlp<64>(sp, rays_per_block, smem, s);
  return (int)e;
}

}  // extern "C"
