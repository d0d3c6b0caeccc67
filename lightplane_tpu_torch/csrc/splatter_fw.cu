// Fused splat forward of the Lightplane splatter, for Hopper (sm_90a).
//
// Replaces lightplane_tpu/ops/kernels/splatter_pallas.py::_build_fw_kernel
// (launched by pallas_splat_fwd), and with it the TPU's big-grid variants
// splatter_big.py::_build_big_fw_kernel and splatter_sorted.py's
// _build_fw_kernel and crop_acc_fast.  Per ray and per march step it
// computes the point (optionally MeRF-contracted, background depths
// included) and the splat vector, the ray's encoding or with the MLP
// MLP(input_grid[point] + encoding) (relu after every layer but the last),
// and adds corner_weight * vec into the output grid-list feat [V, C] and
// corner_weight into the weight grid w [V] in the same pass: one pass with
// the C+1 fused weight channel.  Masked steps (mask_out_of_bounds and the
// point outside [-1, 1]^3) splat nothing; corners outside a sub-grid are
// dropped.
//
// Design.  One thread marches one ray; 128 rays per block.  The TPU kernels
// turn the scatter into stencil matmuls (a TPU has no atomic scatter), bin
// and sort the samples by octet for grids beyond VMEM, and relayout the
// 128-lane accumulator into [V, C]; here every corner is an atomicAdd
// straight into the [V, C] grid in device memory: one sm_90 float4
// reduction per 4 channels (rows stay 16-byte aligned because w lives in
// its own buffer, not as a 65th channel), and one scalar atomicAdd per
// channel where C % 4 != 0.  Without the MLP the encoding row is read from
// device memory (L1) at each corner, so any C runs.  With the MLP the block
// stages its layers in shared memory as zero-padded W x W tiles (W = 32 or
// 64) and the thread runs them on register arrays; a step whose point has
// no in-bounds corner skips the MLP.
//
// What bounds it.  At bench.py's splatter headline (262,144 rays, 96
// samples, one 160^3 x 64ch voxel grid) the kernel issues ~1.1e8 corner
// updates of 16 float4 reductions and one scalar each into a 1.05 GB grid,
// 20x the 50 MB L2: the atomics' read-modify-writes in L2 and device
// memory bound it, far above the least time for its bytes (the grid
// written once, 0.34 ms) and its 2 FLOPs per channel per corner.  Timed
// with parts switched off on an H100 (700 W, `chip_smoke.py --ablate`):
// 46.6 ms as built, 105.5 ms with one scalar atomicAdd per channel, 0.95 ms
// with no atomics: the reductions are ~98% of the kernel.  Aggregating a
// warp's updates to shared rows, or sorting samples by cell before the
// reduction, is later work.
//
// The timings with parts switched off build it with march_common.cuh's
// LIGHTPLANE_ABLATE: 1 = one scalar atomicAdd per channel, 2 = no atomics
// (the march and the corner walk alone).
//
// Numerics: f32; the atomics make the sums order-dependent from run to run.

#include "splat_common.cuh"

namespace {

using namespace lightplane;

constexpr int kThreads = 128;

// Splat of the encoding itself (no MLP), any channel count.
__global__ void __launch_bounds__(kThreads)
    splat_fw_enc_kernel(const SplatParams sp) {
  const Params& p = sp.m;
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  if (ray >= p.num_rays) return;
  const Ray r = load_ray(p, ray);
  const int C = sp.out_chn;
  const bool vec4 = float4_atomics(C);
  const float* enc = p.enc + (long long)ray * C;
  const int tot = p.num_samples + p.num_samples_inf;
  for (int s = 0; s < tot; ++s) {
    const Step st = march_step(p, r, s);
    if (p.mask_out_of_bounds && !st.in_bounds) continue;
    for_each_corner(sp.out, r.b, st, [&](long long row, float wgt) {
      if (!part_runs(kAblateNoAtomics, wgt)) return;
      float* dst = sp.feat + row * C;
      if (vec4) {
        const float4* src4 = reinterpret_cast<const float4*>(enc);
        float4* dst4 = reinterpret_cast<float4*>(dst);
        for (int c4 = 0; c4 < C / 4; ++c4) {
          const float4 e = __ldg(src4 + c4);
          atomicAdd(dst4 + c4, make_float4(wgt * e.x, wgt * e.y, wgt * e.z,
                                           wgt * e.w));
        }
      } else {
        for (int c = 0; c < C; ++c) atomicAdd(dst + c, wgt * __ldg(enc + c));
      }
      atomicAdd(sp.w + row, wgt);
    });
  }
}

// Splat of MLP(input_grid[point] + encoding).
template <int W>
__global__ void __launch_bounds__(kThreads)
    splat_fw_mlp_kernel(const SplatParams sp) {
  extern __shared__ __align__(16) float smem[];
  const Params& p = sp.m;
  constexpr int kLayer = W * W + W;
  const int L = p.n_layers[0];
  stage_layers<W>(p, smem, L);
  __syncthreads();

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  if (ray >= p.num_rays) return;
  const Ray r = load_ray(p, ray);
  const int C = sp.out_chn, C_in = p.grid_chn;
  const float* enc = p.enc + (long long)ray * C_in;
  const int tot = p.num_samples + p.num_samples_inf;
  float x[W], y[W];
  for (int s = 0; s < tot; ++s) {
    const Step st = march_step(p, r, s);
    if (p.mask_out_of_bounds && !st.in_bounds) continue;
    if (!touches(sp.out, r.b, st)) continue;
#pragma unroll
    for (int c = 0; c < W; ++c) x[c] = c < C_in ? __ldg(enc + c) : 0.0f;
    sample_grids<W>(p.grids, p.grid, C_in, r.b, st, x);
    // one call site of the unrolled layer: relu after all but the last
    for (int l = 0; l < L; ++l) {
      dense<W, false>(smem + l * kLayer, x, y);
      const bool relu = l < L - 1;
#pragma unroll
      for (int c = 0; c < W; ++c) x[c] = relu ? fmaxf(y[c], 0.0f) : y[c];
    }
    for_each_corner(sp.out, r.b, st, [&](long long row, float wgt) {
      atomic_add_row<W>(sp.feat + row * C, C, wgt, x);
      atomicAdd(sp.w + row, wgt);
    });
  }
}

long long fw_smem_bytes(int width, int n_layers) {
  return 4LL * n_layers * (width * width + width);
}

template <int W>
cudaError_t launch_mlp(const SplatParams& sp, size_t smem_bytes,
                       cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        splat_fw_mlp_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (sp.m.num_rays + kThreads - 1) / kThreads;
  splat_fw_mlp_kernel<W><<<blocks, kThreads, smem_bytes, stream>>>(sp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the MLP kernel needs.
long long lightplane_splat_fw_smem_bytes(int width, int n_layers) {
  return fw_smem_bytes(width, n_layers);
}

// Registers, spilled bytes and the thread limit of the kernel without the
// MLP (mlp = 0) or with it at `width`, into out[3]; a cudaError_t code.
int lightplane_splat_fw_attrs(int mlp, int width, int* out) {
  if (!mlp) return kernel_attrs(splat_fw_enc_kernel, out);
  return width == 32 ? kernel_attrs(splat_fw_mlp_kernel<32>, out)
                     : kernel_attrs(splat_fw_mlp_kernel<64>, out);
}

// Launches the splat forward on `stream`; returns a cudaError_t code.
//   out_meta, in_meta: host int[5 * n], per sub-grid (row offset, B, D, H, W)
//   n_layers: the MLP's layer count, 0 without it (input_grid, mlp, in_meta
//     and mlp_widths are then not read)
//   mlp_widths: host int[n_layers + 1]; width: 32 or 64
// The caller validates shapes, devices, alignment and limits, and
// zero-fills feat [V_out, out_chn] and w [V_out].
int lightplane_splat_fw(
    const float* origins, const float* directions, const float* near,
    const float* far, const int* grid_idx, const float* enc,
    const float* input_grid, const float* mlp, float* feat, float* w,
    int num_rays, int num_out_grids, const int* out_meta, int out_chn,
    int num_in_grids, const int* in_meta, int in_chn, int n_layers,
    const int* mlp_widths, int width, int num_samples, int num_samples_inf,
    float disparity_at_inf, int mask_out_of_bounds, int contract_coords,
    void* stream) {
  SplatParams sp = {};
  const int rc = fill_splat_params(
      sp, num_rays, num_out_grids, out_meta, out_chn, num_in_grids, in_meta,
      in_chn, n_layers, mlp_widths, width, num_samples, num_samples_inf,
      disparity_at_inf, mask_out_of_bounds, contract_coords);
  if (rc != (int)cudaSuccess) return rc;
  if (num_rays == 0) return (int)cudaSuccess;
  Params& p = sp.m;
  p.origins = origins;
  p.directions = directions;
  p.near = near;
  p.far = far;
  p.grid_idx = grid_idx;
  p.enc = enc;
  p.grid = input_grid;
  p.mlp = mlp;
  sp.feat = feat;
  sp.w = w;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_layers == 0) {
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    splat_fw_enc_kernel<<<blocks, kThreads, 0, s>>>(sp);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)fw_smem_bytes(width, n_layers);
  const cudaError_t e = width == 32 ? launch_mlp<32>(sp, smem, s)
                                    : launch_mlp<64>(sp, smem, s);
  return (int)e;
}

}  // extern "C"
