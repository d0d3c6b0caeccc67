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
// Design.  A warp marches one ray, 32 consecutive samples (a chunk) at a
// time; a block holds up to four warps (fewer where the MLP's weights leave
// too little shared memory), and one resident wave of blocks marches a
// contiguous run of rays each, so that every block stages the weights
// once.  As the TPU kernel
// runs a chunk of K steps as one matmul, the chunk is the M dimension of the
// decoder's products:
//   - geometry: lane l owns sample s = 32 chunk + l: its depth, step, point
//     and scaffold gate (march_common.cuh's march_step, scaffold_gate and
//     step_noise, with their __fmul_rn / rintf rounding);
//   - the scaffold skip: a chunk whose 32 gates are all 0 (__ballot_sync) is
//     skipped whole, no gather and no MLP, as the TPU kernel's
//     _scaffold_chunk_skip; inside a chunk a shut lane samples nothing and
//     adds exactly 0 to nlt, depth and the features;
//   - the gather: each lane computes its own sample's corners (rows and
//     weights) per sub-grid; then the warp reads the corner rows of four
//     samples at a time, a quarter-warp per sample and four channels per
//     lane (one 128-byte row per quarter-warp at 32 channels), summing in
//     registers, and writes a [32 samples][W + 4] tile X in shared memory.
//     Each sample's sum keeps march_common.cuh::sample_grids's order,
//     corner by corner.  The relu-field colour grid fills a second tile T
//     the same way;
//   - the decoder: every dense layer but the heads' last ones is
//     mma.sync.m16n8k8 over the tile, 2 M-tiles x W/8 N-tiles x W/8 k-steps,
//     in 3xTF32 (each operand split hi + lo; lo*hi, hi*lo, hi*hi into f32
//     accumulators that start at the bias), relu on the fragments, written
//     back to X.  The block stages the MLP weights once in shared memory in
//     the B fragments' order, so a lane loads its pair of a k-step as one
//     8-byte word; the +4 row pad of X puts an A fragment's 32 loads on 32
//     banks.  The trunk's output (or relu of the colour grid's sample) is
//     kept in T for the colour head, which reads T + the ray's encoding.
//     The heads' last layers (1 opacity, color_chn colours) are per-lane
//     dot products on the CUDA cores, in march_common.cuh::dense_out's
//     order, their weights staged compactly (only the outputs used), so
//     that at the headline's MLP four blocks of four warps fit an SM;
//   - compositing: lane l has a_l = sigma_l * delta_l; an inclusive warp
//     scan (__shfl_up_sync) plus the carried nlt gives nlt_new per lane and
//     nlt_prev = nlt_new of the lane before, and w = exp(-nlt_prev) -
//     exp(-nlt_new) as the JAX scan path writes it.  depth and the features
//     are summed over the chunk by butterflies, four at a time, and added
//     to the carry; the last lane's nlt_new carries to the next chunk.
// The TPU kernel's stencil matmuls, W1/W2/W3 windows, sample packing and
// packed ray table exist because a TPU has no gather; here the corner rows
// come straight from device memory (the headline's grid-list is 393 KB and
// stays in L2).
//
// What bounds it.  At the slice config (triplane 3 x 32^2 x 32ch, MLPs 2/2/2
// with hidden 32, 256 samples, 65,536 rays) the decoder is ~5k multiply-adds
// per ray-sample, ~150 GFLOP per frame: 2.3 ms at the FP32 peak, ~1.1 ms
// with its dense layers in 3xTF32 at the tensor cores' 495 TFLOP/s.  The
// gather reads 12 corner rows of 128 bytes per sample, 26 GB per frame from
// L1 and L2.  Timed with parts switched off on an H100 (700 W,
// `chip_smoke.py --ablate R1`): 8.0 ms as built, 4.7 without the sampling,
// 4.4 without the MLP, 1.2 with neither, so the gather and the decoder cost
// ~3.5 ms each and overlap little; what is left is the per-chunk work on
// the CUDA cores (geometry, ballots, scan, reductions) at 16 warps an SM.
// At the scene fitter's 4096 rays x 256 samples with its scaffold the
// kernel fills the card (1024 groups of four rays, a warp each) and takes
// ~0.5 ms where one thread per ray took ~2.5.  Register pressure decides
// the design: the gather sums each row onto the tile in shared memory
// rather than in registers, so the kernel fits 128 registers a thread and
// four blocks an SM.
//
// The two optional branches (the TPU kernel's scaffold gates,
// renderer_pallas.py::_scaffold_gate_base / _chunk_gates /
// _scaffold_chunk_skip, and its `cinfos` colour grid):
//   - scaffold gating (R3): each step's gate is the scaffold's value at the
//     nearest cell (march_common.cuh::scaffold_gate) and multiplies sigma
//     and the colour, as the plain version does.  (The TPU kernel thresholds
//     the gate at 0.5 and packs it into bits; the two agree on the binary
//     scaffolds that calculate_scaffold makes.)
//   - the relu-field colour grid (R1-rf): with no trunk MLP, the opacity
//     head reads relu(grid sample) and the colour head relu(colour grid
//     sample) + encoding, both grid-lists sampled at the same point.
//
// Numerics follow the JAX scan path: w = exp(-nlt) - exp(-nlt_new) as
// written there, and the shared helpers of march_common.cuh (bit-exact
// counter hash, IEEE transcendentals: no --use_fast_math).  Only the order
// of sums differs from a sequential march: the MMA accumulation, the scan
// and the per-chunk reductions.
//
// The timings with parts switched off build it with march_common.cuh's
// LIGHTPLANE_ABLATE: 8 = no grid sampling, 16 = no decoder MLP.

#include "wide_mlp.cuh"

namespace {

using namespace lightplane;

constexpr int kMaxWarps = 4;

// Floats of a head's last layer in shared memory: its [W, n_out] weights
// (row i = input i) and n_out biases, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int last_floats(int W, int n_out) {
  return (W * n_out + n_out + 3) / 4 * 4;
}

// Stages every MLP layer in shared memory, zero-padded: the layers that run
// on the tensor cores (all but the heads' last ones, in their order) as a
// [W, W] tile in fragment order followed by W biases, then the opacity
// head's last layer (output 0 only) and the colour head's (the color_chn
// rendered outputs), as last_out reads them.  No barrier.
template <int W>
__device__ __forceinline__ void stage_fw_layers(const Params& p, float* smem,
                                                int n_total, int opacity_end) {
  constexpr int kLayer = W * W + W;
  float* last = smem + (n_total - 2) * kLayer;
  for (int l = 0; l < n_total; ++l) {
    const int d_in = p.layer_in[l], d_out = p.layer_out[l];
    const float* w_src = p.mlp + p.layer_w_off[l];
    const float* b_src = p.mlp + p.layer_b_off[l];
    if (l == opacity_end || l == n_total - 1) {
      const int n_out = l == opacity_end ? 1 : p.color_chn;
      float* dst = l == opacity_end ? last : last + last_floats(W, 1);
      for (int k = threadIdx.x; k < W * n_out; k += blockDim.x) {
        const int i = k / n_out, o = k % n_out;
        dst[k] = i < d_in ? w_src[i * d_out + o] : 0.0f;
      }
      for (int o = threadIdx.x; o < n_out; o += blockDim.x)
        dst[W * n_out + o] = b_src[o];
      continue;
    }
    float* dst = smem + (l < opacity_end ? l : l - 1) * kLayer;
    for (int k = threadIdx.x; k < W * W; k += blockDim.x) {
      const int i = k / W, o = k % W;
      dst[frag_index(i, o, W / 8)] =
          (i < d_in && o < d_out) ? w_src[i * d_out + o] : 0.0f;
    }
    for (int o = threadIdx.x; o < W; o += blockDim.x)
      dst[W * W + o] = o < d_out ? b_src[o] : 0.0f;
  }
}

// Output o of a head's last layer (n_out outputs, stage_fw_layers) for the
// input x, in march_common.cuh::dense_out's order: the bias, then the
// products by ascending input.
template <int W>
__device__ __forceinline__ float last_out(const float* __restrict__ layer,
                                          int n_out, const float (&x)[W],
                                          int o) {
  float acc = layer[W * n_out + o];
#pragma unroll
  for (int i = 0; i < W; ++i) acc += x[i] * layer[i * n_out + o];
  return acc;
}

// X = relu(X @ layer + bias) for the chunk's 32 samples (R1's dense
// layers: a zero-padded [W, W] layer in fragment order, then W biases), and
// the same rows into T when given.
template <int W>
__device__ __forceinline__ void mma_layer(const float* __restrict__ layer,
                                          float* X, float* T, int lane) {
  mma_rows<W>(X, reinterpret_cast<const float2*>(layer), layer + W * W,
              W / 8, W / 8, true, nullptr, X, T, lane);
}

// Row `lane` of the tile X (stride W + 4) into registers, as float4s (a
// quarter-warp's eight rows fall on 32 banks).
template <int W>
__device__ __forceinline__ void load_row(const float* X, int lane,
                                         float (&x)[W]) {
  const float4* row = reinterpret_cast<const float4*>(X + lane * (W + 4));
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const float4 v = row[q];
    x[4 * q + 0] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}

// At W = 32 four blocks of four warps fit an SM's shared memory at the
// headline's MLP, so the registers are held to 128 a thread to let them.
template <int W>
__global__ void __launch_bounds__(32 * kMaxWarps, W == 32 ? 4 : 1)
    render_fw_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLayer = W * W + W;
  constexpr int S = W + 4;
  constexpr uint32_t kAll = 0xffffffffu;
  const int n_t = p.n_layers[0], n_o = p.n_layers[1], n_c = p.n_layers[2];
  const int n_total = n_t + n_o + n_c;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the MLP's layer order: trunk, opacity (hidden, last), color (hidden,
  // last); relu layer j (all but the heads' last layers) is tile j in
  // shared memory
  const int trunk_end = n_t;
  const int opacity_end = n_t + n_o - 1;
  const int n_relu_layers = n_total - 2;
  stage_fw_layers<W>(p, smem, n_total, opacity_end);
  const float* opacity_last = smem + n_relu_layers * kLayer;
  const float* color_last = opacity_last + last_floats(W, 1);
  // the warp's tiles: X, the layers' activations; T, the trunk's output or
  // relu of the colour grid's sample
  float* X = smem + n_relu_layers * kLayer + last_floats(W, 1) +
             last_floats(W, p.color_chn) + warp * 2 * 32 * S;
  float* T = X + 32 * S;
  __syncthreads();

  const int tot = p.num_samples + p.num_samples_inf;
  const bool cgrid = p.color_grid != nullptr;
  // a block takes a contiguous run of groups of `warps` neighbouring rays
  const int groups = (p.num_rays + warps - 1) / warps;
  const int blocks = gridDim.x, block = blockIdx.x;
  const int per_block = (groups + blocks - 1) / blocks;
  const int group_end = min(groups, (block + 1) * per_block);
  for (int group = block * per_block; group < group_end; ++group) {
    const int ray = group * warps + warp;
    if (ray >= p.num_rays) break;
    const Ray r = load_ray(p, ray);
    const float enc0 =
        lane < p.enc_chn ? p.enc[(long long)ray * p.enc_chn + lane] : 0.0f;
    const float enc1 = W == 64 && lane + 32 < p.enc_chn
                           ? p.enc[(long long)ray * p.enc_chn + lane + 32]
                           : 0.0f;
    float nlt = 0.0f, depth = 0.0f, feat0 = 0.0f, feat1 = 0.0f;
    for (int c0 = 0; c0 < tot; c0 += 32) {
      const int s = c0 + lane;
      Step st = {};
      float gate = 0.0f;
      if (s < tot) {
        st = march_step(p, r, s);
        gate = scaffold_gate(p, r.b, st);
      }
      // sigma = colour = 0 where the gate is 0: nothing to add
      const bool open = s < tot && gate != 0.0f;
      if (__ballot_sync(kAll, open) == 0u) continue;
      const uint32_t taken = __ballot_sync(
          kAll, open && (!p.mask_out_of_bounds || st.in_bounds) &&
                    part_runs(kAblateNoSampling, st.px));

      // the features, relu'd with no trunk (and kept as the trunk's
      // output); with a colour grid, relu of its sample in T
      gather_chunk<W>(p.grids, p.grid, p.grid_chn, r.b, st, taken, n_t == 0,
                      X, n_t == 0 && !cgrid ? T : nullptr, lane);
      if (cgrid)
        gather_chunk<W>(p.cgrids, p.color_grid, p.grid_chn, r.b, st, taken,
                        true, T, nullptr, lane);
      __syncwarp();

      // The decoder's relu layers run in one loop: j walks the trunk
      // layers, then the opacity head's hidden layers, then the color
      // head's hidden layers on trunk + encoding.  The trunk's last layer
      // also writes T; at j == opacity_end the opacity head's last layer
      // (no relu, output 0) reads X.
      float x[W];
      float opacity_raw = 0.0f;
      const bool mlp =
          __any_sync(kAll, part_runs(kAblateNoMlp, X[lane * S]));
      for (int j = 0; mlp; ++j) {
        if (j == opacity_end) {
          load_row<W>(X, lane, x);
          opacity_raw = last_out<W>(opacity_last, 1, x, 0);
          __syncwarp();
          for (int i = 0; i < 32; ++i) {
            X[i * S + lane] = T[i * S + lane] + enc0;
            if (W == 64) X[i * S + lane + 32] = T[i * S + lane + 32] + enc1;
          }
          __syncwarp();
        }
        if (j == n_relu_layers) break;
        mma_layer<W>(smem + j * kLayer, X,
                     !cgrid && j == trunk_end - 1 ? T : nullptr, lane);
      }
      if (mlp) load_row<W>(X, lane, x);
      if (open && p.noise_sigma > 0.0f) opacity_raw += step_noise(p, ray, s);
      const float sigma = open ? p.gain * softplus(opacity_raw) * gate : 0.0f;

      // Emission-Absorption: an inclusive scan of sigma * delta over the
      // chunk on top of the carried nlt
      float acc = sigma * st.delta;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(kAll, acc, o);
        if (lane >= o) acc += v;
      }
      const float nlt_new = nlt + acc;
      float nlt_prev = __shfl_up_sync(kAll, nlt_new, 1);
      if (lane == 0) nlt_prev = nlt;
      const float w = open ? expf(-nlt_prev) - expf(-nlt_new) : 0.0f;
      // w t and the colours, summed over the chunk four at a time by
      // interleaved butterflies (the same bits in every lane) into depth
      // and the features of channels lane and lane + 32
      for (int u0 = 0; u0 <= p.color_chn; u0 += 4) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = u0 + e - 1;
          v[e] = c < 0 ? w * st.t : 0.0f;
          if (open && c >= 0 && c < p.color_chn)
            v[e] = w * (sigmoid(mlp ? last_out<W>(color_last, p.color_chn,
                                                  x, c)
                                    : 0.0f) *
                        gate);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] += __shfl_xor_sync(kAll, v[e], o);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = u0 + e - 1;
          if (c < 0) depth += v[e];
          if (c == lane) feat0 += v[e];
          if (c == lane + 32) feat1 += v[e];
        }
      }
      nlt = __shfl_sync(kAll, nlt_new, 31);
      __syncwarp();  // the tiles are free for the next chunk
    }

    if (lane == 0) {
      p.depth[ray] = depth;
      p.nlt[ray] = nlt;
    }
    float* f = p.feat + (long long)ray * p.color_chn;
    if (lane < p.color_chn) f[lane] = feat0;
    if (lane + 32 < p.color_chn) f[lane + 32] = feat1;
  }
}

long long fw_smem_bytes(int width, int n_layers_total, int color_chn,
                        int warps) {
  return 4LL * ((long long)(n_layers_total - 2) * (width * width + width) +
                last_floats(width, 1) + last_floats(width, color_chn) +
                (long long)warps * 2 * 32 * (width + 4));
}

template <int W>
cudaError_t launch(const Params& p, int warps, size_t smem_bytes,
                   cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        render_fw_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return e;
  }
  // one resident wave of blocks, each marching a run of rays
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, render_fw_kernel<W>, 32 * warps, smem_bytes);
  if (e != cudaSuccess) return e;
  const long long needed = (p.num_rays + warps - 1) / warps;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(needed < wave ? needed : wave);
  render_fw_kernel<W><<<blocks, 32 * warps, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of `warps` warps (1, 2 or 4)
// needs at width 32 or 64: the padded layers and each warp's two
// [32][W + 4] tiles (the wide builds': lightplane_render_fw_wide_config).
long long lightplane_render_fw_smem_bytes(int width, int n_layers_total,
                                          int color_chn, int warps) {
  return fw_smem_bytes(width, n_layers_total, color_chn, warps);
}

// The wide build's (W = 96-512, renderer_wide.cuh) launch at these MLP
// widths (mlp_widths: host int[n_t + 1 + n_o + 1 + n_c + 1]): out[0] warps
// per block, out[1] a block's shared memory in bytes, out[2] the bytes of
// the packed layers, out[3] the blocks of the resident wave, out[4] a
// block's scratch bytes (past W = 256; 0 below): the workspace
// lightplane_render_fw takes is out[2] + out[3] out[4] bytes; a cudaError_t
// code.
int lightplane_render_fw_wide_config(int width, int n_t, int n_o, int n_c,
                                     const int* mlp_widths, int* out) {
  if (n_o < 1 || n_c < 1 || n_t > kMaxLayers || n_o > kMaxLayers ||
      n_c > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const int counts[3] = {n_t, n_o, n_c};
  fill_layers(p, counts, mlp_widths);
  return render_fw_wide_config(p, width, out);
}

// Launches the forward march on `stream`; returns a cudaError_t code.
//   grid_meta: host int[5 * num_grids], per sub-grid (row offset, B, D, H, W)
//   mlp_widths: host int[n_t + 1 + n_o + 1 + n_c + 1], the n_hidden tuples
//   width: the padded activation width, 32 or 64, or 96, 128, 192, 256,
//     384 or 512 (the wide build, renderer_wide.cuh)
//   warps: rays (warps) per block, 1, 2 or 4 (the wide build: 1-8)
//   scaffold, scaffold_dims: the [B, D, H, W] scaffold and its host int[4]
//     shape, or null
//   color_grid, num_color_grids, color_grid_meta: the relu-field colour
//     grid-list [Vc_total, grid_chn] and its table (as grid_meta's), or null
//   workspace: the wide build's (lightplane_render_fw_wide_config's bytes,
//     16-byte aligned; null for the others)
//   probe: the wide build's recording build (LIGHTPLANE_RELU_MASKS) only:
//     [R, steps, 2] floats, zero-filled (renderer_wide.cuh::write_probe),
//     or null
// The caller validates shapes, devices and limits.
int lightplane_render_fw(
    const float* origins, const float* directions, const float* near,
    const float* far, const int* grid_idx, const float* enc, const float* grid,
    const float* mlp, float* depth, float* nlt, float* feat, int num_rays,
    int num_grids, const int* grid_meta, int grid_chn, int n_t, int n_o,
    int n_c, const int* mlp_widths, int enc_chn, int color_chn, int width,
    int warps, int num_samples, int num_samples_inf, float disparity_at_inf,
    float gain, int mask_out_of_bounds, int contract_coords,
    float noise_sigma, int noise_seed, int noise_stride, int num_rays_noise,
    const float* scaffold, const int* scaffold_dims, const float* color_grid,
    int num_color_grids, const int* color_grid_meta, void* workspace,
    float* probe, void* stream) {
  if (width <= 64 && warps != 1 && warps != 2 && warps != kMaxWarps)
    return (int)cudaErrorInvalidValue;
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

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width > 64)
    return (int)launch_render_fw_wide(p, width, warps, workspace, probe, s);
  const size_t smem =
      (size_t)fw_smem_bytes(width, n_t + n_o + n_c, color_chn, warps);
  const cudaError_t e = width == 32 ? launch<32>(p, warps, smem, s)
                                    : launch<64>(p, warps, smem, s);
  return (int)e;
}

// Registers, spilled bytes and the thread limit of the kernel at `width`,
// into out[3]; a cudaError_t code.
int lightplane_render_fw_attrs(int width, int* out) {
  if (width > 64) return render_fw_wide_attrs(width, out);
  return width == 32 ? kernel_attrs(render_fw_kernel<32>, out)
                     : kernel_attrs(render_fw_kernel<64>, out);
}

const char* lightplane_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
