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

#include "march_common.cuh"

namespace {

using namespace lightplane;

constexpr int kMaxWarps = 4;

// B fragment order of a [W, W] layer (input i, output o): per N-tile nt and
// k-step ks, lane 4 g + t holds (k t, n g) and (k t + 4, n g) of the tile as
// one float2.
template <int W>
__device__ __forceinline__ int frag_index(int i, int o) {
  const int ks = i >> 3, hi = (i >> 2) & 1, t = i & 3;
  const int nt = o >> 3, g = o & 7;
  return (((nt * (W / 8) + ks) * 32 + g * 4 + t) << 1) + hi;
}

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
      dst[frag_index<W>(i, o)] =
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

// The corners of sub-grid g of m at the point of st, batch b >= 0, with
// march_common.cuh::for_each_corner's arithmetic: corner k = 4 dz + 2 dy +
// dx (k ascending is that walk's order) has row[k] and weight wt[k];
// row[k] = -1 where the corner lies outside the grid or on the far side of
// a singleton axis.  Unrolled, so both arrays stay in registers.
__device__ __forceinline__ void grid_corners(const GridMeta& m, int g, int b,
                                             const Step& st, int (&row)[8],
                                             float (&wt)[8]) {
  const int D = m.dims[g][1], H = m.dims[g][2], Wd = m.dims[g][3];
  const float fx = grid_coord(st.px, Wd);
  const float fy = grid_coord(st.py, H);
  const float fz = grid_coord(st.pz, D);
  const float x0 = floorf(fx), y0 = floorf(fy), z0 = floorf(fz);
  const float tx = fx - x0, ty = fy - y0, tz = fz - z0;
  const int nz = D > 1 ? 2 : 1, ny = H > 1 ? 2 : 1, nx = Wd > 1 ? 2 : 1;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float cz = z0 + (float)dz;
    const float wz = dz ? tz : (1.0f - tz);
    const bool in_z = dz < nz && cz >= 0.0f && cz < (float)D;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float cy = y0 + (float)dy;
      const float wy = dy ? ty : (1.0f - ty);
      const bool in_y = dy < ny && cy >= 0.0f && cy < (float)H;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float cx = x0 + (float)dx;
        const float wx = dx ? tx : (1.0f - tx);
        const bool in = in_z && in_y && dx < nx && cx >= 0.0f &&
                        cx < (float)Wd;
        const int k = 4 * dz + 2 * dy + dx;
        row[k] = -1;
        if (in)
          row[k] = (int)(m.row_offset[g] +
                         (((long long)b * D + (int)cz) * H + (int)cy) *
                             (long long)Wd +
                         (int)cx);
        wt[k] = wx * wy * wz;
      }
    }
  }
}

// Row j of `tile` (stride W + 4) gets the linear sample of every sub-grid of
// the [V, C] grid-list (m, grid) at sample j's point, for the samples of the
// chunk whose bit is set in `taken`, and 0 for the others (and in channels
// C..W-1).  With `relu` the sum goes through a relu; `tile2`, when given,
// gets the same rows.  `st` is the lane's own sample, b the ray's batch (< 0:
// nothing is read).  The warp reads four samples' rows at a time: lane
// 8 q + u sums channels 4u..4u+3 (and 32 more at W = 64) of sample 4 i + q,
// corner by corner in march_common.cuh::sample_grids's order onto the
// row's sum so far, and gets each corner's row and weight from the
// sample's lane by a shuffle.
template <int W>
__device__ __forceinline__ void gather_chunk(const GridMeta& m,
                                             const float* __restrict__ grid,
                                             int C, int b, const Step& st,
                                             uint32_t taken, bool relu,
                                             float* tile, float* tile2,
                                             int lane) {
  constexpr int S = W + 4, V = W / 32;
  const int q = lane >> 3, u = lane & 7;
  const bool vec4 = (C & 3) == 0;
  if (b < 0) taken = 0u;
  for (int g = 0; g < m.num_grids; ++g) {
    int row[8];
    float wt[8];
    grid_corners(m, g, b, st, row, wt);
    if (!((taken >> lane) & 1u)) {
#pragma unroll
      for (int k = 0; k < 8; ++k) row[k] = -1;
    }
    // the corners that no sample of this sub-grid has (singleton axes)
    const int nz = m.dims[g][1] > 1 ? 2 : 1, ny = m.dims[g][2] > 1 ? 2 : 1,
              nx = m.dims[g][3] > 1 ? 2 : 1;
    const bool last = g == m.num_grids - 1;
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      float4 acc[V];
      float* at = tile + (4 * i + q) * S + 4 * u;
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] = g == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                        : *reinterpret_cast<const float4*>(at + 32 * v);
      if ((taken >> (4 * i)) & 0xfu) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if ((k >> 2) >= nz || ((k >> 1) & 1) >= ny || (k & 1) >= nx)
            continue;
          const int r = __shfl_sync(0xffffffffu, row[k], 4 * i + q);
          const float w = __shfl_sync(0xffffffffu, wt[k], 4 * i + q);
          if (r < 0) continue;
          const float* src = grid + (long long)r * C;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c = 32 * v + 4 * u;
            if (c >= C) continue;
            float4 x;
            if (vec4) {
              x = __ldg(reinterpret_cast<const float4*>(src + c));
            } else {
              x.x = __ldg(src + c);
              x.y = c + 1 < C ? __ldg(src + c + 1) : 0.0f;
              x.z = c + 2 < C ? __ldg(src + c + 2) : 0.0f;
              x.w = c + 3 < C ? __ldg(src + c + 3) : 0.0f;
            }
            acc[v].x += w * x.x;
            acc[v].y += w * x.y;
            acc[v].z += w * x.z;
            acc[v].w += w * x.w;
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float4 a = acc[v];
        if (last && relu) {
          a.x = fmaxf(a.x, 0.0f);
          a.y = fmaxf(a.y, 0.0f);
          a.z = fmaxf(a.z, 0.0f);
          a.w = fmaxf(a.w, 0.0f);
        }
        *reinterpret_cast<float4*>(at + 32 * v) = a;
        if (last && tile2 != nullptr)
          *reinterpret_cast<float4*>(tile2 + (at - tile) + 32 * v) = a;
      }
    }
  }
}

// X = relu(X @ layer + bias) for the chunk's 32 samples on the tensor cores
// in 3xTF32 (layer in fragment order, stage_fw_layers), and the same rows
// into T when given.  At W = 32 both M-tiles go in one pass, sharing each
// B fragment's split; at W = 64 one M-tile per pass, so the accumulators
// stay at W/2 registers.
template <int W>
__device__ __forceinline__ void mma_layer(const float* __restrict__ layer,
                                          float* X, float* T, int lane) {
  constexpr int S = W + 4, KS = W / 8, NT = W / 8;
  constexpr int kMT = W == 32 ? 2 : 1;
  const int g = lane >> 2, t = lane & 3;
  const float* bias = layer + W * W;
  const float2* frag = reinterpret_cast<const float2*>(layer);
#pragma unroll
  for (int m0 = 0; m0 < 2; m0 += kMT) {
    float d[kMT][NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float b0 = bias[nt * 8 + 2 * t], b1 = bias[nt * 8 + 2 * t + 1];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        d[mt][nt][0] = b0;
        d[mt][nt][1] = b1;
        d[mt][nt][2] = b0;
        d[mt][nt][3] = b1;
      }
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* a = X + ((m0 + mt) * 16 + g) * S + ks * 8 + t;
        split_tf32(a[0], ah[mt][0], al[mt][0]);
        split_tf32(a[8 * S], ah[mt][1], al[mt][1]);
        split_tf32(a[4], ah[mt][2], al[mt][2]);
        split_tf32(a[8 * S + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 bv = frag[(nt * KS + ks) * 32 + lane];
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bv.x, bh0, bl0);
        split_tf32(bv.y, bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_tf32(d[mt][nt], al[mt], bh0, bh1);
          mma_tf32(d[mt][nt], ah[mt], bl0, bl1);
          mma_tf32(d[mt][nt], ah[mt], bh0, bh1);
        }
      }
    }
    __syncwarp();  // every lane's reads of these rows are done
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int at = ((m0 + mt) * 16 + g) * S + nt * 8 + 2 * t;
        const float y0 = fmaxf(d[mt][nt][0], 0.0f);
        const float y1 = fmaxf(d[mt][nt][1], 0.0f);
        const float y2 = fmaxf(d[mt][nt][2], 0.0f);
        const float y3 = fmaxf(d[mt][nt][3], 0.0f);
        X[at] = y0;
        X[at + 1] = y1;
        X[at + 8 * S] = y2;
        X[at + 8 * S + 1] = y3;
        if (T != nullptr) {
          T[at] = y0;
          T[at + 1] = y1;
          T[at + 8 * S] = y2;
          T[at + 8 * S + 1] = y3;
        }
      }
    }
  }
  __syncwarp();
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
// needs: the padded layers and each warp's two [32][W + 4] tiles.
long long lightplane_render_fw_smem_bytes(int width, int n_layers_total,
                                          int color_chn, int warps) {
  return fw_smem_bytes(width, n_layers_total, color_chn, warps);
}

// Launches the forward march on `stream`; returns a cudaError_t code.
//   grid_meta: host int[5 * num_grids], per sub-grid (row offset, B, D, H, W)
//   mlp_widths: host int[n_t + 1 + n_o + 1 + n_c + 1], the n_hidden tuples
//   width: the padded activation width, 32 or 64
//   warps: rays (warps) per block, 1, 2 or 4
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
    int warps, int num_samples, int num_samples_inf, float disparity_at_inf,
    float gain, int mask_out_of_bounds, int contract_coords,
    float noise_sigma, int noise_seed, int noise_stride, int num_rays_noise,
    const float* scaffold, const int* scaffold_dims, const float* color_grid,
    int num_color_grids, const int* color_grid_meta, void* stream) {
  if (warps != 1 && warps != 2 && warps != kMaxWarps)
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

  const size_t smem =
      (size_t)fw_smem_bytes(width, n_t + n_o + n_c, color_chn, warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = width == 32 ? launch<32>(p, warps, smem, s)
                                    : launch<64>(p, warps, smem, s);
  return (int)e;
}

// Registers, spilled bytes and the thread limit of the kernel at `width`,
// into out[3]; a cudaError_t code.
int lightplane_render_fw_attrs(int width, int* out) {
  return width == 32 ? kernel_attrs(render_fw_kernel<32>, out)
                     : kernel_attrs(render_fw_kernel<64>, out);
}

const char* lightplane_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
