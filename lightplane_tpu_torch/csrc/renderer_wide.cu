// The wide builds (padded widths W = 96 and 128: the widest of the grid's
// channels and the MLP layers) of the renderer's forward march (R1,
// renderer_fw.cu) and recompute backward (R2, renderer_bw.cu), for Hopper
// (sm_90a).  They replace the same TPU kernels as those
// (lightplane_tpu/ops/kernels/renderer_pallas.py::_build_fw_kernel and
// _build_bw_kernel), which take any width; renderer_fw.cu's and
// renderer_bw.cu's C functions dispatch here above W = 64, with the scaffold
// (R3) and relu-field colour grid (R1-rf) branches as there.
//
// Design.  Both march a ray per warp, 32 steps (a chunk) at a time, as R1
// does: lane l owns step 32 chunk + l's geometry and gate, a chunk whose
// gates are all shut is skipped whole, the corner rows are gathered into a
// [32][W + 4] tile (warp_chunk.cuh::gather_chunk, W / 32 channel slices a
// lane), and the dense layers run on the tensor cores over the tile in
// 3xTF32 with their weights read from device memory (wide_mlp.cuh: at W =
// 128 a 2/2/2 MLP is ~400 KB, more than a block's shared memory).  The
// heads' last layers are per-lane dot products (wide_last_out).
//   - R1 (render_fw_wide_kernel) keeps two tiles a warp, X and T, and
//     composites each chunk by a warp scan, as renderer_fw.cu does.
//   - R2 (render_bw_wide_kernel) walks the chunks last to first.  The
//     recomputed forward is R1's, the same functions in the same order, so
//     it gives R1's activations to the bit; it keeps every layer's input in
//     its own tile.  The transmittance is rewound over a chunk by a warp
//     scan from its far end (nlt_prev = nlt - the sum of sigma delta over
//     the chunk's later steps), and the suffix sum of the EA adjoint by a
//     second scan.  The decoder backward runs last layer first, a chunk at
//     a time: each layer's weight gradient X^T G on the tensor cores into
//     the warp's own row of sums in device memory (wide_weight_grad), its
//     input gradient G W^T on the tensor cores too, times the relu mask,
//     written over the layer's input tile.  The feature gradient is added
//     into the grid's rows with float4 reductions (scatter_chunk, the
//     gather's walk in reverse), the encoding's summed in registers and
//     written once per ray.  reduce_wide_sums_kernel sums the warps' rows
//     into the flat, unpadded g_mlp.
//
// What bounds it.  At the render headline at hidden 128 (triplane 3 x 32^2
// x 32ch, MLPs 2/2/2, 256 samples, 65,536 rays) the decoder is 53,760
// multiply-adds a ray-sample, 1.8 TFLOP a frame: ~11 ms at the TF32 rate in
// 3xTF32.  R2 does it three times over (recompute, input and weight
// gradients), and each chunk adds its weight-gradient sums into the warp's
// row (~220 KB read and written a chunk at that MLP): what the first build
// is bound by, before any tuning.
//
// Numerics: f32, the products in 3xTF32 with f32 sums, IEEE
// transcendentals (no --use_fast_math); the grid gradient's reductions are
// order-dependent from run to run, g_mlp and g_enc are not.

#include "wide_mlp.cuh"

namespace lightplane {
namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kFwWarps = 4;  // R1: warps (rays) per block
constexpr int kBwWarps = 4;  // R2: warps per block, at most
constexpr long long kMaxSmemBytes = 232448;  // a Hopper block's 227 KB

// ---- R1 ---------------------------------------------------------------

template <int W>
__global__ void __launch_bounds__(32 * kFwWarps, 1)
    render_fw_wide_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = W + 4, V = W / 32;
  const int n_t = p.n_layers[0], n_o = p.n_layers[1], n_c = p.n_layers[2];
  const int n_total = n_t + n_o + n_c;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int trunk_end = n_t;
  const int opacity_end = n_t + n_o - 1;
  const int n_relu_layers = n_total - 2;
  // the warp's tiles: X, the layers' activations; T, the trunk's output or
  // relu of the colour grid's sample
  float* X = smem + warp * 2 * 32 * S;
  float* T = X + 32 * S;
  for (int i = lane; i < 2 * 32 * S; i += 32) X[i] = 0.0f;
  __syncwarp();

  const int tot = p.num_samples + p.num_samples_inf;
  const bool cgrid = p.color_grid != nullptr;
  const int groups = (p.num_rays + warps - 1) / warps;
  const int per_block = (groups + gridDim.x - 1) / gridDim.x;
  const int group_end = min(groups, (blockIdx.x + 1) * per_block);
  for (int group = blockIdx.x * per_block; group < group_end; ++group) {
    const int ray = group * warps + warp;
    if (ray >= p.num_rays) break;
    const Ray r = load_ray(p, ray);
    float e[V], feat[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = 32 * v + lane;
      e[v] = c < p.enc_chn ? p.enc[(long long)ray * p.enc_chn + c] : 0.0f;
      feat[v] = 0.0f;
    }
    float nlt = 0.0f, depth = 0.0f;
    for (int c0 = 0; c0 < tot; c0 += 32) {
      const int s = c0 + lane;
      Step st = {};
      float gate = 0.0f;
      if (s < tot) {
        st = march_step(p, r, s);
        gate = scaffold_gate(p, r.b, st);
      }
      const bool open = s < tot && gate != 0.0f;
      if (__ballot_sync(kAll, open) == 0u) continue;
      const uint32_t taken = __ballot_sync(
          kAll, open && (!p.mask_out_of_bounds || st.in_bounds) &&
                    part_runs(kAblateNoSampling, st.px));

      gather_chunk<W>(p.grids, p.grid, p.grid_chn, r.b, st, taken, n_t == 0,
                      X, n_t == 0 && !cgrid ? T : nullptr, lane);
      if (cgrid)
        gather_chunk<W>(p.cgrids, p.color_grid, p.grid_chn, r.b, st, taken,
                        true, T, nullptr, lane);
      __syncwarp();

      // the relu layers in renderer_fw.cu's order; at j == opacity_end the
      // opacity head's last layer reads X, then X = T + the encoding
      float opacity_raw = 0.0f;
      const bool mlp =
          __any_sync(kAll, part_runs(kAblateNoMlp, X[lane * S]));
      for (int j = 0; mlp; ++j) {
        if (j == opacity_end) {
          opacity_raw = layer_out<W>(p, opacity_end, X + lane * S, 0);
          __syncwarp();
          for (int i = 0; i < 32; ++i) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              X[i * S + 32 * v + lane] = T[i * S + 32 * v + lane] + e[v];
          }
          __syncwarp();
        }
        if (j == n_relu_layers) break;
        relu_layer<W>(p, j < opacity_end ? j : j + 1, X, X,
                      !cgrid && j == trunk_end - 1 ? T : nullptr, lane);
      }
      if (open && p.noise_sigma > 0.0f) opacity_raw += step_noise(p, ray, s);
      const float sigma = open ? p.gain * softplus(opacity_raw) * gate : 0.0f;

      // Emission-Absorption, as renderer_fw.cu
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
      for (int u0 = 0; u0 <= p.color_chn; u0 += 4) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = u0 + k - 1;
          v[k] = c < 0 ? w * st.t : 0.0f;
          if (open && c >= 0 && c < p.color_chn)
            v[k] = w * (sigmoid(mlp ? layer_out<W>(p, n_total - 1,
                                                   X + lane * S, c)
                                    : 0.0f) *
                        gate);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] += __shfl_xor_sync(kAll, v[k], o);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = u0 + k - 1;
          if (c < 0) depth += v[k];
#pragma unroll
          for (int q = 0; q < V; ++q)
            if (c == 32 * q + lane) feat[q] += v[k];
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
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (32 * v + lane < p.color_chn) f[32 * v + lane] = feat[v];
  }
}

template <int W>
cudaError_t launch_fw(const Params& p, int warps, cudaStream_t stream) {
  const size_t smem = (size_t)render_fw_wide_smem_bytes(W, warps);
  cudaError_t e = cudaFuncSetAttribute(
      render_fw_wide_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, render_fw_wide_kernel<W>, 32 * warps, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long needed = (p.num_rays + warps - 1) / warps;
  const long long wave = (long long)sms * per_sm;
  render_fw_wide_kernel<W>
      <<<(int)(needed < wave ? needed : wave), 32 * warps, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- R2 ---------------------------------------------------------------

// Where each layer's sums start in a warp's row (wide_sum_floats each).
struct WideSums {
  int off[kMaxTotalLayers];
  int total;  // floats of a row, a multiple of 4
};

WideSums wide_sums(const Params& p) {
  WideSums ws = {};
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  int at = 0;
  for (int l = 0; l < n_total; ++l) {
    ws.off[l] = at;
    at += wide_sum_floats(p.layer_in[l], p.layer_out[l]);
  }
  ws.total = (at + 3) / 4 * 4;
  return ws;
}

// Tiles of one warp: the layer inputs (+ relu of the colour grid sample),
// the colour head's input, two gradient tiles.
__host__ __device__ __forceinline__ int bw_tiles(int n_total,
                                                 bool color_grid) {
  return n_total - 1 + (color_grid ? 1 : 0) + 3;
}

long long bw_smem_bytes(int W, int n_total, bool color_grid, int warps) {
  return 4LL * warps * bw_tiles(n_total, color_grid) * 32 * (W + 4);
}

// Adds w x row j of `tile` (channels [0, C)) into every in-bounds corner
// row of the [V, C] grid-list gradient (m, dst) at sample j's point, for
// the samples of the chunk whose bit is set in `taken`: gather_chunk's walk
// in reverse (lane 8 q + u, channels 32 v + 4 u .. + 3 of sample 4 i + q),
// one float4 reduction per 4 channels where C % 4 == 0.  b is the ray's
// batch (>= 0 where any bit is set).
template <int W>
__device__ __forceinline__ void scatter_chunk(const GridMeta& m, float* dst,
                                              int C, int b, const Step& st,
                                              uint32_t taken,
                                              const float* tile, int lane) {
  constexpr int S = W + 4, V = W / 32;
  const int q = lane >> 3, u = lane & 7;
  const bool vec4 = float4_atomics(C);
  if (b < 0 || taken == 0u) return;
  for (int g = 0; g < m.num_grids; ++g) {
    int row[8];
    float wt[8];
    grid_corners(m, g, b, st, row, wt);
    if (!((taken >> lane) & 1u)) {
#pragma unroll
      for (int k = 0; k < 8; ++k) row[k] = -1;
    }
    const int nz = m.dims[g][1] > 1 ? 2 : 1, ny = m.dims[g][2] > 1 ? 2 : 1,
              nx = m.dims[g][3] > 1 ? 2 : 1;
    for (int i = 0; i < 8; ++i) {
      if (!((taken >> (4 * i)) & 0xfu)) continue;
      const float* at = tile + (4 * i + q) * S + 4 * u;
      float4 gv[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        gv[v] = *reinterpret_cast<const float4*>(at + 32 * v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if ((k >> 2) >= nz || ((k >> 1) & 1) >= ny || (k & 1) >= nx) continue;
        const int r = __shfl_sync(kAll, row[k], 4 * i + q);
        const float w = __shfl_sync(kAll, wt[k], 4 * i + q);
        if (r < 0) continue;
        float* d = dst + (long long)r * C;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c = 32 * v + 4 * u;
          if (c >= C) continue;
          const float4 x = gv[v];
          if (vec4) {
            atomicAdd(reinterpret_cast<float4*>(d + c),
                      make_float4(w * x.x, w * x.y, w * x.z, w * x.w));
          } else {
            atomicAdd(d + c, w * x.x);
            if (c + 1 < C) atomicAdd(d + c + 1, w * x.y);
            if (c + 2 < C) atomicAdd(d + c + 2, w * x.z);
            if (c + 3 < C) atomicAdd(d + c + 3, w * x.w);
          }
        }
      }
    }
  }
}

// An inclusive suffix sum over the warp's lanes: lane l gets the sum of x
// over lanes l..31.
__device__ __forceinline__ float suffix_scan(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_down_sync(kAll, x, o);
    if (lane + o < 32) x += v;
  }
  return x;
}

template <int W>
__global__ void __launch_bounds__(32 * kBwWarps, 1)
    render_bw_wide_kernel(const Params p, const WideSums ws) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = W + 4, kTile = 32 * S, V = W / 32;
  const int n_t = p.n_layers[0], n_o = p.n_layers[1], n_c = p.n_layers[2];
  const int n_total = n_t + n_o + n_c;
  const bool cgrid = p.color_grid != nullptr;
  const int n_slots = n_total - 1 + (cgrid ? 1 : 0);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* tiles =
      smem + (long long)warp * bw_tiles(n_total, cgrid) * kTile;
  for (int i = lane; i < bw_tiles(n_total, cgrid) * kTile; i += 32)
    tiles[i] = 0.0f;
  __syncwarp();
  // Slot k holds the input of relu layer k of the forward (slot 0: the
  // feature, relu'd with no trunk; with a colour grid, slot cslot relu of
  // its sample), as renderer_bw.cu numbers them; layer L reads slot L below
  // the colour head, XC (slot cslot + the encoding) at its first layer and
  // slot L - 1 past it.  Gt and Ht hold the colour and opacity heads'
  // output gradients.
#define ACT(k) (tiles + (k) * kTile)
  float* XC = ACT(n_slots);
  float* Gt = ACT(n_slots + 1);
  float* Ht = ACT(n_slots + 2);
  float* acc = p.g_mlp_partial +
               (long long)(blockIdx.x * warps + warp) * ws.total;
  const int opacity_first = n_t, color_first = n_t + n_o;
  const int cslot = cgrid ? n_total - 1 : n_t;
  const int opacity_end = n_t + n_o - 1;
  const int n_relu_layers = n_total - 2;
  const int mask0 = n_t > 0 ? 1 : 0;
  const int tot = p.num_samples + p.num_samples_inf;
  const int c_pad = (p.color_chn + 7) / 8 * 8;

  const int groups = (p.num_rays + warps - 1) / warps;
  const int per_block = (groups + gridDim.x - 1) / gridDim.x;
  const int group_end = min(groups, (blockIdx.x + 1) * per_block);
  for (int group = blockIdx.x * per_block; group < group_end; ++group) {
    const int ray = group * warps + warp;
    if (ray >= p.num_rays) break;
    const Ray r = load_ray(p, ray);
    float e[V], genc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = 32 * v + lane;
      e[v] = c < p.enc_chn ? p.enc[(long long)ray * p.enc_chn + c] : 0.0f;
      genc[v] = 0.0f;
    }
    const float* g_feat = p.g_feat + (long long)ray * p.color_chn;
    const float g_depth = p.g_depth[ray], g_nlt = p.g_nlt[ray];
    float nlt_carry = p.nlt_final[ray], suffix_carry = 0.0f;
    for (int c0 = (tot - 1) / 32 * 32; c0 >= 0; c0 -= 32) {
      const int s = c0 + lane;
      Step st = {};
      float gate = 0.0f;
      if (s < tot) {
        st = march_step(p, r, s);
        gate = scaffold_gate(p, r.b, st);
      }
      // a chunk with every gate shut adds nothing: sigma = 0 leaves the
      // transmittance, the suffix sum and every cotangent as they are
      const bool open = s < tot && gate != 0.0f;
      if (__ballot_sync(kAll, open) == 0u) continue;
      const uint32_t taken = __ballot_sync(
          kAll, open && (!p.mask_out_of_bounds || st.in_bounds));
      const bool record = kReluMasks && s < tot;

      // ---- the forward, recomputed as R1's, each layer's input kept ----
      gather_chunk<W>(p.grids, p.grid, p.grid_chn, r.b, st, taken, n_t == 0,
                      ACT(0), nullptr, lane);
      if (cgrid)
        gather_chunk<W>(p.cgrids, p.color_grid, p.grid_chn, r.b, st, taken,
                        true, ACT(cslot), nullptr, lane);
      __syncwarp();
      if (record && n_t == 0)
        record_mask<W>(p, ray, s, tot, 0, ACT(0) + lane * S);
      if (record && cgrid)
        record_mask<W>(p, ray, s, tot, cslot - mask0, ACT(cslot) + lane * S);
      float opacity_raw = 0.0f;
      for (int j = 0;; ++j) {
        if (j == opacity_end) {
          opacity_raw = layer_out<W>(p, opacity_end,
                                     ACT(opacity_end) + lane * S, 0);
          for (int i = 0; i < 32; ++i) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              XC[i * S + 32 * v + lane] =
                  ACT(cslot)[i * S + 32 * v + lane] + e[v];
          }
          __syncwarp();
        }
        if (j == n_relu_layers) break;
        const int l = j < opacity_end ? j : j + 1;
        relu_layer<W>(p, l, l == color_first ? XC : ACT(j), ACT(j + 1),
                      nullptr, lane);
        if (record)
          record_mask<W>(p, ray, s, tot, j + 1 - mask0, ACT(j + 1) + lane * S);
      }
      if (open && p.noise_sigma > 0.0f) opacity_raw += step_noise(p, ray, s);
      const float sigma = open ? p.gain * softplus(opacity_raw) * gate : 0.0f;
      // the colours (before the gate) wait in the lane's row of Gt
      const float* xrow = (n_c == 1 ? XC : ACT(n_total - 2)) + lane * S;
      float* grow = Gt + lane * S;
      float g_dot = 0.0f;
      for (int c = 0; c < c_pad; ++c) {
        float col = 0.0f;
        if (c < p.color_chn) {
          col = sigmoid(layer_out<W>(p, n_total - 1, xrow, c));
          g_dot += __ldg(g_feat + c) * (col * gate);
        }
        grow[c] = col;
      }

      // ---- transmittance rewind + EA adjoint, over the chunk ----
      const float a = sigma * st.delta;
      const float suf = suffix_scan(a, lane);
      float later = __shfl_down_sync(kAll, suf, 1);
      if (lane == 31) later = 0.0f;
      const float nlt_run = nlt_carry - later;  // T_s includes step s
      const float nlt_prev = nlt_carry - suf;
      const float T = expf(-nlt_run);
      const float w = expf(-nlt_prev) - T;
      const float g_w = g_depth * st.t + g_dot;
      const float term_suf = suffix_scan(g_w * w, lane);
      float term_later = __shfl_down_sync(kAll, term_suf, 1);
      if (lane == 31) term_later = 0.0f;
      const float g_sigma =
          (g_w * T - (suffix_carry + term_later) + g_nlt) * st.delta;
      const float g_opacity =
          g_sigma * p.gain * sigmoid(opacity_raw) * gate;
      nlt_carry = __shfl_sync(kAll, nlt_prev, 0);
      suffix_carry += __shfl_sync(kAll, term_suf, 0);

      // the heads' output gradients: the colours' in Gt, the opacity's in
      // column 0 of Ht
      for (int c = 0; c < c_pad; ++c) {
        float gv = 0.0f;
        if (c < p.color_chn) {
          const float col = grow[c];
          gv = w * __ldg(g_feat + c) * gate * col * (1.0f - col);
        }
        grow[c] = gv;
      }
      float* hrow = Ht + lane * S;
      hrow[0] = g_opacity;
      for (int c = 1; c < 8; ++c) hrow[c] = 0.0f;
      __syncwarp();

      // ---- the decoder backward, last layer first ----
      const float* G = Gt;
      for (int L = n_total - 1;; --L) {
        const float* X = L == color_first ? XC
                                          : ACT(L > color_first ? L - 1 : L);
        wide_weight_grad<W>(acc + ws.off[L], X, G, p.layer_in[L],
                            p.layer_out[L], lane);
        if (L == color_first) {
          // the gradient of trunk + encoding, into g_enc; through the relu
          // of the colour grid's sample where there is one
          layer_input_grad<W>(p, L, G, nullptr, nullptr, XC, lane);
#pragma unroll
          for (int v = 0; v < V; ++v)
            for (int j = 0; j < 32; ++j) genc[v] += XC[j * S + 32 * v + lane];
          if (cgrid) {
            for (int j = 0; j < 32; ++j) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                const int k = j * S + 32 * v + lane;
                if (!(ACT(cslot)[k] > 0.0f)) XC[k] = 0.0f;
              }
            }
            __syncwarp();
          }
          G = Ht;
        } else if (L == opacity_first) {
          // the trunk output went through a relu (relu of the feature with
          // no trunk); with a colour grid only the opacity head reads it
          layer_input_grad<W>(p, L, G, ACT(n_t), cgrid ? nullptr : XC,
                              ACT(n_t), lane);
          G = ACT(n_t);
          if (n_t == 0) break;  // G is the feature gradient
        } else if (L == 0) {
          layer_input_grad<W>(p, L, G, nullptr, nullptr, ACT(0), lane);
          G = ACT(0);  // the feature gradient
          break;
        } else {
          // the layer's input is the relu output of the layer before it
          const int in = L > color_first ? L - 1 : L;
          layer_input_grad<W>(p, L, G, ACT(in), nullptr, ACT(in), lane);
          G = ACT(in);
        }
      }

      // ---- grid-gradient reductions ----
      scatter_chunk<W>(p.grids, p.g_grid, p.grid_chn, r.b, st, taken, G,
                       lane);
      if (cgrid)
        scatter_chunk<W>(p.cgrids, p.g_color_grid, p.grid_chn, r.b, st, taken,
                         XC, lane);
      __syncwarp();  // the tiles are free for the next chunk
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (32 * v + lane < p.enc_chn)
        p.g_enc[(long long)ray * p.enc_chn + 32 * v + lane] = genc[v];
  }
#undef ACT
}

// g_mlp[k] = the sum over the `rows` rows of g_mlp_partial of the entry of
// flat parameter k (WideSums, tc_index within a layer).
__global__ void reduce_wide_sums_kernel(const Params p, const WideSums ws,
                                        int rows) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.n_params) return;
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  int entry = 0;
  for (int L = 0; L < n_total; ++L) {
    const int d_in = p.layer_in[L], d_out = p.layer_out[L];
    const int w_off = p.layer_w_off[L], b_off = p.layer_b_off[L];
    const int no = (d_out + 7) / 8, mi = (d_in + 15) / 16;
    if (k >= w_off && k < w_off + d_in * d_out) {
      const int i = (k - w_off) / d_out, o = (k - w_off) % d_out;
      entry = ws.off[L] + tc_index(i, o, no);
      break;
    }
    if (k >= b_off && k < b_off + d_out) {
      entry = ws.off[L] + mi * no * 128 + (k - b_off);
      break;
    }
  }
  float acc = 0.0f;
  for (int b = 0; b < rows; ++b)
    acc += p.g_mlp_partial[(long long)b * ws.total + entry];
  p.g_mlp[k] = acc;
}

// Warps per block (the most, up to kBwWarps, whose tiles one block's shared
// memory holds), the block's shared memory and the resident wave of blocks.
template <int W>
cudaError_t bw_config(const Params& p, bool color_grid, int* warps,
                      size_t* smem, int* wave) {
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  *warps = kBwWarps;
  while (*warps > 1 &&
         bw_smem_bytes(W, n_total, color_grid, *warps) > kMaxSmemBytes)
    --*warps;
  *smem = (size_t)bw_smem_bytes(W, n_total, color_grid, *warps);
  if ((long long)*smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      render_bw_wide_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, render_bw_wide_kernel<W>, 32 * *warps, *smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *wave = sms * per_sm;
  return cudaSuccess;
}

template <int W>
cudaError_t launch_bw(const Params& p, cudaStream_t stream) {
  int warps = 0, wave = 0;
  size_t smem = 0;
  const bool cgrid = p.color_grid != nullptr;
  cudaError_t e = bw_config<W>(p, cgrid, &warps, &smem, &wave);
  if (e != cudaSuccess) return e;
  const WideSums ws = wide_sums(p);
  const long long groups = (p.num_rays + warps - 1) / warps;
  const int blocks = (int)(groups < wave ? groups : wave);
  if (blocks > 0) {
    render_bw_wide_kernel<W><<<blocks, 32 * warps, smem, stream>>>(p, ws);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  reduce_wide_sums_kernel<<<(p.n_params + 255) / 256, 256, 0, stream>>>(
      p, ws, blocks * warps);
  return cudaGetLastError();
}

}  // namespace

long long render_fw_wide_smem_bytes(int width, int warps) {
  return 4LL * warps * 2 * 32 * (width + 4);
}

cudaError_t launch_render_fw_wide(const Params& p, int width, int warps,
                                  cudaStream_t stream) {
  if (width == 96) return launch_fw<96>(p, warps, stream);
  if (width == 128) return launch_fw<128>(p, warps, stream);
  return cudaErrorInvalidValue;
}

int render_fw_wide_attrs(int width, int* out) {
  if (width == 96) return kernel_attrs(render_fw_wide_kernel<96>, out);
  if (width == 128) return kernel_attrs(render_fw_wide_kernel<128>, out);
  return (int)cudaErrorInvalidValue;
}

int render_bw_wide_config(const Params& p, int width, bool color_grid,
                          int* out) {
  int warps = 0, wave = 0;
  size_t smem = 0;
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  cudaError_t e = cudaErrorInvalidValue;
  if (width == 96) e = bw_config<96>(p, color_grid, &warps, &smem, &wave);
  if (width == 128) e = bw_config<128>(p, color_grid, &warps, &smem, &wave);
  out[0] = warps;
  out[1] = wave * warps;
  out[2] = wide_sums(p).total;
  out[3] = (int)(smem ? smem : bw_smem_bytes(width, n_total, color_grid, 1));
  return (int)e;
}

cudaError_t launch_render_bw_wide(const Params& p, int width,
                                  cudaStream_t stream) {
  if (width == 96) return launch_bw<96>(p, stream);
  if (width == 128) return launch_bw<128>(p, stream);
  return cudaErrorInvalidValue;
}

int render_bw_wide_attrs(int width, int* out) {
  if (width == 96) return kernel_attrs(render_bw_wide_kernel<96>, out);
  if (width == 128) return kernel_attrs(render_bw_wide_kernel<128>, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace lightplane
