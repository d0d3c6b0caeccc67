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
// g_out comes in.  Masked steps (mask_out_of_bounds and the point outside
// [-1, 1]^3) get no gradient, as in the JAX package.
//
// Without the MLP, g_enc[ray] = the sum over steps of g_vec
// (splat_bw_enc_kernel).  A group of lanes marches one ray once: a
// power-of-two group of up to a warp, so several rays share a warp below
// 256 channels.  Lane j of the group works out step s0 + j's corner rows
// and weights per sub-grid (warp_chunk.cuh's grid_corners,
// for_each_corner's arithmetic); then the group walks its steps, takes
// each step's corners from its lane by shuffles (none for the corners a
// plane lacks), issues every corner load before any add, and sums into
// registers.  A lane owns kV channels of a row, two 16-byte loads where C
// % 4 == 0 (four where C is 16 or 32: a group of at most two lanes; else
// one 8- or 4-byte load), so the group reads a corner row as contiguous
// accesses and each lane spends its shuffles on 8 or 16 channels;
// above 32 kV channels it walks passes over the row, re-reading the corner
// but never re-marching.  g_enc is written once per ray: no atomics,
// bit-deterministic.
//
// With the MLP, over slices of the rays that bound their memory
// (splatter_bw.py::adjoint_slices):
//   The gather (splat_bw_enc_kernel<kV, true>) stages each step's g_vec
//     [rays of the slice, steps, C] and, run again over the input
//     grid-list, its input sample [.., steps, C_in] (zeros where a step is
//     masked): these are the latency-bound reads, done at the gather's
//     occupancy rather than pass A's.
//   Pass A, ray-major (splat_bw_mlp_kernel): a warp per ray over chunks of
//     32 steps, as R1 (renderer_fw.cu) marches.  The warp loads the
//     chunk's staged g_vec and samples into [32][W + 4] tiles (row j =
//     step j) in one round of independent loads; a chunk whose g_vec is 0
//     everywhere is skipped by its warp alone.  Otherwise X_0 = sample +
//     encoding, and the forward (warp_chunk.cuh::mma_rows, 3xTF32
//     mma.sync) keeps every layer's input X_l in its own tile; then the
//     backward, last layer first: the weight gradient X_l^T G_l on the
//     tensor cores (mlp_bwd.cuh::tc_weight_grad_rows, each chunk's sum from
//     0 added in f32) into the warp's own sums in shared memory, the bias
//     gradient as column sums, and the input gradient G_l W_l^T by
//     mma_rows against the layer staged a second time in the transposed
//     fragment order, times the relu mask (X_l > 0), written over X_l.
//     Layers run at their own widths (rounded up to 8), not padded to W.
//     The MLP input gradient g_in is summed into g_enc in registers and
//     written over the staged samples, one row of C_in floats per step
//     (zeros for a skipped chunk).  No block barrier inside the march; at
//     the end the block adds its warps' sums into its own row of
//     g_mlp_partial (rows add across the slices' launches), and
//     reduce_partial_kernel sums the rows into the flat g_mlp: g_enc and
//     g_mlp are free of atomics, deterministic.  At padded widths 96 to
//     256 (splat_bw_mlp_wide_kernel, below) no layer fits beside the tiles:
//     a block's warps work on 16-row chunks in lockstep, the layers staged
//     once a block through R2-wide's ring (wide_mlp.cuh) and multiplied by
//     wgmma a warpgroup, each layer's weight gradient summed over the
//     block's rows into the block's row (block_weight_grad); the rest as
//     above.
//   Pass B, brick-major: S1's planned splat (splatter_fw.cu) over the input
//     grid-list, one launch per input sub-grid, each step's staged g_in as
//     the value splatted: the input grid's gradient is summed in
//     warp-private shared-memory tiles per brick and each touched row
//     flushed once with float4 reductions.  Staging g_in costs 128 bytes a
//     step at 32 channels, where recomputing it per input plane in brick
//     order would gather g_out's 8 corner rows of 256 bytes a step from
//     all over the output gradient, once per plane.
//
// LIGHTPLANE_RELU_MASKS=1 builds the variant that records, per ray and
// step, one bit per unit of every relu'd vector of the recomputed MLP
// forward (x > 0; mlp_bwd.cuh::record_mask), as R2's recording build does,
// so the plain version can be held to it on every ray: a relu input within
// rounding of 0 can otherwise send the two down different branches
// (splatter_bw.py::splat_bwd_cuda_relu_masks).  A chunk where a ray's
// g_vec is 0 at every step records nothing for that ray (its warp skips
// it, or above 64 writes nothing there).
//
// What bounds it.  Without the MLP, at bench.py's splatter headline
// (262,144 rays, 96 samples, 160^3 x 64ch) it gathers ~1.1e8 corner rows
// of 256 bytes from a 1.05 GB gradient grid: latency and the sectors of
// those rows.  With the MLP (32 -> 32 -> 64, a 3 x 128^2 x 32ch input) the
// three products (forward, input gradient, weight gradient) are 18,432
// FLOPs a sampled step, <= 0.94 ms at the tensor cores' TF32 rate for the
// headline's ~2.5e7 steps, ~3x that in 3xTF32; the g_out gather is the
// no-MLP kernel's, the staging ~13 GB written and read once.  At 32 ->
// 128 -> 128 into 128 channels the three products are ~2.1e12 FLOPs, 14.2
// ms in 3xTF32 at the tensor cores' rate; the wide pass A took ~99 ms on
// an H100 (PERF.md, section 6), ~54 of it the weight gradient by mma.sync
// (X^T and G are not K-major, as wgmma's TF32 operands must be).
//
// The timings with parts switched off build it with march_common.cuh's
// LIGHTPLANE_ABLATE: 128 = no input-grid gradient (no pass B splat), 256 =
// no weight gradient, 512 = the gathers alone (pass A skips every chunk).
//
// Numerics: f32, the products in 3xTF32 with f32 sums; the input grid's
// gradient sums are order-dependent from run to run (pass B's reductions),
// g_enc and g_mlp are not.

#include "splat_common.cuh"
#include "wide_mlp.cuh"

namespace {

using namespace lightplane;

constexpr unsigned kAll = 0xffffffffu;

// ---- without the MLP: the gather ------------------------------------------

constexpr int kEncThreads = 128;
constexpr int kEncRegs = 16;  // channels a lane sums: kV x passes

// v = src[0:kV) for the kV channels a lane owns: kV / 4 16-byte loads
// (kV = 8 or 16; each only where it starts below C), one 8-byte or one
// 4-byte load.  kLdg reads through the read-only cache (data the kernel
// does not write).
template <int kV, bool kLdg = true>
__device__ __forceinline__ void load_vec(const float* src, int c, int C,
                                         float (&v)[kV]) {
  if constexpr (kV >= 8) {
#pragma unroll
    for (int h = 0; h < kV / 4; ++h) {
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4* at = reinterpret_cast<const float4*>(src) + h;
      if (c + 4 * h < C) x = kLdg ? __ldg(at) : *at;
      v[4 * h + 0] = x.x;
      v[4 * h + 1] = x.y;
      v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    }
  } else if constexpr (kV == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = __ldg(src);
  }
}

// dst[0:kV) = v, the kV channels at c of C, as load_vec reads them.
template <int kV>
__device__ __forceinline__ void store_vec(float* dst, int c, int C,
                                          const float (&v)[kV]) {
  if constexpr (kV >= 8) {
#pragma unroll
    for (int h = 0; h < kV / 4; ++h)
      if (c + 4 * h < C)
        reinterpret_cast<float4*>(dst)[h] =
            make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  } else if constexpr (kV == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

// g_enc = the sum over steps of the sampled g_out (kSteps false), or each
// step's sampled g_out, g_vec, into its row of sp.gvec [R, steps, C]
// (kSteps, before the MLP adjoint's pass A; zeros at unsampled steps), a
// group of `group` lanes (a power of two) per ray, lane j of a group
// owning channels pass * group * kV + j * kV + [0, kV) of each of
// `passes` passes.
template <int kV, bool kSteps>
__global__ void __launch_bounds__(kEncThreads, 1)
    splat_bw_enc_kernel(const SplatParams sp, int group, int passes) {
  constexpr int kP = kEncRegs / kV;
  constexpr int kCB = kV > 8 ? 4 : 8;  // corners loaded at once
  const Params& p = sp.m;
  const GridMeta& out = sp.out;
  const int lane = threadIdx.x & 31, j0 = lane & (group - 1);
  const int ray = (blockIdx.x * kEncThreads + threadIdx.x) / group;
  Ray r = {};
  r.b = -1;
  if (ray < p.num_rays) r = load_ray(p, ray);
  const int C = sp.out_chn, span = group * kV;
  const int tot = p.num_samples + p.num_samples_inf;
  float acc[kP][kV];
#pragma unroll
  for (int q = 0; q < kP; ++q)
#pragma unroll
    for (int v = 0; v < kV; ++v) acc[q][v] = 0.0f;

  for (int c0 = 0; c0 < tot; c0 += group) {
    const int s = c0 + j0, n = min(group, tot - c0);
    Step st = {};
    bool sampled = false;
    if (s < tot && r.b >= 0) {
      st = march_step(p, r, s);
      sampled = !p.mask_out_of_bounds || st.in_bounds;
    }
    for (int g = 0; g < out.num_grids; ++g) {
      // the lane's step's corners, as offsets of their rows' first floats
      int off[8];
      float wt[8];
      grid_corners(out, g, r.b < 0 ? 0 : r.b, st, off, wt);
#pragma unroll
      for (int k = 0; k < 8; ++k) off[k] = sampled && off[k] >= 0 ? off[k] * C : -1;
      // the corners that no point of this sub-grid has (singleton axes)
      const int nz = out.dims[g][1] > 1 ? 2 : 1,
                ny = out.dims[g][2] > 1 ? 2 : 1,
                nx = out.dims[g][3] > 1 ? 2 : 1;
      for (int j = 0; j < n; ++j) {
        // step j's corners from its lane
        int at[8];
        float w[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          at[k] = -1;
          w[k] = 0.0f;
          if ((k >> 2) >= nz || ((k >> 1) & 1) >= ny || (k & 1) >= nx)
            continue;
          at[k] = __shfl_sync(kAll, off[k], j, group);
          w[k] = __shfl_sync(kAll, wt[k], j, group);
        }
#pragma unroll
        for (int q = 0; q < kP; ++q) {
          const int c = q * span + j0 * kV;
          if (q >= passes || c >= C) continue;
          // kSteps: this step's row, which the first sub-grid writes and
          // the others add to (its load goes out with the corners')
          float* dst = sp.gvec + ((long long)ray * tot + c0 + j) * C + c;
          float y[kV];
#pragma unroll
          for (int v = 0; v < kV; ++v) y[v] = kSteps ? 0.0f : acc[q][v];
          if (kSteps && g > 0 && ray < p.num_rays)
            load_vec<kV, false>(dst, c, C, y);
          // every corner load of a batch of kCB corners before any add
#pragma unroll
          for (int k0 = 0; k0 < 8; k0 += kCB) {
            float x[kCB][kV];
#pragma unroll
            for (int kk = 0; kk < kCB; ++kk) {
#pragma unroll
              for (int v = 0; v < kV; ++v) x[kk][v] = 0.0f;
              if (at[k0 + kk] >= 0)
                load_vec<kV>(sp.g_out + at[k0 + kk] + c, c, C, x[kk]);
            }
#pragma unroll
            for (int kk = 0; kk < kCB; ++kk)
#pragma unroll
              for (int v = 0; v < kV; ++v) y[v] += w[k0 + kk] * x[kk][v];
          }
#pragma unroll
          for (int v = 0; v < kV; ++v) acc[q][v] = y[v];
          if (kSteps && ray < p.num_rays) store_vec<kV>(dst, c, C, y);
        }
      }
    }
  }
  if (kSteps || ray >= p.num_rays) return;
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    const int c = q * span + j0 * kV;
    if (q >= passes || c >= C) continue;
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (c + v < C) p.g_enc[(long long)ray * C + c + v] = acc[q][v];
  }
}

// The gather's channels a lane owns (kV: four float4s where C is 16 or 32
// and the gather sums over the steps, whose rows a group of at most two
// lanes reads; two where C % 4 == 0, else a float2 or a float), lanes per
// ray (a power of two, up to a warp) and passes over the row for C
// channels; false where C needs more than kEncRegs registers a lane.
bool enc_shape(int C, bool steps, int* kv, int* group, int* passes) {
  *kv = (C & 15) == 0 && C <= 32 && !steps ? 16
        : (C & 3) == 0           ? 8
        : (C & 1) == 0           ? 2
                                 : 1;
  const int lanes = (C + *kv - 1) / *kv;
  *group = 1;
  while (*group < lanes && *group < 32) *group *= 2;
  *passes = (C + *group * *kv - 1) / (*group * *kv);
  return *passes * *kv <= kEncRegs;
}

// ---- with the MLP: pass A --------------------------------------------------

constexpr int kMaxWarpsA = 8;
constexpr long long kMaxSmemBytes = 232448;  // a Hopper block's 227 KB

// Where the MLP lives in shared memory and in a warp's sums, per layer at
// its own widths: ki k-steps (inputs / 8), no N-tiles (outputs / 8), mi
// M-tiles of the weight gradient (inputs / 16), all rounded up.  Layer l's
// staging at frag[l]: its weights in the forward fragment order (k = input,
// n = output; ki x no blocks of 64 floats), then transposed (k = output,
// n = input), then 8 no biases; after the layers, 64 zeros (the input
// gradient's bias).  Layer l's sums at sums[l]: mi x no accumulator tiles
// of 128 floats (tc_index), then 8 no bias sums.
struct MlpLayout {
  int ki[kMaxLayers], no[kMaxLayers], mi[kMaxLayers];
  int frag[kMaxLayers], sums[kMaxLayers];
  int zeros;        // offset of the 64 zeros
  int frag_floats;  // the staged layers, a multiple of 4
  int sum_floats;   // one warp's sums, a multiple of 4
};

MlpLayout mlp_layout(const Params& p) {
  MlpLayout ml = {};
  int f = 0, s = 0;
  for (int l = 0; l < p.n_layers[0]; ++l) {
    ml.ki[l] = (p.layer_in[l] + 7) / 8;
    ml.no[l] = (p.layer_out[l] + 7) / 8;
    ml.mi[l] = (p.layer_in[l] + 15) / 16;
    ml.frag[l] = f;
    f += 2 * ml.ki[l] * ml.no[l] * 64 + 8 * ml.no[l];
    ml.sums[l] = s;
    s += ml.mi[l] * ml.no[l] * 128 + 8 * ml.no[l];
  }
  ml.zeros = f;
  ml.frag_floats = (f + 64 + 3) / 4 * 4;
  ml.sum_floats = (s + 3) / 4 * 4;
  return ml;
}

// Floats of one warp's region: its L + 1 tiles and its sums.
__host__ __device__ __forceinline__ long long warp_floats(
    int W, int n_layers, const MlpLayout& ml) {
  return (long long)(n_layers + 1) * 32 * (W + 4) + ml.sum_floats;
}

long long mlp_smem_bytes(int W, int n_layers, const MlpLayout& ml,
                         int warps) {
  return 4LL * (ml.frag_floats + warps * warp_floats(W, n_layers, ml));
}

// Stages every layer (MlpLayout).  No barrier.
__device__ __forceinline__ void stage_mlp_layers(const Params& p,
                                                 const MlpLayout& ml,
                                                 float* smem) {
  for (int l = 0; l < p.n_layers[0]; ++l) {
    const int d_in = p.layer_in[l], d_out = p.layer_out[l];
    const int ki = ml.ki[l], no = ml.no[l];
    const float* w_src = p.mlp + p.layer_w_off[l];
    float* fw = smem + ml.frag[l];
    float* bw = fw + ki * no * 64;
    float* bias = bw + ki * no * 64;
    for (int k = threadIdx.x; k < ki * no * 64; k += blockDim.x) {
      const int i = k / (8 * no), o = k % (8 * no);
      const float v = i < d_in && o < d_out ? w_src[i * d_out + o] : 0.0f;
      fw[frag_index(i, o, ki)] = v;
      bw[frag_index(o, i, no)] = v;
    }
    for (int o = threadIdx.x; o < 8 * no; o += blockDim.x)
      bias[o] = o < d_out ? p.mlp[p.layer_b_off[l] + o] : 0.0f;
  }
  for (int k = threadIdx.x; k < 64; k += blockDim.x) smem[ml.zeros + k] = 0.0f;
}

// Rows j < n of src [.., C] (row stride C) into rows j of the [32][W + 4]
// tile, plus `add`, with zeros past n and C: lane 8 q + u loads channels
// 32 v + 4 u .. + 3 of rows 4 i + q (R1's gather_chunk layout,
// renderer_fw.cu), every load before any store.
template <int W>
__device__ __forceinline__ void load_rows(float* tile, const float* src,
                                          int n, int C, const float4* add,
                                          int lane) {
  constexpr int S = W + 4, V = W / 32;
  const int q = lane >> 3, u = lane & 7;
  float4 x[8][V];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = 4 * i + q, c = 32 * v + 4 * u;
      const float* at = src + (long long)j * C + c;
      x[i][v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (j < n && (C & 3) == 0 && c < C) {
        x[i][v] = __ldg(reinterpret_cast<const float4*>(at));
      } else if (j < n) {
        x[i][v].x = c < C ? __ldg(at) : 0.0f;
        x[i][v].y = c + 1 < C ? __ldg(at + 1) : 0.0f;
        x[i][v].z = c + 2 < C ? __ldg(at + 2) : 0.0f;
        x[i][v].w = c + 3 < C ? __ldg(at + 3) : 0.0f;
      }
    }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float4 y = x[i][v];
      if (add != nullptr) {
        y.x += add[v].x;
        y.y += add[v].y;
        y.z += add[v].z;
        y.w += add[v].w;
      }
      *reinterpret_cast<float4*>(tile + (4 * i + q) * S + 32 * v + 4 * u) =
          y;
    }
}

// The MLP adjoint's pass A: g_enc, the staged g_in [R, steps, C_in] and
// the block's row of partial weight-gradient sums (added to), a warp per
// ray; W is the widest layer rounded up to 32 or 64.
template <int W>
__global__ void __launch_bounds__(32 * kMaxWarpsA, 1)
    splat_bw_mlp_kernel(const SplatParams sp, const MlpLayout ml) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = W + 4, kTile = 32 * S, V = W / 32;
  const Params& p = sp.m;
  const int L = p.n_layers[0];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int wf = (int)warp_floats(W, L, ml);
  stage_mlp_layers(p, ml, smem);
  float* tiles = smem + ml.frag_floats + warp * wf;  // X_0 .. X_{L-1}, G
  float* sums = tiles + (L + 1) * kTile;
  for (int i = lane; i < wf; i += 32) tiles[i] = 0.0f;
  __syncthreads();  // the layers; after it the warps never wait on another
  float* Gt = tiles + L * kTile;
  const float* zeros = smem + ml.zeros;
#define X(l) (tiles + (l) * kTile)

  const int C = sp.out_chn, C_in = p.grid_chn;
  const int tot = p.num_samples + p.num_samples_inf;
  const int q = lane >> 3, u = lane & 7;
  // as R1: a block takes a contiguous run of groups of `warps` rays
  const int groups = (p.num_rays + warps - 1) / warps;
  const int per_block = (groups + gridDim.x - 1) / gridDim.x;
  const int group_end = min(groups, (blockIdx.x + 1) * per_block);
  for (int group = blockIdx.x * per_block; group < group_end; ++group) {
    const int ray = group * warps + warp;
    if (ray >= p.num_rays) break;
    // the encoding in load_rows' layout: lane 8 q + u, channels
    // 32 v + 4 u .. + 3
    float4 e[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float* src = p.enc + (long long)ray * C_in + 32 * v + 4 * u;
      const int c = 32 * v + 4 * u;
      e[v] = make_float4(c < C_in ? src[0] : 0.0f,
                         c + 1 < C_in ? src[1] : 0.0f,
                         c + 2 < C_in ? src[2] : 0.0f,
                         c + 3 < C_in ? src[3] : 0.0f);
    }
    float genc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) genc[v] = 0.0f;
    for (int c0 = 0; c0 < tot; c0 += 32) {
      const int s = c0 + lane, n = min(32, tot - c0);
      float* staged = sp.stage + ((long long)ray * tot + c0) * C_in;

      // the chunk's g_vec (the gradient of the MLP's output) and input
      // samples, both staged by the gather (splat_bw_enc_kernel<kV,
      // true>; zero at unsampled steps): X_0 = the sample + the encoding,
      // the plain version's order; then the chunk skip
      load_rows<W>(Gt, sp.gvec + ((long long)ray * tot + c0) * C, n, C,
                   nullptr, lane);
      load_rows<W>(X(0), staged, n, C_in, e, lane);
      __syncwarp();
      bool nonzero = false;
      {
        const float4* row = reinterpret_cast<const float4*>(Gt + lane * S);
#pragma unroll
        for (int k = 0; k < W / 4; ++k) {
          const float4 g = row[k];
          nonzero |= g.x != 0.0f || g.y != 0.0f || g.z != 0.0f || g.w != 0.0f;
        }
      }
      if (!__any_sync(kAll, nonzero) || (kAblate & kAblateS2GatherOnly)) {
        if (kAblate & kAblateS2GatherOnly) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            for (int j = 0; j < 32; ++j) genc[v] += Gt[j * S + 32 * v + lane];
        }
        for (int j = 0; j < n; ++j)
          for (int c = lane; c < C_in; c += 32) staged[j * C_in + c] = 0.0f;
        __syncwarp();  // the lanes' reads of Gt are done
        continue;
      }

      // the forward, recomputed, each layer's input kept
      for (int l = 0; l + 1 < L; ++l) {
        const float* fw = smem + ml.frag[l];
        mma_rows<W, true>(X(l), reinterpret_cast<const float2*>(fw),
                          fw + 2 * ml.ki[l] * ml.no[l] * 64, ml.no[l],
                          ml.ki[l], true, nullptr, X(l + 1), nullptr, lane);
        if (kReluMasks && s < tot) {
          const float* y = X(l + 1) + lane * S;
          record_mask<W>(p, ray, s, tot, l, y);
        }
      }

      // the backward, last layer first: G_l is Gt, then X_{l+1}'s tile
      const float* G = Gt;
      for (int l = L - 1; l >= 0; --l) {
        const int ki = ml.ki[l], no = ml.no[l];
        if (!(kAblate & kAblateS2NoWeightGrad)) {
          float* acc = sums + ml.sums[l];
          tc_weight_grad_rows<W>(acc, X(l), G, ml.mi[l], no, lane);
          float* bias_acc = acc + ml.mi[l] * no * 128;
          for (int o = lane; o < 8 * no; o += 32) {
            float a = 0.0f;
            for (int j = 0; j < 32; ++j) a += G[j * S + o];
            bias_acc[o] += a;
          }
        }
        // G_{l-1} = (G_l W_l^T) * (X_l > 0) over X_l; at l = 0, g_in
        const float* bw = smem + ml.frag[l] + ki * no * 64;
        mma_rows<W, true>(G, reinterpret_cast<const float2*>(bw), zeros, ki,
                          no, false, l > 0 ? X(l) : nullptr, X(l), nullptr,
                          lane);
        G = X(l);
      }

      // g_in, now in X_0: into g_enc and the staging rows
#pragma unroll
      for (int v = 0; v < V; ++v)
        for (int j = 0; j < 32; ++j) genc[v] += X(0)[j * S + 32 * v + lane];
      for (int j = 0; j < n; ++j)
        for (int c = lane; c < C_in; c += 32)
          staged[j * C_in + c] = X(0)[j * S + c];
      __syncwarp();  // the tiles are free for the next chunk
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (32 * v + lane < C_in)
        p.g_enc[(long long)ray * C_in + 32 * v + lane] = genc[v];
  }
#undef X

  // the block adds its warps' sums into its own row
  __syncthreads();
  float* row = p.g_mlp_partial + (long long)blockIdx.x * ml.sum_floats;
  const float* first = smem + ml.frag_floats + (L + 1) * kTile;
  for (int k = threadIdx.x; k < ml.sum_floats; k += blockDim.x) {
    float a = row[k];
    for (int w = 0; w < warps; ++w) a += first[w * wf + k];
    row[k] = a;
  }
}

// ---- with the MLP at W = 96 to 256: pass A on the staged layers -----------
// No layer fits a block's shared memory beside its warps' tiles (at W = 128
// a 128 x 128 layer is 64 KB), so pass A takes R2-wide's design
// (renderer_wide.cuh, wide_mlp.cuh) without the march: a block's warps take
// a ray each and work on the same 16-row chunk of their rays' staged g_vec
// and samples in lockstep, each layer staged once a block through the
// cp.async ring of packed slices (schedule kSplatBw: the L - 1 relu layers,
// then every layer's input gradient, last layer first) and multiplied by
// wgmma a warpgroup (mma.sync in a block of 1-3 warps).  A chunk is skipped
// only where the block's whole g_vec is 0 there (__syncthreads_or); a warp
// whose ray's g_vec is 0 over the chunk (or that has no ray) takes every
// slice and barrier and writes zeros as its rows' g_in.  Each layer's
// weight gradient is summed over the block's rows by block_weight_grad into
// the block's row of g_mlp_partial (MlpLayout's sums, rows added across the
// slices' launches), read back by nothing; reduce_partial_kernel sums the
// rows.  Each tile is its layer input's width rounded up to 16 (the weight
// gradient's M-tiles) plus 4 (wide_stride): at 32 -> 128 -> 128, X_0 and
// g_in 36 floats wide, X_1 and g_vec 132, 19,200 B a warp, so 8 warps and
// the ring (49,152 B) fit a block (202,784 B); at 32 -> 256 -> 256 X_1 and
// g_vec 260 wide, 35,584 B a warp, 4 warps (191,520 B; five would fit, not
// eight), and at 32 -> 192 -> 192 27,392 B a warp, 4 warps (158,752 B).

constexpr int kMaxWarpsWide = 8;
constexpr int kWideFlagBytes = 4 * kMaxWarpsWide;  // a warp's active flag

// Floats of a tile row for d channels (a layer's input, or g_vec's C).
__host__ __device__ __forceinline__ int wide_stride(int d) {
  return (d + 15) / 16 * 16 + 4;
}

// Where a warp's tiles lie in its region (floats): X_0 .. X_{L-1} (layer
// l's input, then its input gradient), then g_vec's.
struct WideALayout {
  int off[kMaxLayers + 1];
  int warp_floats;
};

__host__ __device__ __forceinline__ WideALayout wide_a_layout(const Params& p,
                                                              int C) {
  WideALayout lay = {};
  int at = 0;
  for (int l = 0; l < p.n_layers[0]; ++l) {
    lay.off[l] = at;
    at += kChunk * wide_stride(p.layer_in[l]);
  }
  lay.off[p.n_layers[0]] = at;
  lay.warp_floats = at + kChunk * wide_stride(C);
  return lay;
}

long long wide_a_smem_bytes(int W, const WideALayout& lay, int warps) {
  return 4LL * warps * lay.warp_floats + ring_bytes(W) + kWideFlagBytes;
}

// The most warps, up to kMaxWarpsWide, whose tiles fit with the ring in a
// block's shared memory, in whole warpgroups past 4 (0 where one does not).
int wide_a_warps(int W, const WideALayout& lay) {
  int warps = kMaxWarpsWide;
  while (warps > 1 && wide_a_smem_bytes(W, lay, warps) > kMaxSmemBytes)
    --warps;
  if (wide_a_smem_bytes(W, lay, warps) > kMaxSmemBytes) return 0;
  return warps > 4 ? warps / 4 * 4 : warps;
}

// Rows j < n of src [.., C] into rows j of a [kChunk][stride] tile, plus
// `add` where given, zeros past n and C up to the tile's stride - 4
// columns: lane 8 q + u loads channels 32 v + 4 u .. + 3 of rows 4 i + q,
// every load of the chunk before any store.  Returns whether any value the
// lane loaded is not 0.
template <int W>
__device__ __forceinline__ bool load_chunk(float* tile, int stride,
                                           const float* src, int n, int C,
                                           const float4* add, int lane) {
  constexpr int V = W / 32;
  const int q = lane >> 3, u = lane & 7;
  float4 x[kChunk / 4][V];
  bool nonzero = false;
#pragma unroll
  for (int i = 0; i < kChunk / 4; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = 4 * i + q, c = 32 * v + 4 * u;
      const float* at = src + (long long)j * C + c;
      x[i][v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (j < n && (C & 3) == 0 && c < C) {
        x[i][v] = __ldg(reinterpret_cast<const float4*>(at));
      } else if (j < n && c < C) {
        x[i][v].x = __ldg(at);
        x[i][v].y = c + 1 < C ? __ldg(at + 1) : 0.0f;
        x[i][v].z = c + 2 < C ? __ldg(at + 2) : 0.0f;
        x[i][v].w = c + 3 < C ? __ldg(at + 3) : 0.0f;
      }
      nonzero |= x[i][v].x != 0.0f || x[i][v].y != 0.0f ||
                 x[i][v].z != 0.0f || x[i][v].w != 0.0f;
    }
#pragma unroll
  for (int i = 0; i < kChunk / 4; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = 32 * v + 4 * u;
      if (c >= stride - 4) continue;
      float4 y = x[i][v];
      if (add != nullptr) {
        y.x += add[v].x;
        y.y += add[v].y;
        y.z += add[v].z;
        y.w += add[v].w;
      }
      *reinterpret_cast<float4*>(tile + (4 * i + q) * stride + c) = y;
    }
  return nonzero;
}

// Values 0 .. n - 1 of a tile row, 0 past them (record_mask's vector).
struct RowPrefix {
  const float* x;
  int n;
  __device__ __forceinline__ float operator[](int i) const {
    return i < n ? x[i] : 0.0f;
  }
};

// The wide pass A over the rays: g_enc, the staged g_in [R, steps, C_in]
// (over the staged samples) and the block's row of g_mlp_partial (added
// to).
template <int W>
__global__ void __launch_bounds__(32 * kMaxWarpsWide, 1)
    splat_bw_mlp_wide_kernel(const SplatParams sp, const MlpLayout ml,
                             const WideALayout lay,
                             const uint4* __restrict__ pack, int n_slices) {
  extern __shared__ __align__(16) float smem[];
  constexpr int V = W / 32;
  const Params& p = sp.m;
  const int L = p.n_layers[0];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const bool wg = warps % 4 == 0;  // warpgroups: the products by wgmma
  float* const region0 = smem;     // warp 0's region
  float* tiles = region0 + (long long)warp * lay.warp_floats;
  for (int i = lane; i < lay.warp_floats; i += 32) tiles[i] = 0.0f;
  Ring ring = {reinterpret_cast<uint4*>(smem + warps * lay.warp_floats), pack,
               ring_slot_u4(W), n_slices, 0};
  int* active_warps = reinterpret_cast<int*>(
      reinterpret_cast<char*>(ring.slots) + ring_bytes(W));
  ring_start(ring);
  __syncwarp();
#define X(l) (tiles + lay.off[l])
#define SX(l) wide_stride(p.layer_in[l])
  float* Gt = tiles + lay.off[L];
  const int C = sp.out_chn, C_in = p.grid_chn;
  const int sg = wide_stride(C), s0 = SX(0);
  const int tot = p.num_samples + p.num_samples_inf;
  const int u = lane & 7;
  float* acc = p.g_mlp_partial + (long long)blockIdx.x * ml.sum_floats;

  const int groups = (p.num_rays + warps - 1) / warps;
  const int per_block = (groups + gridDim.x - 1) / gridDim.x;
  const int group_end = min(groups, (blockIdx.x + 1) * per_block);
  for (int group = blockIdx.x * per_block; group < group_end; ++group) {
    // every warp walks the block's groups, a ray past num_rays too
    const int ray = group * warps + warp;
    const bool valid = ray < p.num_rays;
    // the encoding in load_chunk's layout: lane 8 q + u, channels
    // 32 v + 4 u .. + 3
    float4 e[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float* src = p.enc + (long long)(valid ? ray : 0) * C_in;
      const int c = 32 * v + 4 * u;
      e[v] = make_float4(valid && c < C_in ? src[c] : 0.0f,
                         valid && c + 1 < C_in ? src[c + 1] : 0.0f,
                         valid && c + 2 < C_in ? src[c + 2] : 0.0f,
                         valid && c + 3 < C_in ? src[c + 3] : 0.0f);
    }
    float genc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) genc[v] = 0.0f;
    for (int c0 = 0; c0 < tot; c0 += kChunk) {
      const int n = valid ? min(kChunk, tot - c0) : 0;
      float* staged = sp.stage + ((long long)(valid ? ray : 0) * tot + c0) *
                                     C_in;
      // the chunk's g_vec (the gradient of the MLP's output) and input
      // samples, both staged by the gather (zero at unsampled steps): X_0 =
      // the sample + the encoding, the plain version's order
      bool nonzero = load_chunk<W>(
          Gt, sg, sp.gvec + ((long long)(valid ? ray : 0) * tot + c0) * C, n,
          C, nullptr, lane);
      load_chunk<W>(X(0), s0, staged, n, C_in, e, lane);
      __syncwarp();
      bool active = __any_sync(kAll, nonzero);
      if (kAblate & kAblateS2GatherOnly) {
        for (int j = 0; j < kChunk; ++j) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c = 32 * v + lane;
            if (c < C && c < C_in) genc[v] += Gt[j * sg + c];
          }
        }
        active = false;
      }
      const bool block_active = __syncthreads_or(active);
      // read by block_weight_grad, behind the barriers to come; every warp
      // is past the last chunk's reads
      if (lane == 0) active_warps[warp] = active;
      if (block_active) {
        // the forward, recomputed, each layer's input kept
        for (int l = 0; l + 1 < L; ++l) {
          staged_rows<W>(ring, (p.layer_in[l] + 7) / 8, p.layer_out[l], X(l),
                         SX(l), nullptr, p.mlp + p.layer_b_off[l], true,
                         nullptr, nullptr, X(l + 1), nullptr, SX(l + 1),
                         active, wg, lane);
          if (kReluMasks && active && lane < kChunk && lane < n)
            record_mask<W>(p, ray, c0 + lane, tot, l,
                           RowPrefix{X(l + 1) + lane * SX(l + 1),
                                     p.layer_out[l]});
        }
        // the backward, last layer first: G_l is g_vec's tile, then X_{l+1}'s
        const float* G = Gt;
        int gs = sg;
        for (int l = L - 1; l >= 0; --l) {
          __syncthreads();  // every warp's X_l and G_l are written
          if (!(kAblate & kAblateS2NoWeightGrad))
            block_weight_grad<W>(acc + ml.sums[l], region0 + (X(l) - tiles),
                                 nullptr, region0 + (G - tiles), SX(l), gs,
                                 lay.warp_floats, active_warps, warps,
                                 p.layer_in[l], p.layer_out[l], warp, lane);
          // (the product's first slice is a barrier: every warp is past the
          // weight gradient before any writes over X_l)
          // G_{l-1} = (G_l W_l^T) * (X_l > 0) over X_l; at l = 0, g_in
          staged_rows<W>(ring, (p.layer_out[l] + 7) / 8, p.layer_in[l], G, gs,
                         nullptr, nullptr, false, l > 0 ? X(l) : nullptr,
                         nullptr, X(l), nullptr, SX(l), active, wg, lane);
          G = X(l);
          gs = SX(l);
        }
      }
      // g_in, now in X_0 (0 where the warp was not active): into g_enc and
      // the staging rows
      if (active) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (32 * v + lane >= C_in) continue;
          for (int j = 0; j < kChunk; ++j)
            genc[v] += X(0)[j * s0 + 32 * v + lane];
        }
      }
      for (int j = 0; j < n; ++j)
        for (int c = lane; c < C_in; c += 32)
          staged[(long long)j * C_in + c] = active ? X(0)[j * s0 + c] : 0.0f;
      __syncwarp();  // the tiles are free for the next chunk
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (valid && 32 * v + lane < C_in)
        p.g_enc[(long long)ray * C_in + 32 * v + lane] = genc[v];
  }
  cp_async_wait<0>();
#undef SX
#undef X
}

// g_mlp[k] = the sum over the `rows` rows of g_mlp_partial of the entry of
// flat parameter k (MlpLayout's sums).
__global__ void reduce_partial_kernel(const Params p, const MlpLayout ml,
                                      int rows, int row_floats) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.n_params) return;
  int entry = 0;
  for (int l = 0; l < p.n_layers[0]; ++l) {
    const int d_in = p.layer_in[l], d_out = p.layer_out[l];
    const int w_off = p.layer_w_off[l], b_off = p.layer_b_off[l];
    if (k >= w_off && k < w_off + d_in * d_out) {
      const int i = (k - w_off) / d_out, o = (k - w_off) % d_out;
      entry = ml.sums[l] + tc_index(i, o, ml.no[l]);
      break;
    }
    if (k >= b_off && k < b_off + d_out) {
      entry = ml.sums[l] + ml.mi[l] * ml.no[l] * 128 + (k - b_off);
      break;
    }
  }
  float acc = 0.0f;
  for (int b = 0; b < rows; ++b)
    acc += p.g_mlp_partial[(long long)b * row_floats + entry];
  p.g_mlp[k] = acc;
}

// Warps per block of pass A (the most, up to kMaxWarpsA, that one block's
// shared memory holds), its shared memory and the resident wave of blocks.
template <int W>
cudaError_t mlp_config(const Params& p, const MlpLayout& ml, int* warps,
                       size_t* smem, int* wave) {
  const int L = p.n_layers[0];
  *warps = kMaxWarpsA;
  while (*warps > 1 && mlp_smem_bytes(W, L, ml, *warps) > kMaxSmemBytes)
    --*warps;
  *smem = (size_t)mlp_smem_bytes(W, L, ml, *warps);
  if ((long long)*smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      splat_bw_mlp_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, splat_bw_mlp_kernel<W>, 32 * *warps, *smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *wave = sms * per_sm;
  return cudaSuccess;
}

// The wide pass A's warps per block (wide_a_warps), its shared memory and
// its resident wave of blocks.
template <int W>
cudaError_t mlp_wide_config(const Params& p, int C, int* warps, size_t* smem,
                            int* wave) {
  const WideALayout lay = wide_a_layout(p, C);
  *warps = wide_a_warps(W, lay);
  *smem = (size_t)wide_a_smem_bytes(W, lay, *warps > 0 ? *warps : 1);
  if (*warps == 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      splat_bw_mlp_wide_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, splat_bw_mlp_wide_kernel<W>, 32 * *warps, *smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *wave = sms * per_sm;
  return cudaSuccess;
}

// The pre-pass (the packed layers into `pack`), then the wide pass A over
// the rays, a block's row of sums each among `rows`.
template <int W>
cudaError_t launch_mlp_wide(const SplatParams& sp, const MlpLayout& ml,
                            int rows, void* pack, cudaStream_t stream) {
  int warps = 0, wave = 0;
  size_t smem = 0;
  cudaError_t e = mlp_wide_config<W>(sp.m, sp.out_chn, &warps, &smem, &wave);
  if (e != cudaSuccess) return e;
  const long long groups = (sp.m.num_rays + warps - 1) / warps;
  long long blocks = groups < wave ? groups : wave;
  if (blocks > rows) blocks = rows;
  if (blocks < 1) return cudaSuccess;
  if ((e = launch_wide_pack(sp.m, kSplatBw, pack, stream)) != cudaSuccess)
    return e;
  splat_bw_mlp_wide_kernel<W><<<(int)blocks, 32 * warps, smem, stream>>>(
      sp, ml, wide_a_layout(sp.m, sp.out_chn),
      static_cast<const uint4*>(pack), wide_slices(sp.m, kSplatBw));
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_mlp(const SplatParams& sp, const MlpLayout& ml, int rows,
                       cudaStream_t stream) {
  int warps = 0, wave = 0;
  size_t smem = 0;
  cudaError_t e = mlp_config<W>(sp.m, ml, &warps, &smem, &wave);
  if (e != cudaSuccess) return e;
  const long long groups = (sp.m.num_rays + warps - 1) / warps;
  long long blocks = groups < wave ? groups : wave;
  if (blocks > rows) blocks = rows;
  if (blocks < 1) return cudaSuccess;
  splat_bw_mlp_kernel<W><<<(int)blocks, 32 * warps, smem, stream>>>(sp, ml);
  return cudaGetLastError();
}

// The gather over sp.out and sp.g_out (enc_shape's build for its
// channels), a group of lanes per ray.
template <bool kSteps>
cudaError_t launch_gather(const SplatParams& sp, cudaStream_t s) {
  int kv = 0, group = 0, passes = 0;
  if (!enc_shape(sp.out_chn, kSteps, &kv, &group, &passes))
    return cudaErrorInvalidValue;
  const int blocks = (int)(((long long)sp.m.num_rays * group + kEncThreads -
                            1) / kEncThreads);
  if (kv == 16 && !kSteps)
    splat_bw_enc_kernel<16, false><<<blocks, kEncThreads, 0, s>>>(sp, group,
                                                                  passes);
  else if (kv == 8)
    splat_bw_enc_kernel<8, kSteps><<<blocks, kEncThreads, 0, s>>>(sp, group,
                                                                  passes);
  else if (kv == 2)
    splat_bw_enc_kernel<2, kSteps><<<blocks, kEncThreads, 0, s>>>(sp, group,
                                                                  passes);
  else
    splat_bw_enc_kernel<1, kSteps><<<blocks, kEncThreads, 0, s>>>(sp, group,
                                                                  passes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// For the MLP adjoint at `width` (32, 64, 96, 128, 192 or 256) of n_layers
// layers of mlp_widths (host int[n_layers + 1]): out[0] the warps per block
// of pass A, out[1] the rows of g_mlp_partial that the caller zero-fills (its
// resident wave of blocks), out[2] the floats of a row, out[3] a block's
// shared memory in bytes, out[4] the bytes of the workspace of packed
// layers (above 64; 0 at 32 and 64); a cudaError_t code.
int lightplane_splat_bw_mlp_config(int width, int n_layers,
                                   const int* mlp_widths, int* out) {
  if (n_layers < 1 || n_layers > kMaxLayers || !known_splat_width(width))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const int counts[3] = {n_layers, 0, 0};
  fill_layers(p, counts, mlp_widths);
  const MlpLayout ml = mlp_layout(p);
  const int C = p.layer_out[n_layers - 1];
  int warps = 0, wave = 0;
  size_t smem = 0;
  const cudaError_t e =
      width == 32   ? mlp_config<32>(p, ml, &warps, &smem, &wave)
      : width == 64 ? mlp_config<64>(p, ml, &warps, &smem, &wave)
                    : wide_dispatch(width, [&](auto w) {
                        return mlp_wide_config<decltype(w)::value>(
                            p, C, &warps, &smem, &wave);
                      });
  out[0] = warps;
  out[1] = wave;
  out[2] = ml.sum_floats;
  out[3] = (int)smem;
  out[4] = width > 64 ? (int)wide_pack_bytes(p, kSplatBw) : 0;
  return (int)e;
}

// Registers, spilled bytes and the thread limit of the gather without the
// MLP (mlp = 0; its build for C % 4 == 0 above 32 channels; mlp = 3 its
// build for 16 or 32), of pass A at `width` (mlp = 1) or of the gather that
// stages g_vec for it (mlp = 2), into out[3]; a cudaError_t code.
int lightplane_splat_bw_attrs(int mlp, int width, int* out) {
  if (!mlp) return kernel_attrs(splat_bw_enc_kernel<8, false>, out);
  if (mlp == 2) return kernel_attrs(splat_bw_enc_kernel<8, true>, out);
  if (mlp == 3) return kernel_attrs(splat_bw_enc_kernel<16, false>, out);
  if (width > 64)
    return wide_dispatch(width, [&](auto w) {
      return kernel_attrs(splat_bw_mlp_wide_kernel<decltype(w)::value>, out);
    });
  return width == 32 ? kernel_attrs(splat_bw_mlp_kernel<32>, out)
                     : kernel_attrs(splat_bw_mlp_kernel<64>, out);
}

// Launches one part of the splat adjoint on `stream`; returns a
// cudaError_t code.  Arguments as lightplane_splat_fw's, with g_out
// [V_out, out_chn] in and:
//   part 0, without the MLP (n_layers = 0): g_enc [R, out_chn] out;
//   part 1, pass A (n_layers > 0): the gather of g_vec into g_vec [R,
//     steps, out_chn], then pass A: g_enc [R, in_chn] and the staged MLP
//     input gradient stage [R, steps, in_chn] out, the resident wave's
//     rows of g_mlp_partial (`rows` of them, lightplane_splat_bw_mlp_config,
//     zero-filled before the first slice) added to; for the recording
//     build the zero-filled [R, steps, n_layers - 1, width / 32] mask words
//     (null otherwise); at widths above 64 `workspace` (16-byte aligned,
//     the config's bytes) takes the packed layers (null otherwise);
//   part 2: g_mlp [n_params] = the sum of the `rows` rows (no rays read).
// The caller validates shapes, devices, alignment and limits.
int lightplane_splat_bw(
    const float* origins, const float* directions, const float* near,
    const float* far, const int* grid_idx, const float* enc,
    const float* input_grid, const float* mlp, const float* g_out,
    float* g_enc, float* g_mlp, float* g_mlp_partial, float* stage,
    float* g_vec, int num_rays, int num_out_grids, const int* out_meta, int out_chn,
    int num_in_grids, const int* in_meta, int in_chn, int n_layers,
    const int* mlp_widths, int width, int rows, int num_samples,
    int num_samples_inf, float disparity_at_inf, int mask_out_of_bounds,
    int contract_coords, int part, uint32_t* relu_masks, void* workspace,
    void* stream) {
  if (part < 0 || part > 2 || (part == 0) != (n_layers == 0))
    return (int)cudaErrorInvalidValue;
  if ((relu_masks != nullptr) != (kReluMasks && part == 1))
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
  p.g_mlp = g_mlp;
  p.g_mlp_partial = g_mlp_partial;
  p.relu_masks = relu_masks;
  p.n_mask_vecs = n_layers - 1;
  sp.g_out = g_out;
  sp.stage = stage;
  sp.gvec = g_vec;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (part < 2) {
    if (num_rays == 0) return (int)cudaSuccess;
    // the gather: g_enc (part 0), or g_vec of every step for pass A
    cudaError_t e = part == 0 ? launch_gather<false>(sp, s)
                              : launch_gather<true>(sp, s);
    if (e != cudaSuccess || part == 0) return (int)e;
    // the input grid-list's sample of every step, by the same gather, into
    // the rows that pass A then overwrites with g_in
    SplatParams si = sp;
    si.out = p.grids;
    si.out_chn = in_chn;
    si.g_out = input_grid;
    si.gvec = stage;
    e = launch_gather<true>(si, s);
    if (e != cudaSuccess) return (int)e;
  }
  const MlpLayout ml = mlp_layout(p);
  if (part == 2) {
    reduce_partial_kernel<<<(p.n_params + 255) / 256, 256, 0, s>>>(
        p, ml, rows, ml.sum_floats);
    return (int)cudaGetLastError();
  }
  if (num_rays == 0) return (int)cudaSuccess;
  const cudaError_t e =
      width == 32   ? launch_mlp<32>(sp, ml, rows, s)
      : width == 64 ? launch_mlp<64>(sp, ml, rows, s)
                    : wide_dispatch(width, [&](auto w) {
                        return launch_mlp_wide<decltype(w)::value>(
                            sp, ml, rows, workspace, s);
                      });
  return (int)e;
}

}  // extern "C"
