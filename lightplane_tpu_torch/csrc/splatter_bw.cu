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
// but never re-marching.  Past kEncSliceChn channels (kEncRegs sums a
// lane) the row goes in slices of that many channels, a launch each, each
// marching the rays again: every channel count that S1 splats (at 768, one
// slice of 512 and one of 256).  g_enc is written once per ray: no
// atomics, bit-deterministic.
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
//     768 (splat_bw_mlp_wide_kernel, splatter_wide.cuh) no layer fits
//     beside the tiles: a block's warps work on 16-row chunks in lockstep,
//     the layers staged once a block through R2-wide's ring (wide_mlp.cuh)
//     and multiplied by wgmma a warpgroup (past 256 by mma.sync in
//     N-parts), each layer's weight gradient summed over the block's rows
//     into the block's row (block_weight_grad); the rest as above.
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

#include "splatter_wide.cuh"

namespace {

using namespace lightplane;

// ---- without the MLP: the gather ------------------------------------------

constexpr int kEncThreads = 128;
constexpr int kEncRegs = 16;  // channels a lane sums: kV x passes
// Channels of a launch of the gather: kEncRegs sums a lane for every kV,
// a warp a ray
constexpr int kEncSliceChn = 512;

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
// (kSteps, before the MLP adjoint's pass A; zeros at unsampled steps), in
// the channels c_first + [0, width) of the rows' C, a group of `group`
// lanes (a power of two) per ray, lane j of a group owning channels
// c_first + pass * group * kV + j * kV + [0, kV) of each of `passes`
// passes.
template <int kV, bool kSteps>
__global__ void __launch_bounds__(kEncThreads, 1)
    splat_bw_enc_kernel(const SplatParams sp, int group, int passes,
                        int c_first, int width) {
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
          if (q >= passes || c >= width) continue;
          // kSteps: this step's row, which the first sub-grid writes and
          // the others add to (its load goes out with the corners')
          float* dst =
              sp.gvec + ((long long)ray * tot + c0 + j) * C + c_first + c;
          float y[kV];
#pragma unroll
          for (int v = 0; v < kV; ++v) y[v] = kSteps ? 0.0f : acc[q][v];
          if (kSteps && g > 0 && ray < p.num_rays)
            load_vec<kV, false>(dst, c, width, y);
          // every corner load of a batch of kCB corners before any add
#pragma unroll
          for (int k0 = 0; k0 < 8; k0 += kCB) {
            float x[kCB][kV];
#pragma unroll
            for (int kk = 0; kk < kCB; ++kk) {
#pragma unroll
              for (int v = 0; v < kV; ++v) x[kk][v] = 0.0f;
              if (at[k0 + kk] >= 0)
                load_vec<kV>(sp.g_out + at[k0 + kk] + c_first + c, c,
                             width, x[kk]);
            }
#pragma unroll
            for (int kk = 0; kk < kCB; ++kk)
#pragma unroll
              for (int v = 0; v < kV; ++v) y[v] += w[k0 + kk] * x[kk][v];
          }
#pragma unroll
          for (int v = 0; v < kV; ++v) acc[q][v] = y[v];
          if (kSteps && ray < p.num_rays) store_vec<kV>(dst, c, width, y);
        }
      }
    }
  }
  if (kSteps || ray >= p.num_rays) return;
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    const int c = q * span + j0 * kV;
    if (q >= passes || c >= width) continue;
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (c + v < width)
        p.g_enc[(long long)ray * C + c_first + c + v] = acc[q][v];
  }
}

// The gather's channels a lane owns for rows of C channels (kV: four
// float4s where C is 16 or 32 and the gather sums over the steps, whose
// rows a group of at most two lanes reads; two where C % 4 == 0, else a
// float2 or a float), lanes per ray (a power of two, up to a warp) and
// passes over a slice of `width` channels; false where the slice needs
// more than kEncRegs registers a lane (never up to kEncSliceChn).
bool enc_shape(int C, int width, bool steps, int* kv, int* group,
               int* passes) {
  *kv = (C & 15) == 0 && C <= 32 && !steps ? 16
        : (C & 3) == 0           ? 8
        : (C & 1) == 0           ? 2
                                 : 1;
  const int lanes = (width + *kv - 1) / *kv;
  *group = 1;
  while (*group < lanes && *group < 32) *group *= 2;
  *passes = (width + *group * *kv - 1) / (*group * *kv);
  return *passes * *kv <= kEncRegs;
}

// ---- with the MLP: pass A --------------------------------------------------

constexpr int kMaxWarpsA = 8;

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
// channels), a group of lanes per ray, a launch a slice of at most
// kEncSliceChn channels.
template <bool kSteps>
cudaError_t launch_gather(const SplatParams& sp, cudaStream_t s) {
  const int C = sp.out_chn;
  for (int c_first = 0; c_first < C; c_first += kEncSliceChn) {
    const int width =
        C - c_first < kEncSliceChn ? C - c_first : kEncSliceChn;
    int kv = 0, group = 0, passes = 0;
    if (!enc_shape(C, width, kSteps, &kv, &group, &passes))
      return cudaErrorInvalidValue;
    const int blocks = (int)(((long long)sp.m.num_rays * group +
                              kEncThreads - 1) / kEncThreads);
    if (kv == 16 && !kSteps)
      splat_bw_enc_kernel<16, false><<<blocks, kEncThreads, 0, s>>>(
          sp, group, passes, c_first, width);
    else if (kv == 8)
      splat_bw_enc_kernel<8, kSteps><<<blocks, kEncThreads, 0, s>>>(
          sp, group, passes, c_first, width);
    else if (kv == 2)
      splat_bw_enc_kernel<2, kSteps><<<blocks, kEncThreads, 0, s>>>(
          sp, group, passes, c_first, width);
    else
      splat_bw_enc_kernel<1, kSteps><<<blocks, kEncThreads, 0, s>>>(
          sp, group, passes, c_first, width);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Pass A's wide launchers at `width`, false for a width with no wide
// build: built here at 96-256, past 256 in splatter_wide_<W>_bw.cu.
bool pass_a_ops(int width, SplatWideOps* ops) {
  switch (width) {
    case 96: *ops = make_splat_bw_ops<96>(); return true;
    case 128: *ops = make_splat_bw_ops<128>(); return true;
    case 192: *ops = make_splat_bw_ops<192>(); return true;
    case 256: *ops = make_splat_bw_ops<256>(); return true;
    case 384: *ops = splat_bw_ops_384(); return true;
    case 512: *ops = splat_bw_ops_512(); return true;
    case 768: *ops = splat_bw_ops_768(); return true;
  }
  return false;
}

}  // namespace

extern "C" {

// For the MLP adjoint at `width` (32, 64, 96, 128, 192, 256, 384, 512 or
// 768) of n_layers layers of mlp_widths (host int[n_layers + 1]): out[0] the warps per block
// of pass A, out[1] the rows of g_mlp_partial that the caller zero-fills (its
// resident wave of blocks), out[2] the floats of a row, out[3] a block's
// shared memory in bytes, out[4] the bytes of the workspace of packed
// layers (above 64; 0 at 32 and 64); a cudaError_t code.
int lightplane_splat_bw_mlp_config(int width, int n_layers,
                                   const int* mlp_widths, int* out) {
  SplatWideOps ops;
  if (n_layers < 1 || n_layers > kMaxLayers ||
      (width != 32 && width != 64 && !pass_a_ops(width, &ops)))
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
                    : ops.a_config(p, C, &warps, &smem, &wave);
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
  SplatWideOps ops;
  if (width > 64)
    return pass_a_ops(width, &ops) ? ops.a_attrs(out)
                                   : (int)cudaErrorInvalidValue;
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
  if (width == 32) return (int)launch_mlp<32>(sp, ml, rows, s);
  if (width == 64) return (int)launch_mlp<64>(sp, ml, rows, s);
  SplatWideOps ops;
  return pass_a_ops(width, &ops)
             ? (int)ops.launch_a(sp, ml, rows, workspace, s)
             : (int)cudaErrorInvalidValue;
}

}  // extern "C"
