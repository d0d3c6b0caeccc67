// The splatter MLP's wide builds (padded widths 96, 128, 192, 256, 384, 512
// and 768, the renderer's: march_common.cuh::known_width): S1's
// pass F (splatter_fw.cu's note, 6) and S2's pass A
// (splatter_bw.cu's note), their plans, kernels and launchers, on the
// layers that wide_mlp.cuh stages.  splatter_fw.cu and splatter_bw.cu build
// them at 96-256; past 256, where one such kernel takes as long to compile
// as a narrower width's two, a width and a pass a source
// (splatter_wide_<W>_fw.cu, _bw.cu; one nvcc each, all started together),
// so that neither of those two instantiates them.  Every width is reached
// through a table of launchers (SplatWideOps), as renderer_wide.cu reaches
// R1's and R2's.
//
// Past 256 each product runs in N-parts of at most 256 columns by mma.sync
// (wide_mlp.cuh::staged_rows_parts; three at 768), so a block need not be
// a warpgroup:
// - Pass F takes the most warps whose [16][W + 4] tiles fit with the ring
//   (49,152 B): 7 at 384 (222,976 B), 5 at 512 (214,272 B) and 3 at 768
//   (197,376 B); eight would need 247,808, 313,344 and 444,416, and four
//   at 768 246,784.  Its layers run in place in the warp's tile (out ==
//   A), so each part but the last waits in the warp's stash in device
//   memory (16 KB at 384 and 512, 32 KB at 768): a stash a warp of each
//   block of the resident wave, after the packed layers in the workspace
//   (pass_f_scratch_floats).
// - Pass A keeps its plan (wide_a_warps): at the feature MLP C -> C -> C 2
//   warps at 384 (198,176 B), 1 at 512 (148,256 B) and 1 at 768 (197,408
//   B); at 32 -> W -> W 3, 2 and 1 (150,304 B at 768).  None of its
//   products writes over its own input (the forward writes X_{l+1} from
//   X_l, each input gradient X_l from G_l, gated by X_l at each output's
//   own place), so it takes no stash.  A chunk's staged rows load four
//   rows at a time (load_chunk_rows): a whole chunk's loads would hold 256
//   floats a lane at 512.  Past 512 each row loads in two halves of its
//   channels (48 floats a lane at 768, not 96) and g_enc's sums stay in
//   the ray's row of g_enc, not in registers: at 768 on an H100, with both
//   in registers, pass A spilled 600 B a thread and took 14% longer.  The
//   weight gradient is block_weight_grad's, as R2's past 256: a block's row
//   of sums is 525,312 floats at 512 -> 512 -> 512 and 1,181,184 (4.7 MB)
//   at 768 -> 768 -> 768, 277 MB and 624 MB for 132 blocks.
// An MLP whose pass A does not fit one warp raises (the wrapper's
// splatter_bw.wide_a_plan): 768 -> 768 -> 768 -> 768 needs 246,816 B.

#pragma once

#include "splat_common.cuh"
#include "wide_mlp.cuh"

namespace lightplane {

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

inline MlpLayout mlp_layout(const Params& p) {
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

// Pass F's warps (rays) a block at most: two warpgroups, by wgmma up to
// W = 256.
constexpr int kFWarps = 8;
constexpr long long kMaxSmemBytes = 232448;  // a Hopper block's 227 KB

// Bytes of a pass F block's shared memory: each warp's [16][W + 4] tile,
// then the ring (116,736 at W = 128, 149,504 at 192, 182,272 at 256,
// 222,976 at 384 with 7 warps, 214,272 at 512 with 5, 197,376 at 768 with
// 3; one block an SM).
__host__ __device__ __forceinline__ long long pass_f_smem_bytes(int W,
                                                                int warps) {
  return 4LL * warps * kChunk * (W + 4) + ring_bytes(W);
}

// Pass F's warps a block at width W: kFWarps up to 256; past it (by
// mma.sync) the most whose tiles fit with the ring, 7 at 384, 5 at 512
// and 3 at 768.
__host__ __device__ __forceinline__ int pass_f_warps(int W) {
  int warps = kFWarps;
  while (W > 256 && warps > 1 && pass_f_smem_bytes(W, warps) > kMaxSmemBytes)
    --warps;
  return warps;
}

// Floats of a pass F block's scratch in device memory: past W = 256 a
// stash a warp (wide_mlp.cuh::staged_rows_parts), else none.
__host__ __device__ __forceinline__ long long pass_f_scratch_floats(
    int W, int warps) {
  return (long long)warps * stash_floats(W);
}

// One width's launchers of pass F (the f_* members) or pass A (the a_*
// members), as splatter_fw.cu's and splatter_bw.cu's entry points call
// them.
struct SplatWideOps {
  // a block's shared memory and the blocks of the resident wave
  cudaError_t (*f_config)(size_t* smem, int* wave);
  // the pre-pass, then pass F
  cudaError_t (*launch_f)(const SplatParams& sp, void* workspace,
                          float* values, cudaStream_t stream);
  int (*f_attrs)(int* out);
  // the warps a block, a block's shared memory and the resident wave
  cudaError_t (*a_config)(const Params& p, int C, int* warps, size_t* smem,
                          int* wave);
  // the pre-pass, then pass A
  cudaError_t (*launch_a)(const SplatParams& sp, const MlpLayout& ml,
                          int rows, void* pack, cudaStream_t stream);
  int (*a_attrs)(int* out);
};

// The builds past 256, each in a source of its own.
SplatWideOps splat_fw_ops_384();
SplatWideOps splat_fw_ops_512();
SplatWideOps splat_fw_ops_768();
SplatWideOps splat_bw_ops_384();
SplatWideOps splat_bw_ops_512();
SplatWideOps splat_bw_ops_768();

}  // namespace lightplane

namespace {

using namespace lightplane;

constexpr unsigned kAll = 0xffffffffu;

// ---- S1's pass F ------------------------------------------------------------

// Every sampled step's MLP output, its C = sp.out_chn channels into row
// ray * steps + s of `values` [rays, steps, C]: a block's warps march a ray
// each in lockstep over 16-step chunks (lane l < 16 owns step 16 chunk +
// l's geometry), every warp on the same chunk and the same layer at once.
// A step is sampled where its ray reads a batch of every grid-list and,
// with masking, its point lies in the cube: the steps S1's plan can hold.
// A chunk with no sampled step in the block is skipped whole
// (__syncthreads_or); a warp with none in a running chunk (or with no ray)
// takes every slice and barrier, and writes nothing.  X_0 = the input
// grid-list's sample (gather_chunk, march_common.cuh's step geometry) plus
// the ray's encoding, in the plain version's order; then each layer by
// staged_rows over the ring's slices of the packed layers (schedule
// kSplatFw: every layer, relu between them), in place in the warp's tile
// (past W = 256 each N-part but the last through the warp's stash in
// `scratch`, a block's pass_f_scratch_floats after another's).
template <int W>
__global__ void __launch_bounds__(32 * kFWarps, 1)
    splat_mlp_wide_kernel(const SplatParams sp, const uint4* __restrict__ ws,
                          int n_slices, bool wg, float* scratch,
                          float* __restrict__ values) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = W + 4, V = W / 32, kTile = kChunk * S;
  const Params& p = sp.m;
  const int L = p.n_layers[0];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* X = smem + warp * kTile;
  for (int i = lane; i < kTile; i += 32) X[i] = 0.0f;
  Ring ring = {reinterpret_cast<uint4*>(smem + warps * kTile), ws,
               ring_slot_u4(W), n_slices, 0};
  if constexpr (W > 256)
    ring.stash = scratch + ((long long)blockIdx.x * warps + warp) *
                               stash_floats(W);
  ring_start(ring);
  __syncwarp();

  const int C = sp.out_chn, C_in = p.grid_chn;
  const int tot = p.num_samples + p.num_samples_inf;
  const bool vec4 = (C & 3) == 0;
  const int groups = (p.num_rays + warps - 1) / warps;
  const int per_block = (groups + gridDim.x - 1) / gridDim.x;
  const int group_end = min(groups, (blockIdx.x + 1) * per_block);
  for (int group = blockIdx.x * per_block; group < group_end; ++group) {
    // every warp walks the block's groups, a ray past num_rays too
    const int ray = group * warps + warp;
    const bool valid = ray < p.num_rays;
    Ray r = {};
    r.b = -1;
    if (valid) r = load_ray(p, ray);
    float e[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = 32 * v + lane;
      e[v] = valid && c < C_in ? p.enc[(long long)ray * C_in + c] : 0.0f;
    }
    for (int c0 = 0; c0 < tot; c0 += kChunk) {
      const int s = valid && lane < kChunk ? c0 + lane : tot;
      Step st = {};
      if (s < tot) st = march_step(p, r, s);
      const bool sampled = s < tot && r.b >= 0 &&
                           (!p.mask_out_of_bounds || st.in_bounds);
      if (!__syncthreads_or(sampled)) continue;  // no ray of the block's
      const uint32_t taken = __ballot_sync(kAll, sampled);
      const bool active = taken != 0u;
      if (active) {
        gather_chunk<W, kChunk>(p.grids, p.grid, C_in, r.b, st, taken, false,
                                X, nullptr, lane);
        __syncwarp();
        for (int j = 0; j < kChunk; ++j) {
#pragma unroll
          for (int v = 0; v < V; ++v) X[j * S + 32 * v + lane] += e[v];
        }
        __syncwarp();
      }
      for (int l = 0; l < L; ++l)
        staged_rows<W>(ring, (p.layer_in[l] + 7) / 8, p.layer_out[l], X, S,
                       nullptr, p.mlp + p.layer_b_off[l], l + 1 < L, nullptr,
                       nullptr, X, nullptr, S, active, wg, lane);
      if (!active) continue;
      // the sampled steps' rows of the chunk into the staging
      float* dst = values + ((long long)ray * tot + c0) * C;
      for (uint32_t todo = taken; todo; todo &= todo - 1) {
        const int j = __ffs(todo) - 1;
        const float* x = X + j * S;
        float* d = dst + (long long)j * C;
        if (vec4) {
          for (int c4 = lane; c4 < C / 4; c4 += 32)
            reinterpret_cast<float4*>(d)[c4] =
                reinterpret_cast<const float4*>(x)[c4];
        } else {
          for (int c = lane; c < C; c += 32) d[c] = x[c];
        }
      }
      __syncwarp();  // the tile is free for the next chunk
    }
  }
  cp_async_wait<0>();
}

// Pass F's shared memory and resident wave of blocks (of pass_f_warps).
template <int W>
cudaError_t pass_f_config(size_t* smem, int* wave) {
  const int warps = pass_f_warps(W);
  *smem = (size_t)pass_f_smem_bytes(W, warps);
  if ((long long)*smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      splat_mlp_wide_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, splat_mlp_wide_kernel<W>, 32 * warps, *smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *wave = sms * per_sm;
  return cudaSuccess;
}

// The pre-pass (the packed layers into `workspace`), then pass F (past
// W = 256 its warps' stashes after the packed layers).
template <int W>
cudaError_t launch_pass_f(const SplatParams& sp, void* workspace,
                          float* values, cudaStream_t stream) {
  size_t smem = 0;
  int wave = 0;
  cudaError_t e = pass_f_config<W>(&smem, &wave);
  if (e != cudaSuccess) return e;
  if ((e = launch_wide_pack(sp.m, kSplatFw, workspace, stream)) != cudaSuccess)
    return e;
  const int warps = pass_f_warps(W);
  const long long needed = (sp.m.num_rays + warps - 1) / warps;
  float* scratch = reinterpret_cast<float*>(
      static_cast<char*>(workspace) + wide_pack_bytes(sp.m, kSplatFw));
  splat_mlp_wide_kernel<W>
      <<<(int)(needed < wave ? needed : wave), 32 * warps, smem, stream>>>(
          sp, static_cast<const uint4*>(workspace),
          wide_slices(sp.m, kSplatFw), warps % 4 == 0, scratch, values);
  return cudaGetLastError();
}

// ---- S2's pass A --------------------------------------------------------------
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

// load_chunk past W = 256: the same rows and layout, four rows (a lane's
// one) at a time, so that a lane holds W / 32 float4s and not four times
// that (256 floats at 512), past W = 512 in two halves of the row's
// channels (48 floats a lane at 768, not 96); `add` is the encoding's row
// in device memory (add_n floats) or null.
template <int W>
__device__ __forceinline__ bool load_chunk_rows(float* tile, int stride,
                                                const float* src, int n,
                                                int C, const float* add,
                                                int add_n, int lane) {
  constexpr int V = W / 32, VH = W > 512 ? V / 2 : V;
  const int q = lane >> 3, u = lane & 7;
  bool nonzero = false;
#pragma unroll 1
  for (int i = 0; i < kChunk / 4; ++i) {
    const int j = 4 * i + q;
#pragma unroll 1
    for (int v0 = 0; v0 < V; v0 += VH) {
      float4 x[VH];
#pragma unroll
      for (int h = 0; h < VH; ++h) {
        const int c = 32 * (v0 + h) + 4 * u;
        const float* at = src + (long long)j * C + c;
        x[h] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (j < n && (C & 3) == 0 && c < C) {
          x[h] = __ldg(reinterpret_cast<const float4*>(at));
        } else if (j < n && c < C) {
          x[h].x = __ldg(at);
          x[h].y = c + 1 < C ? __ldg(at + 1) : 0.0f;
          x[h].z = c + 2 < C ? __ldg(at + 2) : 0.0f;
          x[h].w = c + 3 < C ? __ldg(at + 3) : 0.0f;
        }
        nonzero |= x[h].x != 0.0f || x[h].y != 0.0f || x[h].z != 0.0f ||
                   x[h].w != 0.0f;
      }
#pragma unroll
      for (int h = 0; h < VH; ++h) {
        const int c = 32 * (v0 + h) + 4 * u;
        if (c >= stride - 4) continue;
        float4 y = x[h];
        if (add != nullptr) {
          y.x += c < add_n ? __ldg(add + c) : 0.0f;
          y.y += c + 1 < add_n ? __ldg(add + c + 1) : 0.0f;
          y.z += c + 2 < add_n ? __ldg(add + c + 2) : 0.0f;
          y.w += c + 3 < add_n ? __ldg(add + c + 3) : 0.0f;
        }
        *reinterpret_cast<float4*>(tile + j * stride + c) = y;
      }
    }
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

// row[c] += the sum of a [kChunk][stride] tile's column c, rows in order,
// for each of the lane's channels c < n (c = lane, lane + 32, ...): pass A's
// g_enc past W = 512, kept in device memory.
__device__ __forceinline__ void add_rows(float* row, const float* tile,
                                         int stride, int n, int lane) {
#pragma unroll 1
  for (int c = lane; c < n; c += 32) {
    float a = row[c];
    for (int j = 0; j < kChunk; ++j) a += tile[j * stride + c];
    row[c] = a;
  }
}

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
    // 32 v + 4 u .. + 3 (past W = 256 read by load_chunk_rows)
    float4 e[W > 256 ? 1 : V];
    if constexpr (W <= 256) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float* src = p.enc + (long long)(valid ? ray : 0) * C_in;
        const int c = 32 * v + 4 * u;
        e[v] = make_float4(valid && c < C_in ? src[c] : 0.0f,
                           valid && c + 1 < C_in ? src[c + 1] : 0.0f,
                           valid && c + 2 < C_in ? src[c + 2] : 0.0f,
                           valid && c + 3 < C_in ? src[c + 3] : 0.0f);
      }
    }
    // g_enc's sums: in registers up to W = 512; past it in the ray's own
    // row of g_enc, each lane's channels added to chunk by chunk in the
    // same order (24 fewer registers live across the products at 768)
    float genc[W > 512 ? 1 : V];
    float* const genc_row =
        W > 512 && valid ? p.g_enc + (long long)ray * C_in : nullptr;
    if constexpr (W <= 512) {
#pragma unroll
      for (int v = 0; v < V; ++v) genc[v] = 0.0f;
    } else if (genc_row != nullptr) {
      for (int c = lane; c < C_in; c += 32) genc_row[c] = 0.0f;
    }
    for (int c0 = 0; c0 < tot; c0 += kChunk) {
      const int n = valid ? min(kChunk, tot - c0) : 0;
      float* staged = sp.stage + ((long long)(valid ? ray : 0) * tot + c0) *
                                     C_in;
      // the chunk's g_vec (the gradient of the MLP's output) and input
      // samples, both staged by the gather (zero at unsampled steps): X_0 =
      // the sample + the encoding, the plain version's order
      const float* gvec = sp.gvec + ((long long)(valid ? ray : 0) * tot +
                                     c0) * C;
      bool nonzero;
      if constexpr (W > 256) {
        nonzero = load_chunk_rows<W>(Gt, sg, gvec, n, C, nullptr, 0, lane);
        load_chunk_rows<W>(X(0), s0, staged, n, C_in,
                           valid ? p.enc + (long long)ray * C_in : nullptr,
                           C_in, lane);
      } else {
        nonzero = load_chunk<W>(Gt, sg, gvec, n, C, nullptr, lane);
        load_chunk<W>(X(0), s0, staged, n, C_in, e, lane);
      }
      __syncwarp();
      bool active = __any_sync(kAll, nonzero);
      if (kAblate & kAblateS2GatherOnly) {
        if constexpr (W <= 512) {
          for (int j = 0; j < kChunk; ++j) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const int c = 32 * v + lane;
              if (c < C && c < C_in) genc[v] += Gt[j * sg + c];
            }
          }
        } else if (genc_row != nullptr) {
          add_rows(genc_row, Gt, sg, min(C, C_in), lane);
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
        if constexpr (W <= 512) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if (32 * v + lane >= C_in) continue;
            for (int j = 0; j < kChunk; ++j)
              genc[v] += X(0)[j * s0 + 32 * v + lane];
          }
        } else {
          add_rows(genc_row, X(0), s0, C_in, lane);
        }
      }
      for (int j = 0; j < n; ++j)
        for (int c = lane; c < C_in; c += 32)
          staged[(long long)j * C_in + c] = active ? X(0)[j * s0 + c] : 0.0f;
      __syncwarp();  // the tiles are free for the next chunk
    }
    if constexpr (W <= 512) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (valid && 32 * v + lane < C_in)
          p.g_enc[(long long)ray * C_in + 32 * v + lane] = genc[v];
    }
  }
  cp_async_wait<0>();
#undef SX
#undef X
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

// Pass F's launchers at W (the f_* members; the others null).
template <int W>
SplatWideOps make_splat_fw_ops() {
  SplatWideOps ops = {};
  ops.f_config = pass_f_config<W>;
  ops.launch_f = launch_pass_f<W>;
  ops.f_attrs = [](int* out) {
    return kernel_attrs(splat_mlp_wide_kernel<W>, out);
  };
  return ops;
}

// Pass A's launchers at W (the a_* members; the others null).
template <int W>
SplatWideOps make_splat_bw_ops() {
  SplatWideOps ops = {};
  ops.a_config = mlp_wide_config<W>;
  ops.launch_a = launch_mlp_wide<W>;
  ops.a_attrs = [](int* out) {
    return kernel_attrs(splat_bw_mlp_wide_kernel<W>, out);
  };
  return ops;
}

}  // namespace
