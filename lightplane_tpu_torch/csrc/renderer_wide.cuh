// The wide builds (padded widths W = 96, 128, 192, 256, 384, 512 and 768:
// the widest of the grid's channels and the MLP layers) of the renderer's
// forward march (R1, renderer_fw.cu) and recompute backward (R2,
// renderer_bw.cu), for Hopper (sm_90a).  They replace the same TPU kernels
// as those (lightplane_tpu/ops/kernels/renderer_pallas.py::_build_fw_kernel
// and _build_bw_kernel), which take any width; renderer_fw.cu's and
// renderer_bw.cu's C functions dispatch here above W = 64, with the
// scaffold (R3) and relu-field colour grid (R1-rf) branches as there.
//
// Design.  A block's warps march a ray each, 16 steps (a chunk, one M-tile
// of the tensor cores' products) at a time, in lockstep: every warp of the
// block is on the same chunk of its ray and runs the same product at the
// same time, so that each layer is staged in shared memory once a block and
// every warp reads it there (wide_mlp.cuh: the layers packed once a launch
// by pack_wide_kernel into wgmma's K-major core matrices, split into TF32
// hi and lo; copied by cp.async into a ring of three 2-k-step slices, two
// slices ahead of the one being multiplied; one block barrier a slice).  A
// warpgroup of 4 warps (4 rays, 64 rows) multiplies by wgmma m64nWk8, A
// from registers, B read by the tensor cores from the slot, three products
// a k-step (3xTF32); a block of 1-3 warps (an MLP too deep for 4) by
// mma.sync m16n8k8, a warp's 16 rows, B's fragments read from the slot.
// Lane l < 16 owns step 16 chunk + l's geometry and gate; a chunk is
// skipped only where no ray of the block has an open gate
// (__syncthreads_or); a warp whose ray has none in a running chunk (or that
// has no ray: past num_rays in the last block) takes every slice, barrier
// and wgmma, and samples, writes and adds nothing.  The corner rows are
// gathered into [16][W + 4] tiles (warp_chunk.cuh::gather_chunk); f32
// sums, IEEE transcendentals;
// the heads' last layers are per-lane dot products (wide_last_out).
//   - R1 (render_fw_wide_kernel) keeps two tiles a warp, X and T, and
//     composites each chunk by a warp scan, as renderer_fw.cu does.
//   - R2 (render_bw_wide_kernel) walks the chunks last to first.  The
//     recomputed forward is R1's: the same functions in the same order on
//     the same values and by the same product (wgmma where R2's block is
//     whole warpgroups, else mma.sync in both: wide_wgmma), so it gives R1's
//     activations to the bit (the colour head's input, the trunk's output +
//     the encoding, is R1's tile T + e there and added as the A fragments
//     are read here: the same f32 sum).  It keeps every layer's input in its
//     own tile (n_total - 1 of them, + 1 for a colour grid's sample, + 1
//     with a one-layer colour head); the colour head's output gradient and
//     then the opacity head's share one narrow tile (the heads' last layers'
//     widest output rounded up to 8, + 4 wide).  The transmittance is
//     rewound over a chunk by a warp scan from its far end (nlt_prev = nlt -
//     the sum of sigma delta over the chunk's later steps), and the suffix
//     sum of the EA adjoint by a second scan.  The decoder backward runs
//     last layer first: each layer's weight gradient X^T G summed over the
//     rows of the block's warps by mma.sync (block_weight_grad: the
//     product's tiles and the bias sums shared out among the warps; wgmma
//     takes only K-major TF32 operands, and X^T and G are not), added into
//     the block's own row of sums in device memory by reductions; its input
//     gradient G W^T by the staged transposed layer, times the relu mask,
//     over the layer's input tile.  The feature gradient is added into the
//     grid's rows with float4 reductions (scatter_chunk, the gather's walk
//     in reverse), the encoding's summed in registers and written once per
//     ray.  reduce_wide_sums_kernel sums the blocks' rows into the flat,
//     unpadded g_mlp.
//
// Shared memory at W = 128 (a [16][132] tile 8,448 B; a ring slot two
// k-steps of 16 N-tiles of 32 uint4, 16,384 B, three 49,152 B):
//   - R1: 8 warps (two warpgroups) of two tiles, 135,168 B, + the ring:
//     184,320 B, one block and 8 warps a SM (two [32][132] tiles a warp
//     would hold 4).  At W = 96 139,264 B.
//   - R2 at the 2/2/2 MLP (hidden 128, 3 colours): a warp 5 tiles (42,240
//     B) + the narrow tile (768 B) + its encoding (512 B) = 43,520 B; four
//     warps 174,080 B + the ring + 32 B of flags = 223,264 B of the 232,448
//     a block may have (five would need 266,784), so 4 warps a SM (eight
//     [32][132] tiles a warp would hold one).  At W = 96 five fit and it
//     takes 4, a warpgroup.  The wrapper takes the most warps, up to 8,
//     that fit, whole warpgroups past 4; one warp holds 21 tiles at W = 128
//     with 3 colours (22 layers in all, 21 with a colour grid or a
//     one-layer colour head) and 30 at W = 96 (31 layers).
//   - At W = 192 and 256 (a tile 12,544 and 16,640 B; the ring's slots
//     keep their 16,384 B, a product wider than 16 N-tiles one k-step a
//     slot: wide_mlp.cuh): R1 4 warps, one warpgroup (149,504 and 182,272
//     B; 8 would need 249,856 and 315,392).  R2 at the 2/2/2 MLP: a warp
//     64,256 B at 192 and 84,992 at 256, so 2 warps a block at both
//     (177,696 and 219,168 B), by mma.sync, and R1 then by mma.sync too; the
//     3/3/3 MLP at 256 one warp (184,096 B).  One warp holds 14 tiles at
//     W = 192 and 10 at 256 (15 and 11 layers in all with 3 colours).
//   - Past W = 256 (wide_mlp.cuh: each product in N-parts of at most 256
//     columns by mma.sync, two at 384 and 512, three at 768, the parts but
//     the last of one that overwrites its own input stashed in device
//     memory, 16 KB a warp at 384 and 512, 32 KB at 768; the colour head's
//     last layer a product too, its outputs up to W rendered channels): a
//     tile is 24,832 B at 384, 33,024 at 512 and 49,408 at 768.  R1 the
//     most warps that fit, 3 at 384 (198,144 B), 2 at 512 (181,248) and 1
//     at 768 (147,968), each a stash in device memory.  R2 one warp a block
//     (so R1 and R2 both by mma.sync), its heads' tile (up to [16][W + 4]
//     with W colours) and stash in a scratch a block in device memory after
//     the packed layers: at the 2/2/2 MLP 174,880 B at 384 and 216,352 at
//     512, whatever the colours; one warp holds 7 tiles at 384 and 5 at 512
//     (8 and 6 layers in all).  Where the warp's tiles do not fit with the
//     ring (the 2/2/2 MLP at 768 would need 299,296 B; past 8 and 6 layers
//     at 384 and 512), every one of them follows the heads' tile into the
//     block's scratch (BwLayout::dev) and shared memory keeps the ring and
//     the encoding alone: 52,256 B at 768, so that four blocks are resident
//     on an SM where one was, each with its own row of sums (the resident
//     wave's).  Every reader of a tile (the products' A fragments and
//     epilogues, the relu masks, block_weight_grad, the scatter) takes a
//     generic pointer; the tiles' traffic goes through L1 and L2 instead of
//     shared memory.
//   - The weight-gradient sums: a row per warp, read and written every
//     32-step chunk, would move 223,296 B each way at that MLP (13,956 B a
//     ray-step, 234 GB a frame at the render headline).  Here a block adds
//     64 rows' sums by reductions that read nothing back: 223,296 B a
//     16-step chunk of 4 rays, 3,489 B a ray-step, 58.5 GB a frame (a
//     quarter), into one row a block (132 rows: 29.5 MB).
//
// Past 256 the weight-gradient rows grow as W^2: 1,317,384 floats a row at
// the 2/2/2 MLP 512 wide with 512 colours, 695.6 MB on 132 SMs; 2,959,112
// at 768 with 768 colours, 6.25 GB for its 528 resident blocks.
//
// What bounds it.  At the render headline at hidden 128 (triplane 3 x 32^2
// x 32ch, MLPs 2/2/2, 256 samples, 65,536 rays) the decoder is 53,760
// multiply-adds a ray-sample, 1.8 TFLOP a frame: ~11 ms at the TF32 rate in
// 3xTF32; R2 does it three times over (recompute, input and weight
// gradients).  A chunk of 4 rays stages 848 KB of packed layers in R2 (416
// KB in R1) from L2, 222 GB a frame, and takes 67 block barriers (R1: 27).
// Measured on an H100 (PERF.md, section 6): the block barriers and waits
// between slices, not the tensor cores, hold the staged products; R2's
// weight gradient by mma.sync is about 40% of R2.
//
// The grid gradient's reductions are order-dependent from run to run;
// g_mlp and g_enc are not (each sum of a block's row is always added by the
// same thread).

#pragma once

#include "wide_mlp.cuh"

namespace lightplane {
namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kFwWarps = 8;    // R1: warps (rays) per block
constexpr int kBwWarps = 8;    // R2: warps per block, at most
constexpr int kFlagBytes = 4 * kBwWarps;  // R2: a warp's active flag each
constexpr long long kMaxSmemBytes = 232448;  // a Hopper block's 227 KB

// ---- the pre-pass: every product of a chunk packed, and the schedule -----

// Block i < n packs product i of the n = wide_n_products(p, kind) of
// schedule `kind` into the workspace; block n writes the schedule
// (wide_mlp.cuh).  R1, R2 and the splatter's wide MLP builds
// (splatter_wide.cuh) launch it.
__global__ void pack_wide_kernel(const Params p, int kind, uint4* ws) {
  const int n = wide_n_products(p, kind);
  long long off = 0;
  int first = 0;
  if (blockIdx.x == n) {
    // an odd count of slices leaves the last int2 of the schedule's last
    // uint4 unread: 0, as the plain version writes it
    const int slices = wide_slices(p, kind);
    if (threadIdx.x == 0 && (slices & 1))
      reinterpret_cast<int2*>(ws)[slices] = make_int2(0, 0);
    // slice by slice, each product's parts in turn, a part's k-steps two
    // at a time (one at a time past kSlotTiles N-tiles)
    for (int i = 0; i < n; ++i) {
      wide_layout(p, kind, i, &off, &first);
      const Product pr = wide_product(p, kind, i);
      for (int q = 0; q < product_parts(pr.n_tiles); ++q) {
        const int per_step = part_tiles(pr.n_tiles, q) * 32;
        const int per_slice = slice_steps(part_tiles(pr.n_tiles, q));
        const long long part_off =
            off + (long long)q * pr.k_steps * kPartTiles * 32;
        const int slices = (pr.k_steps + per_slice - 1) / per_slice;
        for (int k = threadIdx.x; k < slices; k += blockDim.x) {
          const int ks0 = k * per_slice;
          const int steps = min(per_slice, pr.k_steps - ks0);
          reinterpret_cast<int2*>(ws)[first + k] =
              make_int2((int)(part_off + (long long)ks0 * per_step),
                        steps * per_step);
        }
        first += slices;
      }
    }
    return;
  }
  wide_layout(p, kind, blockIdx.x, &off, &first);
  const Product pr = wide_product(p, kind, blockIdx.x);
  const int d_in = p.layer_in[pr.layer], d_out = p.layer_out[pr.layer];
  const float* w = p.mlp + p.layer_w_off[pr.layer];
  // part by part (one up to kPartTiles N-tiles), k-step by k-step: the hi
  // part, then the lo part, each part's N-tiles x 2 core matrices (N-tile
  // j, k-half h at core 2 j + h) of 8 rows (n) of 4 k
  const int whole = pr.k_steps * kPartTiles * 32;  // a whole part's uint4s
  const int count = pr.k_steps * pr.n_tiles * 32;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int q = e / whole, r = e % whole;
    const int part = part_tiles(pr.n_tiles, q) * 16;
    const int ks = r / (2 * part), lo = (r / part) & 1, u = r % part;
    const int n_idx = q * kPartTiles * 8 + (u >> 4) * 8 + (u & 7);
    const int k0 = ks * 8 + 4 * ((u >> 3) & 1);
    uint32_t v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + c;
      const int i = pr.transposed ? n_idx : k, o = pr.transposed ? k : n_idx;
      const float b = i < d_in && o < d_out ? w[i * d_out + o] : 0.0f;
      const uint32_t hi = to_tf32(b);
      v[c] = lo ? __float_as_uint(b - __uint_as_float(hi)) : hi;
    }
    ws[off + e] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Packs the products of p's chunk of schedule `kind` into ws; returns the
// slices of a chunk.
int launch_pack(const Params& p, int kind, uint4* ws, cudaStream_t s) {
  pack_wide_kernel<<<wide_n_products(p, kind) + 1, 256, 0, s>>>(p, kind, ws);
  return wide_slices(p, kind);
}

// A warp's region of R2's shared memory, in floats: n_wide [16][W + 4]
// tiles (tile_floats), the narrow tile (Gt: [16][sg]; sg - 4 the heads'
// last layers' widest output, the colours' count at most, rounded up to 8;
// past W = 256 in the block's scratch in device memory instead: up to W
// colours), the ray's encoding (W).  After the warps' regions come the ring
// and the flags.  Past W = 256 (one warp a block), where that region and
// the ring exceed a block's shared memory, the tiles too lie in the block's
// scratch (dev) and the region is the encoding alone.
struct BwLayout {
  int n_wide, sg, gt_off, e_off, warp_floats, tile_floats;
  bool dev;
};

__host__ __device__ __forceinline__ BwLayout bw_layout(int W, int n_total,
                                                       int n_c, bool cgrid,
                                                       int head_out) {
  BwLayout l;
  l.n_wide = n_total - 1 + (cgrid ? 1 : 0) + (n_c == 1 ? 1 : 0);
  l.sg = (head_out + 7) / 8 * 8 + 4;
  l.tile_floats = l.n_wide * kChunk * (W + 4);
  l.gt_off = l.tile_floats;
  l.e_off = l.gt_off + (W > 256 ? 0 : kChunk * l.sg);
  l.warp_floats = l.e_off + W;
  l.dev = W > 256 && 4LL * l.warp_floats + ring_bytes(W) + kFlagBytes >
                         kMaxSmemBytes;
  if (l.dev) {
    l.gt_off = l.e_off = 0;
    l.warp_floats = W;
  }
  return l;
}

// Floats of a block's scratch in device memory past W = 256 (0 up to it):
// R1 a stash a warp (wide_mlp.cuh::staged_rows_parts); R2 (one warp) its
// stash, then its Gt, then (dev) its tiles.
__host__ __device__ __forceinline__ long long fw_scratch_floats(int W,
                                                                int warps) {
  return (long long)warps * stash_floats(W);
}

__host__ __device__ __forceinline__ long long bw_scratch_floats(
    int W, const BwLayout& l) {
  return W > 256 ? stash_floats(W) + kChunk * l.sg +
                       (l.dev ? (long long)l.tile_floats : 0)
                 : 0;
}

// The heads' last layers' widest output.
__host__ __device__ __forceinline__ int head_out(const Params& p) {
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  const int o1 = p.layer_out[p.n_layers[0] + p.n_layers[1] - 1];
  const int o2 = p.layer_out[n_total - 1];
  return o1 > o2 ? o1 : o2;
}

long long bw_smem_bytes(int W, const BwLayout& l, int warps) {
  return 4LL * warps * l.warp_floats + ring_bytes(W) + kFlagBytes;
}

// R2's warps a block at these layers: the most, up to kBwWarps (one past
// W = 256: its Gt and stash, and its tiles where they do not fit, lie in a
// scratch a block), whose regions fit with the ring in a block's shared
// memory, in whole warpgroups of 4 past 4 (0 where one warp does not
// fit).
int bw_warps(int W, const BwLayout& lay) {
  int warps = W > 256 ? 1 : kBwWarps;
  while (warps > 1 && bw_smem_bytes(W, lay, warps) > kMaxSmemBytes) --warps;
  if (bw_smem_bytes(W, lay, warps) > kMaxSmemBytes) return 0;
  return warps > 4 ? warps / 4 * 4 : warps;
}

// Whether R1 and R2 run p's products by wgmma: where R2 takes whole
// warpgroups (and R1's `warps` are), so that R2's recomputed forward
// takes R1's path and gives its activations to the bit.
bool wide_wgmma(const Params& p, int W, int fw_warps) {
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  const BwLayout lay = bw_layout(W, n_total, p.n_layers[2],
                                 p.color_grid != nullptr, head_out(p));
  return fw_warps % 4 == 0 && bw_warps(W, lay) % 4 == 0;
}

// ---- R1 ---------------------------------------------------------------

// Raw colour c of a row: past W = 256 the colour head's last product's
// output (its row `head`), else the lane's dot product over its input row
// `x`.
template <int W>
__device__ __forceinline__ float colour_raw(const Params& p, const float* x,
                                           const float* head, int c) {
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  if constexpr (W > 256)
    return head[c];
  else
    return layer_out<W>(p, n_total - 1, x, c);
}

// The recording builds' probe of step s (open), [R, steps, 2] floats: its
// raw opacity and the sum of its raw colours in order (colour_raw's),
// written by R1 and by R2's recomputed forward alike, so that the two can
// be held equal to the bit.
template <int W>
__device__ __forceinline__ void write_probe(const Params& p, float* probe,
                                            int ray, int s, int tot,
                                            float opacity_raw, const float* x,
                                            const float* head) {
  float sum = 0.0f;
  for (int c = 0; c < p.color_chn; ++c) sum += colour_raw<W>(p, x, head, c);
  float* dst = probe + ((long long)ray * tot + s) * 2;
  dst[0] = opacity_raw;
  dst[1] = sum;
}

long long fw_smem_bytes(int W, int warps) {
  return 4LL * warps * 2 * kChunk * (W + 4) + ring_bytes(W);
}

// R1's warps a block at width W: two warpgroups where their tiles fit with
// the ring (W = 96, 128), else one (W = 192, 256), else the most that fit
// (3 at W = 384, 2 at 512, 1 at 768).
int fw_warps(int W) {
  if (fw_smem_bytes(W, kFwWarps) <= kMaxSmemBytes) return kFwWarps;
  int warps = 4;
  while (warps > 1 && fw_smem_bytes(W, warps) > kMaxSmemBytes) --warps;
  return warps;
}

template <int W>
__global__ void __launch_bounds__(32 * kFwWarps, 1)
    render_fw_wide_kernel(const Params p, const uint4* __restrict__ ws,
                          int n_slices, bool wg, float* scratch,
                          float* probe) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = W + 4, V = W / 32, kTile = kChunk * S;
  const int n_t = p.n_layers[0], n_o = p.n_layers[1], n_c = p.n_layers[2];
  const int n_total = n_t + n_o + n_c;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane & (kChunk - 1);
  const int trunk_end = n_t;
  const int opacity_end = n_t + n_o - 1;
  const int n_relu_layers = n_total - 2;
  // the warp's tiles: X, the layers' activations; T, the trunk's output or
  // relu of the colour grid's sample (past W = 256 then the colour head's
  // raw outputs)
  float* X = smem + warp * 2 * kTile;
  float* T = X + kTile;
  for (int i = lane; i < 2 * kTile; i += 32) X[i] = 0.0f;
  Ring ring = {reinterpret_cast<uint4*>(smem + warps * 2 * kTile), ws,
               ring_slot_u4(W), n_slices, 0};
  if constexpr (W > 256)
    ring.stash = scratch + ((long long)blockIdx.x * warps + warp) *
                               stash_floats(W);
  ring_start(ring);
  __syncwarp();

  const int tot = p.num_samples + p.num_samples_inf;
  const bool cgrid = p.color_grid != nullptr;
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
    float e[V], feat[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = 32 * v + lane;
      e[v] = valid && c < p.enc_chn ? p.enc[(long long)ray * p.enc_chn + c]
                                    : 0.0f;
      feat[v] = 0.0f;
    }
    float nlt = 0.0f, depth = 0.0f;
    for (int c0 = 0; c0 < tot; c0 += kChunk) {
      const int s = valid && lane < kChunk ? c0 + lane : tot;
      Step st = {};
      float gate = 0.0f;
      if (s < tot) {
        st = march_step(p, r, s);
        gate = scaffold_gate(p, r.b, st);
      }
      const bool open = s < tot && gate != 0.0f;
      if (!__syncthreads_or(open)) continue;  // no ray of the block samples
      const bool active = __any_sync(kAll, open);
      if (active) {
        const uint32_t taken = __ballot_sync(
            kAll, open && (!p.mask_out_of_bounds || st.in_bounds) &&
                      part_runs(kAblateNoSampling, st.px));
        gather_chunk<W, kChunk>(p.grids, p.grid, p.grid_chn, r.b, st, taken,
                                n_t == 0, X,
                                n_t == 0 && !cgrid ? T : nullptr, lane);
        if (cgrid)
          gather_chunk<W, kChunk>(p.cgrids, p.color_grid, p.grid_chn, r.b,
                                  st, taken, true, T, nullptr, lane);
        __syncwarp();
      }

      // the relu layers in renderer_fw.cu's order; at j == opacity_end the
      // opacity head's last layer reads X, then X = T + the encoding
      float opacity_raw = 0.0f;
      const bool mlp = !(kAblate & kAblateNoMlp) ||
                       __syncthreads_or(active && X[row * S] == 1234.5f);
      for (int j = 0; mlp; ++j) {
        if (j == opacity_end && active) {
          opacity_raw = layer_out<W>(p, opacity_end, X + row * S, 0);
          __syncwarp();
          for (int i = 0; i < kChunk; ++i) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              X[i * S + 32 * v + lane] = T[i * S + 32 * v + lane] + e[v];
          }
          __syncwarp();
        }
        if (j == n_relu_layers) {
          // past W = 256 the colour head's last layer too, into T
          if constexpr (W > 256)
            staged_rows<W>(ring, (p.layer_in[n_total - 1] + 7) / 8,
                           p.layer_out[n_total - 1], X, S, nullptr,
                           p.mlp + p.layer_b_off[n_total - 1], false,
                           nullptr, nullptr, T, nullptr, S, active, wg,
                           lane);
          break;
        }
        const int l = j < opacity_end ? j : j + 1;
        staged_rows<W>(ring, (p.layer_in[l] + 7) / 8, p.layer_out[l], X, S,
                       nullptr,
                       p.mlp + p.layer_b_off[l], true, nullptr, nullptr, X,
                       !cgrid && j == trunk_end - 1 ? T : nullptr, S, active,
                       wg, lane);
      }
      if (!active) continue;
      if constexpr (kReluMasks) {
        if (open && probe != nullptr)
          write_probe<W>(p, probe, ray, s, tot, opacity_raw, X + row * S,
                         T + row * S);
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
            v[k] = w * (sigmoid(mlp ? colour_raw<W>(p, X + row * S,
                                                    T + row * S, c)
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

    if (!valid) continue;
    if (lane == 0) {
      p.depth[ray] = depth;
      p.nlt[ray] = nlt;
    }
    float* f = p.feat + (long long)ray * p.color_chn;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (32 * v + lane < p.color_chn) f[32 * v + lane] = feat[v];
  }
  cp_async_wait<0>();
}

// The blocks of R1's resident wave of `warps` warps a block.
template <int W>
cudaError_t fw_wave(int warps, int* wave) {
  const size_t smem = (size_t)fw_smem_bytes(W, warps);
  if (warps < 1 || warps > kFwWarps || (long long)smem > kMaxSmemBytes)
    return cudaErrorInvalidValue;
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
  *wave = sms * per_sm;
  return cudaSuccess;
}

template <int W>
cudaError_t launch_fw(const Params& p, int warps, uint4* ws, float* probe,
                      cudaStream_t stream) {
  int wave = 0;
  cudaError_t e = fw_wave<W>(warps, &wave);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)fw_smem_bytes(W, warps);
  const int n_slices = launch_pack(p, kRenderFw, ws, stream);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long needed = (p.num_rays + warps - 1) / warps;
  // past W = 256 the blocks' scratch follows the packed layers
  float* scratch = reinterpret_cast<float*>(
      reinterpret_cast<char*>(ws) + wide_pack_bytes(p, kRenderFw));
  render_fw_wide_kernel<W>
      <<<(int)(needed < wave ? needed : wave), 32 * warps, smem, stream>>>(
          p, ws, n_slices, wide_wgmma(p, W, warps), scratch, probe);
  return cudaGetLastError();
}

// ---- R2 ---------------------------------------------------------------

// Where each layer's sums start in a block's row (wide_sum_floats each).
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
    for (int i = 0; i < kChunk / 4; ++i) {
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

// R2's one-layer colour head's input as R1 holds it: the colour input's
// tile X (the trunk's output or relu of the colour grid's sample) + the
// ray's encoding E, into GX.
template <int W>
__device__ __forceinline__ void colour_input(float* GX, const float* X,
                                             const float* E, int lane) {
  constexpr int S = W + 4, V = W / 32;
  for (int i = 0; i < kChunk; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      GX[i * S + 32 * v + lane] = X[i * S + 32 * v + lane] + E[32 * v + lane];
  }
  __syncwarp();
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
    render_bw_wide_kernel(const Params p, const WideSums ws,
                          const uint4* __restrict__ pack, int n_slices,
                          float* scratch, float* probe) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = W + 4, kTile = kChunk * S, V = W / 32;
  const int n_t = p.n_layers[0], n_o = p.n_layers[1], n_c = p.n_layers[2];
  const int n_total = n_t + n_o + n_c;
  const bool cgrid = p.color_grid != nullptr;
  const BwLayout lay = bw_layout(W, n_total, n_c, cgrid, head_out(p));
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane & (kChunk - 1);
  const bool wg = warps % 4 == 0;  // warpgroups: the products by wgmma
  const bool mine = lane < kChunk;  // the lanes that own a row
  float* const region = smem + (long long)warp * lay.warp_floats;
  for (int i = lane; i < lay.warp_floats; i += 32) region[i] = 0.0f;
  Ring ring = {reinterpret_cast<uint4*>(smem + warps * lay.warp_floats), pack,
               ring_slot_u4(W), n_slices, 0};
  // the warp's tiles: in its region, or (lay.dev) in the block's scratch
  float* tiles = region;
  // past W = 256 (one warp a block) the block's scratch: its stash, its Gt,
  // (lay.dev) its tiles
  if constexpr (W > 256) {
    ring.stash = scratch + (long long)blockIdx.x * bw_scratch_floats(W, lay);
    if (lay.dev) {
      tiles = ring.stash + stash_floats(W) + kChunk * lay.sg;
      for (int i = lane; i < lay.tile_floats; i += 32) tiles[i] = 0.0f;
    }
  }
  // a pointer of this warp's region or tiles less this, warp 0's
  // (block_weight_grad's; 0 past W = 256)
  const long long to0 = -(long long)warp * lay.warp_floats;
  int* active_warps = reinterpret_cast<int*>(
      reinterpret_cast<char*>(ring.slots) + ring_bytes(W));
  ring_start(ring);
  __syncwarp();
  // Slot k holds the input of relu layer k of the forward (slot 0: the
  // feature, relu'd with no trunk; with a colour grid, slot cslot relu of
  // its sample), as renderer_bw.cu numbers them; layer L reads slot L below
  // the colour head, slot cslot + the encoding E at its first layer and
  // slot L - 1 past it.  With a one-layer colour head slot n_slots (XC)
  // holds that input as R1 holds it, for the colours, then the colour
  // input's gradient GX; with more, GX goes over the colour head's first
  // hidden tile.  Gt holds the colour head's output gradient, then the
  // opacity head's (column 0); past W = 256 first its raw outputs.
#define ACT(k) (tiles + (k) * kTile)
  const int n_slots = n_total - 1 + (cgrid ? 1 : 0);
  float* Gt;
  if constexpr (W > 256)
    Gt = ring.stash + stash_floats(W);
  else
    Gt = tiles + lay.gt_off;
  float* E = region + lay.e_off;
  const int sg = lay.sg;
  float* acc = p.g_mlp_partial + (long long)blockIdx.x * ws.total;
  const int opacity_first = n_t, color_first = n_t + n_o;
  const int cslot = cgrid ? n_total - 1 : n_t;
  float* GX = n_c == 1 ? ACT(n_slots) : ACT(color_first);
  const int opacity_end = n_t + n_o - 1;
  const int n_relu_layers = n_total - 2;
  const int mask0 = n_t > 0 ? 1 : 0;
  const int tot = p.num_samples + p.num_samples_inf;
  const int c_pad = sg - 4;

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
    float genc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = 32 * v + lane;
      // no warp reads E before the chunk's first barrier, and every warp
      // is past the last chunk's reads of it
      E[c] = valid && c < p.enc_chn ? p.enc[(long long)ray * p.enc_chn + c]
                                    : 0.0f;
      genc[v] = 0.0f;
    }
    const float* g_feat = p.g_feat + (long long)(valid ? ray : 0) *
                                         p.color_chn;
    const float g_depth = valid ? p.g_depth[ray] : 0.0f;
    const float g_nlt = valid ? p.g_nlt[ray] : 0.0f;
    float nlt_carry = valid ? p.nlt_final[ray] : 0.0f, suffix_carry = 0.0f;
    for (int c0 = (tot - 1) / kChunk * kChunk; c0 >= 0; c0 -= kChunk) {
      const int s = valid && mine ? c0 + lane : tot;
      Step st = {};
      float gate = 0.0f;
      if (s < tot) {
        st = march_step(p, r, s);
        gate = scaffold_gate(p, r.b, st);
      }
      // a chunk with every gate shut adds nothing: sigma = 0 leaves the
      // transmittance, the suffix sum and every cotangent as they are
      const bool open = s < tot && gate != 0.0f;
      if (!__syncthreads_or(open)) continue;  // no ray of the block samples
      const bool active = __any_sync(kAll, open);
      // read by block_weight_grad, behind the barriers to come; every warp
      // is past the last chunk's reads
      if (lane == 0) active_warps[warp] = active;
      const uint32_t taken = __ballot_sync(
          kAll, open && (!p.mask_out_of_bounds || st.in_bounds));
      const bool record = kReluMasks && active && s < tot;

      // ---- the forward, recomputed as R1's, each layer's input kept ----
      if (active) {
        gather_chunk<W, kChunk>(p.grids, p.grid, p.grid_chn, r.b, st, taken,
                                n_t == 0, ACT(0), nullptr, lane);
        if (cgrid)
          gather_chunk<W, kChunk>(p.cgrids, p.color_grid, p.grid_chn, r.b,
                                  st, taken, true, ACT(cslot), nullptr, lane);
        __syncwarp();
      }
      if (record && n_t == 0)
        record_mask<W>(p, ray, s, tot, 0, ACT(0) + row * S);
      if (record && cgrid)
        record_mask<W>(p, ray, s, tot, cslot - mask0, ACT(cslot) + row * S);
      float opacity_raw = 0.0f;
      for (int j = 0;; ++j) {
        if (j == opacity_end && active)
          opacity_raw = layer_out<W>(p, opacity_end,
                                     ACT(opacity_end) + row * S, 0);
        if (j == n_relu_layers) break;
        const int l = j < opacity_end ? j : j + 1;
        const bool xc = l == color_first;
        staged_rows<W>(ring, (p.layer_in[l] + 7) / 8, p.layer_out[l],
                       xc ? ACT(cslot) : ACT(j), S,
                       xc ? E : nullptr, p.mlp + p.layer_b_off[l], true,
                       nullptr, nullptr, ACT(j + 1), nullptr, S, active, wg,
                       lane);
        if (record)
          record_mask<W>(p, ray, s, tot, j + 1 - mask0,
                         ACT(j + 1) + row * S);
      }
      if constexpr (W > 256) {
        // the colour head's last layer as R1 runs it, its raw outputs in Gt
        // (a one-layer colour head reads its input as R1 holds it)
        if (n_c == 1 && active) colour_input<W>(GX, ACT(cslot), E, lane);
        staged_rows<W>(ring, (p.layer_in[n_total - 1] + 7) / 8,
                       p.layer_out[n_total - 1],
                       n_c == 1 ? GX : ACT(n_total - 2), S, nullptr,
                       p.mlp + p.layer_b_off[n_total - 1], false, nullptr,
                       nullptr, Gt, nullptr, sg, active, wg, lane);
      }
      float g_opacity = 0.0f;
      if (active) {
        const float opacity_pre = opacity_raw;  // before the noise
        if (open && p.noise_sigma > 0.0f)
          opacity_raw += step_noise(p, ray, s);
        const float sigma =
            open ? p.gain * softplus(opacity_raw) * gate : 0.0f;
        // the colours (before the gate) wait in the lane's row of Gt; with
        // a one-layer colour head they read its input as R1 holds it
        if (n_c == 1 && W <= 256) colour_input<W>(GX, ACT(cslot), E, lane);
        const float* xrow = (n_c == 1 ? GX : ACT(n_total - 2)) + row * S;
        float* grow = Gt + row * sg;
        if constexpr (kReluMasks) {
          if (open && probe != nullptr)
            write_probe<W>(p, probe, ray, s, tot, opacity_pre, xrow, grow);
        }
        float g_dot = 0.0f;
        for (int c = 0; c < c_pad; ++c) {
          float col = 0.0f;
          if (c < p.color_chn) {
            // (past W = 256 the lanes past 16 read nothing: their rows are
            // written by the lanes that own them)
            col = sigmoid(W > 256 && !mine
                              ? 0.0f
                              : colour_raw<W>(p, xrow, grow, c));
            g_dot += __ldg(g_feat + c) * (col * gate);
          }
          if (mine) grow[c] = col;
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
        g_opacity = g_sigma * p.gain * sigmoid(opacity_raw) * gate;
        nlt_carry = __shfl_sync(kAll, nlt_prev, 0);
        suffix_carry += __shfl_sync(kAll, term_suf, 0);

        // the colour head's output gradient in Gt (the opacity's waits in
        // g_opacity until the colour head is done with Gt)
        for (int c = 0; c < c_pad; ++c) {
          float gv = 0.0f;
          if (c < p.color_chn) {
            const float col = grow[c];
            gv = w * __ldg(g_feat + c) * gate * col * (1.0f - col);
          }
          if (mine) grow[c] = gv;
        }
        __syncwarp();
      }

      // ---- the decoder backward, last layer first ----
      const float* G = Gt;
      int gs = sg;
      for (int L = n_total - 1;; --L) {
        const bool xc = L == color_first;
        const float* X = xc ? (n_c == 1 ? GX : ACT(cslot))
                            : ACT(L > color_first ? L - 1 : L);
        __syncthreads();  // every warp's X and G of this layer are written
        // (past W = 256, one warp a block, G may be Gt and X a tile in
        // device memory)
        if (part_runs(kAblateNoWeightGrad, X[lane]))
          block_weight_grad<W>(acc + ws.off[L], X + to0,
                               xc && n_c > 1 ? E + to0 : nullptr, G + to0, S,
                               gs, lay.warp_floats, active_warps, warps,
                               p.layer_in[L], p.layer_out[L], warp, lane);
        // (the products' first slice is a barrier: every warp is past the
        // weight gradient before any writes over X)
        const int k_steps = (p.layer_out[L] + 7) / 8, n_in = p.layer_in[L];
        if (xc) {
          // the gradient of trunk + encoding, into g_enc; through the relu
          // of the colour grid's sample where there is one
          staged_rows<W>(ring, k_steps, n_in, G, gs, nullptr, nullptr,
                         false, nullptr, nullptr, GX, nullptr, S, active, wg,
                         lane);
          if (active) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              for (int j = 0; j < kChunk; ++j)
                genc[v] += GX[j * S + 32 * v + lane];
            if (cgrid) {
              for (int j = 0; j < kChunk; ++j) {
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  const int k = j * S + 32 * v + lane;
                  if (!(ACT(cslot)[k] > 0.0f)) GX[k] = 0.0f;
                }
              }
            }
            // the opacity head's output gradient, column 0 of Gt
            if (mine) {
              Gt[row * sg] = g_opacity;
              for (int c = 1; c < c_pad; ++c) Gt[row * sg + c] = 0.0f;
            }
            __syncwarp();
          }
          G = Gt;
          gs = sg;
        } else if (L == opacity_first) {
          // the trunk output went through a relu (relu of the feature with
          // no trunk); with a colour grid only the opacity head reads it
          staged_rows<W>(ring, k_steps, n_in, G, gs, nullptr, nullptr,
                         false, ACT(n_t), cgrid ? nullptr : GX, ACT(n_t),
                         nullptr, S, active, wg, lane);
          G = ACT(n_t);
          gs = S;
          if (n_t == 0) break;  // G is the feature gradient
        } else if (L == 0) {
          staged_rows<W>(ring, k_steps, n_in, G, gs, nullptr, nullptr,
                         false, nullptr, nullptr, ACT(0), nullptr, S, active,
                         wg, lane);
          G = ACT(0);  // the feature gradient
          break;
        } else {
          // the layer's input is the relu output of the layer before it
          const int in = L > color_first ? L - 1 : L;
          staged_rows<W>(ring, k_steps, n_in, G, gs, nullptr, nullptr,
                         false, ACT(in), nullptr, ACT(in), nullptr, S, active,
                         wg, lane);
          G = ACT(in);
          gs = S;
        }
      }

      // ---- grid-gradient reductions ----
      if (active && part_runs(kAblateNoAtomics, G[lane])) {
        scatter_chunk<W>(p.grids, p.g_grid, p.grid_chn, r.b, st, taken, G,
                         lane);
        if (cgrid)
          scatter_chunk<W>(p.cgrids, p.g_color_grid, p.grid_chn, r.b, st,
                           taken, GX, lane);
      }
      __syncwarp();  // the tiles are free for the next chunk
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (valid && 32 * v + lane < p.enc_chn)
        p.g_enc[(long long)ray * p.enc_chn + 32 * v + lane] = genc[v];
  }
  cp_async_wait<0>();
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

// Warps per block (the most, up to kBwWarps, whose regions fit with the
// ring in a block's shared memory), the block's shared memory and the
// resident wave of blocks.
template <int W>
cudaError_t bw_config(const Params& p, bool color_grid, int* warps,
                      size_t* smem, int* wave) {
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  const BwLayout lay = bw_layout(W, n_total, p.n_layers[2], color_grid,
                                 head_out(p));
  *warps = bw_warps(W, lay);
  *smem = (size_t)bw_smem_bytes(W, lay, *warps > 0 ? *warps : 1);
  if (*warps == 0) return cudaErrorInvalidValue;
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
cudaError_t launch_bw(const Params& p, uint4* pack, float* probe,
                      cudaStream_t stream) {
  int warps = 0, wave = 0;
  size_t smem = 0;
  const bool cgrid = p.color_grid != nullptr;
  cudaError_t e = bw_config<W>(p, cgrid, &warps, &smem, &wave);
  if (e != cudaSuccess) return e;
  const WideSums ws = wide_sums(p);
  const long long groups = (p.num_rays + warps - 1) / warps;
  const int blocks = (int)(groups < wave ? groups : wave);
  if (blocks > 0) {
    const int n_slices = launch_pack(p, kRenderBw, pack, stream);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    // past W = 256 the blocks' scratch follows the packed layers
    float* scratch = reinterpret_cast<float*>(
        reinterpret_cast<char*>(pack) + wide_pack_bytes(p, kRenderBw));
    render_bw_wide_kernel<W><<<blocks, 32 * warps, smem, stream>>>(
        p, ws, pack, n_slices, scratch, probe);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  reduce_wide_sums_kernel<<<(p.n_params + 255) / 256, 256, 0, stream>>>(
      p, ws, blocks);
  return cudaGetLastError();
}

}  // namespace

// One width's R1 and R2 launchers, as renderer_wide.cu's entry points call
// them (fw_wave, launch_fw, bw_config, launch_bw and the kernels'
// attributes).
struct WideOps {
  cudaError_t (*fw_wave)(int warps, int* wave);
  cudaError_t (*launch_fw)(const Params& p, int warps, uint4* ws,
                           float* probe, cudaStream_t stream);
  int (*fw_attrs)(int* out);
  cudaError_t (*bw_config)(const Params& p, bool color_grid, int* warps,
                           size_t* smem, int* wave);
  cudaError_t (*launch_bw)(const Params& p, uint4* pack, float* probe,
                           cudaStream_t stream);
  int (*bw_attrs)(int* out);
};

// R1's launchers at W (the fw_* members; the others null).
template <int W>
WideOps make_wide_fw_ops() {
  WideOps ops = {};
  ops.fw_wave = fw_wave<W>;
  ops.launch_fw = launch_fw<W>;
  ops.fw_attrs = [](int* out) {
    return kernel_attrs(render_fw_wide_kernel<W>, out);
  };
  return ops;
}

// R2's launchers at W (the bw_* members; the others null).
template <int W>
WideOps make_wide_bw_ops() {
  WideOps ops = {};
  ops.bw_config = bw_config<W>;
  ops.launch_bw = launch_bw<W>;
  ops.bw_attrs = [](int* out) {
    return kernel_attrs(render_bw_wide_kernel<W>, out);
  };
  return ops;
}

// R1's launchers from `fw` and R2's from `bw`.
inline WideOps join_wide_ops(WideOps fw, const WideOps& bw) {
  fw.bw_config = bw.bw_config;
  fw.launch_bw = bw.launch_bw;
  fw.bw_attrs = bw.bw_attrs;
  return fw;
}

// The builds by width, each compiled apart (renderer_wide_<W>.cu, and past
// 256, where one kernel takes as long to compile as a narrower width's
// two, renderer_wide_<W>_fw.cu and _bw.cu: R1 and R2 apart), so that nvcc
// builds them in parallel; renderer_wide.cu's entry points call them.
WideOps wide_ops_96();
WideOps wide_ops_128();
WideOps wide_ops_192();
WideOps wide_ops_256();
WideOps wide_fw_ops_384();
WideOps wide_bw_ops_384();
WideOps wide_fw_ops_512();
WideOps wide_bw_ops_512();
WideOps wide_fw_ops_768();
WideOps wide_bw_ops_768();

}  // namespace lightplane
