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
// corner_weight into the weight grid w [V]: the C+1 fused weight channel.
// Masked steps (mask_out_of_bounds and the point outside [-1, 1]^3) splat
// nothing; corners outside a sub-grid are dropped.
//
// What bounds it.  At bench.py's splatter headline (262,144 rays, 96
// samples, one 160^3 x 64ch voxel grid, 1.05 GB, 20x the 50 MB L2) the
// splat makes ~1.1e8 corner updates of 65 floats.  Made one by one into the
// grid in device memory, as a thread per ray did before, every update is a
// read-modify-write of a 256-byte row that is almost never in L2: ~28 GB of
// reductions, 98% of that kernel's time.  So the updates are summed on chip
// first, in the manner of the TPU's sorted splat (splatter_sorted.py:1-40):
//
// 1. Bricks.  Each output sub-grid is cut into bricks of bz x by x bx cells
//    (the wrapper picks them, splatter_fw.py::pick_bricks: the largest
//    that let three blocks of four warps share an SM, BLOCK_SMEM_BUDGET,
//    after the brick sweep of PERF.md, section 6).  A sample's key in a sub-grid is the
//    brick that holds its cell's lower corner, clamped into the grid, so
//    that the border half-cells fall into the border bricks; the brick's
//    tile of (bz+1)(by+1)(bx+1) rows then holds every corner of the sample.
// 2. The plan, a counting sort of runs (consecutive steps of one ray with
//    one key in one sub-grid): a count pass and, after a prefix sum over
//    the bricks (torch.cumsum in the wrapper, as the JAX package builds its
//    plan in XLA), a fill pass that writes each run as (ray, first step |
//    last step << 16) into its brick's segment.  Both march a ray per
//    thread with march_common.cuh's geometry, so a run's key and the splat
//    pass's corners agree to the bit, and aggregate their integer atomics
//    over the warp's lanes that close a run of one brick at one step.  The
//    list is allocated from a bound the host knows from the shapes
//    (splatter_fw.py::plan_shape), so nothing is read back: per ray, the
//    lesser of the step count and the bricks a straight ray can cross (the
//    step count with contraction or background steps).  With the small
//    bricks that three blocks an SM allow, that is the step count at the
//    splat headline, so a list is O(rays x samples); the wrapper splits the
//    rays so that no list holds more than PLAN_MAX_RUNS runs, which caps the
//    plan's memory.  A run past the bound traps the fill pass.
// 3. The splat, one output sub-grid per launch (so that the run list holds
//    one sub-grid's runs).  A work item is a brick and a slice of at most K
//    of its runs; a resident wave of blocks of four warps walks the items,
//    every warp its own items in its own tile of rows of C channels and the
//    weight, so that it adds with plain shared-memory loads and stores:
//    float atomicAdd on shared memory is a compare-and-swap loop on sm_90
//    (ATOMS.CAST.SPIN), and when a block's warps shared one tile those
//    loops took 8.5 of S1's 19.8 ms on an H100 (PERF.md, section 6).  A
//    warp takes 32 runs at a time, a lane per run: the lanes load their
//    records and rays together, copy the runs' encodings into shared memory
//    (cp.async; read once per run), and march their runs' steps together,
//    each working out its step's corner rows and weights; then per step the
//    warp adds weight x value into the step's corner rows, lanes over pairs
//    of columns (lane l owns columns 2l and 2l + 1 of a pass of 64
//    channels, one 8-byte access; the weight is a column of value 1),
//    every corner's load issued before any store.  At the end of the item
//    every row it touched is flushed into feat and w with float4
//    reductions (scalar where C % 4 != 0) and zeroed: reductions, because
//    halo rows and the slices of one brick overlap.  A touched row costs
//    one reduction per item instead of one per corner.
// 4. The MLP variant at padded widths 32 and 64, on the same plan and
//    tile: per step the warp samples the input grid-list (lanes over
//    channels) and runs the MLP from layers staged in shared memory
//    (stage_layers), lanes over output units, the inputs broadcast by
//    shuffles.  A sample has one run per output sub-grid, so a triplane
//    output runs its MLP once per plane.
// 5. The per-step variant (kSteps): the value splatted at step s of a run's
//    ray is row ray * steps + s of the "encoding" [rays, steps, C], not the
//    ray's row, so each run's lane copies its run's row of the next step
//    into one of two staging buffers while the warp splats the current
//    step, in passes of 64 channels; its work items are smaller (the
//    wrapper's RUNS_PER_ITEM_STEPS), since a slice of rays fills few
//    bricks.  kSteps = 1 is the adjoint's pass B (splatter_bw.cu: the
//    staged MLP input gradient over the input grid-list, no weight column
//    flushed); kSteps = 2 is pass S of the wide MLP build (6), the weight
//    flushed as the other variants flush it.
// 6. The MLP variant at padded widths 96 to 256, in two passes over
//    slices of the rays (splatter_fw.py::mlp_slices: the staging and each
//    run list within PLAN_MAX_RUNS' bytes).  A ray marches in brick order
//    as many times as it has output sub-grids, so running the MLP there
//    (W^2 multiply-adds a layer a step on the CUDA cores, its weights read
//    from L1 at every product: the first wide build, 851 ms at W = 128 on
//    the MLP splat into 3 x 128^2 x 128ch on an H100, PERF.md section 6)
//    runs it once per plane.  Here,
//    as the TPU kernel does (splatter_pallas.py:57-117: each step's vector
//    once, then splatted into every sub-grid):
//    - pass F (splat_mlp_wide_kernel, ray-major): a block's 8 warps march
//      a ray each in lockstep over 16-step chunks, R1-wide's design
//      (renderer_wide.cuh, wide_mlp.cuh): the input grid-list's sample
//      gathered into a [16][W + 4] tile (gather_chunk) plus the encoding,
//      then every layer on the tensor cores in 3xTF32 (wgmma a warpgroup),
//      each layer staged once a block through the cp.async ring, relu
//      between the layers; each sampled step's C outputs go to the staging
//      [rays of the slice, steps, C];
//    - pass S: the per-step variant (kSteps = 2) by S1's own plan, once per
//      output sub-grid.
//    A masked step is in no run, so its row of the staging is never
//    written nor read.  What bounds it at that splat (32 -> 128 -> 128,
//    2.5e7 steps): 1.03e12 FLOPs, 15.5 ms at the FP32 rate, ~6 ms in
//    3xTF32 at the tensor cores'; the staging ~52 GB written and read,
//    ~15 ms.  Measured on an H100 (PERF.md, section 6): ~128 ms, pass F
//    ~57 (the block barriers between slices), the per-step splats ~45,
//    the plans ~19 (128 channels leave bricks of 1 x 2 x 2 cells).
//
// The timings with parts switched off build it with march_common.cuh's
// LIGHTPLANE_ABLATE: 32 = the plan alone (no splat pass; pass F still
// runs), 64 = plan and tile accumulation without the flush; S2's bits 128
// and 512 leave out the adjoint's per-step splat (pass B).
//
// Numerics: f32; the fill pass's atomics order the runs of a brick, and the
// flush's reductions the items, differently from run to run, so the sums
// are order-dependent.

#include "splat_common.cuh"
#include "wide_mlp.cuh"

namespace {

using namespace lightplane;

constexpr int kPlanThreads = 128;
constexpr int kWarps = 4;  // warps per block of the splat pass
constexpr int kSplatThreads = 32 * kWarps;
constexpr int kBatch = 32;  // runs a warp marches together, a lane each
constexpr unsigned kAll = 0xffffffffu;

// The bricks of the output grid-list and the buffers of the plan.
struct Plan {
  int brick[kMaxGrids][3];   // cells per brick along D, H, W
  int nb[kMaxGrids][3];      // bricks along D, H, W
  int first[kMaxGrids + 1];  // the first brick id of each sub-grid; the
                             // last entry is the number of bricks
  int* counts;               // count pass: runs per brick, zero-filled
  int* cursor;               // fill pass: runs written per brick, zero-filled
  const int* offsets;        // [bricks + 1]: the first run of each brick
  int2* runs;                // [capacity]: (ray, first step | last << 16)
  long long capacity;
  const int* item_start;     // [bricks + 1]: the first work item of each
  int runs_per_item;         // K
  int max_rows;              // tile rows of the largest brick
  int stage;                 // staged channels of a run's encoding
  int warp_floats;           // floats of a warp's region of shared memory
};

// Tile extent of a brick of `cells` cells along an axis of `size` cells: its
// cells and the upper corner of the last (none for a singleton axis).
__host__ __device__ __forceinline__ int tile_extent(int cells, int size) {
  return size > 1 ? cells + 1 : 1;
}

// The brick of sub-grid g that holds the lower corner of the point of `st`
// for batch b, clamped into the grid, or -1 where the point has no
// in-bounds corner in it (the lower corner outside [-1, size - 1]).
__device__ __forceinline__ int brick_of(const GridMeta& m, const Plan& pl,
                                        int g, int b, const Step& st) {
  const Cell c = grid_cell(m, g, st);
  const int D = m.dims[g][1], H = m.dims[g][2], W = m.dims[g][3];
  if (!(c.z0 >= -1.0f && c.z0 <= (float)(D - 1) && c.y0 >= -1.0f &&
        c.y0 <= (float)(H - 1) && c.x0 >= -1.0f && c.x0 <= (float)(W - 1)))
    return -1;
  const int kz = max((int)c.z0, 0) / pl.brick[g][0];
  const int ky = max((int)c.y0, 0) / pl.brick[g][1];
  const int kx = max((int)c.x0, 0) / pl.brick[g][2];
  return pl.first[g] +
         ((b * pl.nb[g][0] + kz) * pl.nb[g][1] + ky) * pl.nb[g][2] + kx;
}

// The plan's passes: a thread per ray cuts each sub-grid's march into runs
// and counts them per brick (kFill false) or writes them into their
// bricks' segments (kFill true).  Every lane walks every step, so the lanes
// that close a run at a step do so together and aggregate per brick.
template <bool kFill>
__global__ void __launch_bounds__(kPlanThreads)
    splat_plan_kernel(const SplatParams sp, const Plan pl) {
  const Params& p = sp.m;
  const int ray = blockIdx.x * kPlanThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  Ray r = {};
  r.b = -1;
  if (ray < p.num_rays) r = load_ray(p, ray);
  const int tot = p.num_samples + p.num_samples_inf;
  for (int g = 0; g < sp.out.num_grids; ++g) {
    int cur = -1, s0 = 0;
    for (int s = 0; s <= tot; ++s) {
      int key = -1;
      if (s < tot && r.b >= 0) {
        const Step st = march_step(p, r, s);
        if (!(p.mask_out_of_bounds && !st.in_bounds))
          key = brick_of(sp.out, pl, g, r.b, st);
      }
      const bool close = cur >= 0 && key != cur;
      const unsigned closing = __ballot_sync(kAll, close);
      if (close) {
        const unsigned peers = __match_any_sync(closing, cur);
        const int leader = __ffs(peers) - 1;
        const int n = __popc(peers);
        if (kFill) {
          int base = 0;
          if (lane == leader) base = atomicAdd(pl.cursor + cur, n);
          base = __shfl_sync(peers, base, leader);
          const long long at = (long long)pl.offsets[cur] + base +
                               __popc(peers & ((1u << lane) - 1u));
          // plan_shape's bound holds the runs; a run past it is a fault
          // of that bound, and fails loudly rather than splat wrong
          if (at >= pl.capacity) __trap();
          pl.runs[at] =
              make_int2(ray, (int)((unsigned)s0 | ((unsigned)(s - 1) << 16)));
        } else if (lane == leader) {
          atomicAdd(pl.counts + cur, n);
        }
      }
      if (key != cur) {
        cur = key;
        s0 = s;
      }
    }
  }
}

// The channel slices of 32 a lane holds: 2 (C <= 64 per pass) without the
// MLP, W / 32 with it.
template <int W>
constexpr int kSlices = W == 32 ? 1 : 2;

// The warp's splat vector of the step `st` into v (lane c owns channels c,
// c + 32): MLP(input_grid[point] + encoding), the encoding held in e, the
// layers staged in shared memory (W = 32 or 64).
template <int W>
__device__ __forceinline__ void mlp_vector(const Params& p,
                                           const float* layers, int b,
                                           const Step& st,
                                           const float (&e)[kSlices<W>],
                                           float (&v)[kSlices<W>]) {
  constexpr int kS = kSlices<W>;
  constexpr int kLayer = W * W + W;
  const int lane = threadIdx.x & 31;
  const int C_in = p.grid_chn;
  float x[kS];
#pragma unroll
  for (int k = 0; k < kS; ++k) x[k] = e[k];
  for_each_corner(p.grids, b, st, [&](long long row, float wgt) {
    const float* src = p.grid + row * C_in;
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int c = lane + 32 * k;
      if (c < C_in) x[k] += wgt * __ldg(src + c);
    }
  });
  const int L = p.n_layers[0];
  for (int l = 0; l < L; ++l) {
    const float* lay = layers + l * kLayer;
    float y[kS];
#pragma unroll
    for (int k = 0; k < kS; ++k) y[k] = lay[W * W + lane + 32 * k];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float xi = __shfl_sync(kAll, x[i / 32], i % 32);
#pragma unroll
      for (int k = 0; k < kS; ++k) y[k] += xi * lay[i * W + lane + 32 * k];
    }
    const bool relu = l < L - 1;
#pragma unroll
    for (int k = 0; k < kS; ++k) x[k] = relu ? fmaxf(y[k], 0.0f) : y[k];
  }
#pragma unroll
  for (int k = 0; k < kS; ++k) v[k] = x[k];
}

// Floats of a tile row: C channels and the weight, rounded up to an even
// count so that a lane's pair of columns is one 8-byte access.
__host__ __device__ __forceinline__ int row_floats(int C) {
  return (C + 2) & ~1;
}

// Floats of a warp's tile of `rows` rows, rounded up to 16 bytes (the
// staging area after it takes 16-byte copies).
__host__ __device__ __forceinline__ int tile_floats(int rows, int C) {
  return (rows * row_floats(C) + 3) & ~3;
}

// Floats of one warp's region of shared memory: its tile of `rows` rows
// and the staged encodings of a batch of runs (`stage` floats each: the
// channels of one run, two steps' worth in the per-step variant), a
// multiple of 16 bytes.
__host__ __device__ __forceinline__ int warp_floats(int rows, int C,
                                                    int stage) {
  return tile_floats(rows, C) + ((kBatch * stage + 3) & ~3);
}

// Channels of a run's staged encoding: one or two slices of 32 (a pass of
// at most 64 of the encoding's E channels).
__host__ __device__ __forceinline__ int stage_chn(int E) {
  return E <= 32 ? 32 : 64;
}

// dst = *src (4 bytes), or 0 where !ok (src is then not read), copied from
// device memory into shared memory without passing through registers
// (cp.async).
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// dst[0:4) = src[0:4) (16 bytes, both aligned to it), or 0 where !ok (src
// is then not read), by cp.async.
__device__ __forceinline__ void copy_async16(float* dst, const float* src,
                                             bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// A tile row's weight column starts at -0.0 and every weight added to it is
// >= +0, so a row that no step touched still holds the bits of -0.0.
constexpr float kUntouched = -0.0f;

__device__ __forceinline__ bool touched(float w) {
  return __float_as_uint(w) != 0x80000000u;
}

// The splat pass: a resident wave of blocks of kWarps warps; every warp
// walks its own work items and sums each brick's slice of runs in its own
// tile, then flushes the rows it touched.  W = 0 splats the encoding, in
// passes of 64 channels; W = 32 or 64 the MLP's output (its layers staged
// once per block).  kC = 8 corners per step for a voxel grid, 4 for a plane
// (and a line or a point, whose missing corners are out of bounds); kT = 2
// where the weight lies past a pass's 32 pairs of channels (C >= 64): lane
// 0 adds it apart; else 1.  kSteps (W = 0): the per-step values, 1 for the
// adjoint's pass B (the weight column not flushed), 2 for the wide MLP
// build's pass S.
template <int W, int kC, int kT, int kSteps = 0>
__global__ void __launch_bounds__(kSplatThreads)
    splat_fw_kernel(const SplatParams sp, const Plan pl) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kS = kSlices<W>;
  constexpr bool kStepVals = kSteps != 0;
  constexpr bool kWeight = kSteps != 1;  // the weight column is flushed
  const Params& p = sp.m;
  const GridMeta& out = sp.out;
  const int C = sp.out_chn;
  const int C1 = row_floats(C);
  const int L = W ? p.n_layers[0] : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int E = W ? p.enc_chn : C;  // the encoding's channels
  const int SC = pl.stage;
  float* tile = smem + L * (W * W + W) + warp * pl.warp_floats;
  float* stage = tile + tile_floats(pl.max_rows, C);
  if constexpr (W > 0) stage_layers<W>(p, smem, L);
  for (int i = lane; i < pl.max_rows * C1; i += 32)
    tile[i] = i % C1 == C ? kUntouched : 0.0f;  // the padding stays 0
  __syncthreads();  // the layers; after it the warps never wait on another

  const int n_bricks = pl.first[out.num_grids];
  const int n_items = __ldg(pl.item_start + n_bricks);
  const int passes = W ? 1 : (C + 63) / 64;
  const bool vec4 = (C & 3) == 0;
  for (int item = blockIdx.x * kWarps + warp; item < n_items;
       item += gridDim.x * kWarps) {
    // the brick: the last one whose items start at or before `item`, by
    // a search that cuts the range 32 ways a step, a probe per lane
    int brick = 0, hi = n_bricks;
    while (hi - brick > 1) {
      const int step = (hi - brick + 31) / 32;
      const int at = brick + lane * step;
      const unsigned le = __ballot_sync(
          kAll, at < hi && __ldg(pl.item_start + at) <= item);
      brick += (31 - __clz(le)) * step;
      hi = min(brick + step, hi);
    }
    int g = 0;
    while (brick >= pl.first[g + 1]) ++g;
    const int D = out.dims[g][1], H = out.dims[g][2], Wd = out.dims[g][3];
    int id = brick - pl.first[g];
    const int kx = id % pl.nb[g][2];
    id /= pl.nb[g][2];
    const int ky = id % pl.nb[g][1];
    id /= pl.nb[g][1];
    const int kz = id % pl.nb[g][0];
    const int b = id / pl.nb[g][0];
    const int oz = kz * pl.brick[g][0], oy = ky * pl.brick[g][1],
              ox = kx * pl.brick[g][2];
    const int ey = tile_extent(pl.brick[g][1], H),
              ex = tile_extent(pl.brick[g][2], Wd);
    const int ez = tile_extent(pl.brick[g][0], D);
    const long long first_run =
        (long long)__ldg(pl.offsets + brick) +
        (long long)(item - __ldg(pl.item_start + brick)) * pl.runs_per_item;
    const long long end_run = min(first_run + pl.runs_per_item,
                                  (long long)__ldg(pl.offsets + brick + 1));

    for (long long batch = first_run; batch < end_run; batch += kBatch) {
      // a lane per run: its record and its ray
      const int n_runs = (int)min((long long)kBatch, end_run - batch);
      int ray = 0, s0 = 0, len = 0;
      Ray r = {};
      if (lane < n_runs) {
        const int2 rec = pl.runs[batch + lane];
        ray = rec.x;
        s0 = rec.y & 0xffff;
        len = ((rec.y >> 16) & 0xffff) - s0 + 1;
        r = load_ray(p, ray);
      }
      const int max_len = __reduce_max_sync(kAll, len);
      for (int pass = 0; pass < passes; ++pass) {
        const int c0 = 64 * pass;
        // the batch's encodings (this pass's channels), read once a run:
        // every copy in flight at once, straight into shared memory
        for (int j = 0; j < n_runs && !kStepVals; ++j) {
          const long long at = (long long)__shfl_sync(kAll, ray, j) * E;
          for (int c = lane; c < SC; c += 32)
            copy_async(stage + j * SC + c,
                       c0 + c < E ? p.enc + at + c0 + c : p.enc,
                       c0 + c < E);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();
        // the pass's columns, in pairs: 64 channels at most, then (pass 0)
        // the weight at column C; lane l owns the pair at column c0 + 2l
        // and, where C >= 64 (kT = 2), lane 0 the weight
        const int cend = min(c0 + 64, C);
        const int a = c0 + 2 * lane;
        const bool own = a < cend || (pass == 0 && a <= C && C <= a + 1);
        const bool own_w = kT > 1 && pass == 0 && lane == 0;
        // kSteps: each live run's value of step `st` (row ray * steps +
        // s0 + st of the encoding, the pass's <= 64 channels) into its row
        // of buffer st % 2 of the staging area, copied by the run's own
        // lane 16 bytes at a time (4 where E % 4 != 0), as one group of
        // copies
        const float* vrow0 =
            p.enc +
            ((long long)ray * (p.num_samples + p.num_samples_inf) + s0) * E;
        auto stage_step = [&](int st) {
          float* row = stage + (st & 1) * kBatch * SC + lane * SC;
          const float* src = vrow0 + (long long)st * E + c0;
          if (st < len && (E & 3) == 0)
            for (int c = 0; c < SC; c += 4)
              copy_async16(row + c, c0 + c < E ? src + c : p.enc,
                           c0 + c < E);
          else if (st < len)
            for (int c = 0; c < SC; ++c)
              copy_async(row + c, c0 + c < E ? src + c : p.enc, c0 + c < E);
          asm volatile("cp.async.commit_group;\n" ::: "memory");
        };
        if constexpr (kStepVals) stage_step(0);
        for (int step = 0; step < max_len; ++step) {
          const float* vals = stage;
          if constexpr (kStepVals) {
            // the next step's copies go out before this step's are waited
            // for: its buffer's reads ended with the step before this one
            if (step + 1 < max_len) {
              stage_step(step + 1);
              asm volatile("cp.async.wait_group 1;\n" ::: "memory");
            } else {
              asm volatile("cp.async.wait_group 0;\n" ::: "memory");
            }
            __syncwarp();
            vals = stage + (step & 1) * kBatch * SC;
          }
          // a lane per run: its step's corners in the tile, each as the
          // offset of its row (-1 where out of the grid) and its weight
          int crow[kC];
          float cw[kC];
          float px = 0.0f, py = 0.0f, pz = 0.0f;
          const bool has = step < len;
          if (has) {
            const Step st = march_step(p, r, s0 + step);
            const Cell cell = grid_cell(out, g, st);
            const int z0 = (int)cell.z0 - oz, y0 = (int)cell.y0 - oy,
                      x0 = (int)cell.x0 - ox;
#pragma unroll
            for (int q = 0; q < kC; ++q) {
              // corner q's bits go to the axes that are not singletons,
              // x first
              int bit = 0;
              const int dx = Wd > 1 ? q >> bit++ & 1 : 0;
              const int dy = H > 1 ? q >> bit++ & 1 : 0;
              const int dz = D > 1 ? q >> bit++ & 1 : 0;
              const int lz = z0 + dz, ly = y0 + dy, lx = x0 + dx;
              const bool ok = (q >> bit) == 0 && oz + lz >= 0 &&
                              oz + lz < D && oy + ly >= 0 && oy + ly < H &&
                              ox + lx >= 0 && ox + lx < Wd;
              const float wz = dz ? cell.tz : (1.0f - cell.tz);
              const float wy = dy ? cell.ty : (1.0f - cell.ty);
              const float wx = dx ? cell.tx : (1.0f - cell.tx);
              cw[q] = wx * wy * wz;
              crow[q] = ok ? ((lz * ey + ly) * ex + lx) * C1 : -1;
            }
            px = st.px;
            py = st.py;
            pz = st.pz;
          }
          for (unsigned todo = __ballot_sync(kAll, has); todo;
               todo &= todo - 1) {
            const int j = __ffs(todo) - 1;
            int at[kC];
            float wgt[kC];
#pragma unroll
            for (int q = 0; q < kC; ++q) {
              at[q] = __shfl_sync(kAll, crow[q], j);
              wgt[q] = __shfl_sync(kAll, cw[q], j);
            }
            // the values of the lane's pair of columns: channels, the
            // weight's 1, padding's 0
            float x0 = 0.0f, x1 = 0.0f;
            if constexpr (W > 0) {
              float e[kS], o[kS];
#pragma unroll
              for (int k = 0; k < kS; ++k)
                e[k] = lane + 32 * k < SC ? stage[j * SC + lane + 32 * k]
                                          : 0.0f;
              Step st = {};
              st.px = __shfl_sync(kAll, px, j);
              st.py = __shfl_sync(kAll, py, j);
              st.pz = __shfl_sync(kAll, pz, j);
              mlp_vector<W>(p, smem, b, st, e, o);
              // unit c lives on lane c % 32, slice c / 32
              const float u0 = __shfl_sync(kAll, o[0], (2 * lane) & 31);
              const float u1 = __shfl_sync(kAll, o[0], (2 * lane + 1) & 31);
              x0 = u0;
              x1 = u1;
              if constexpr (kS > 1) {
                const float w0 = __shfl_sync(kAll, o[1], (2 * lane) & 31);
                const float w1 =
                    __shfl_sync(kAll, o[1], (2 * lane + 1) & 31);
                if (lane >= 16) {
                  x0 = w0;
                  x1 = w1;
                }
              }
            } else if (2 * lane < SC) {
              const float2 xv =
                  *reinterpret_cast<const float2*>(vals + j * SC + 2 * lane);
              x0 = xv.x;
              x1 = xv.y;
            }
            if (a >= cend) x0 = pass == 0 && a == C ? 1.0f : 0.0f;
            if (a + 1 >= cend) x1 = pass == 0 && a + 1 == C ? 1.0f : 0.0f;
            // the rows of one step differ: every load goes out before any
            // add and store
            float2 acc[kC];
            float acc_w[kC];
#pragma unroll
            for (int q = 0; q < kC; ++q) {
              if (at[q] >= 0 && own)
                acc[q] = *reinterpret_cast<float2*>(tile + at[q] + a);
              if (at[q] >= 0 && own_w) acc_w[q] = tile[at[q] + C];
            }
#pragma unroll
            for (int q = 0; q < kC; ++q) {
              if (at[q] >= 0 && own)
                *reinterpret_cast<float2*>(tile + at[q] + a) = make_float2(
                    acc[q].x + wgt[q] * x0, acc[q].y + wgt[q] * x1);
              if (at[q] >= 0 && own_w) tile[at[q] + C] = acc_w[q] + wgt[q];
            }
          }
          if constexpr (kStepVals) __syncwarp();  // before the next step's copies
        }
        __syncwarp();  // before the next pass or batch restages
      }
    }

    // flush every row this item touched into feat and w, and zero it: a
    // lane per row finds the touched rows, then lanes over channels reduce
    // each of them
    const int rows = ez * ey * ex;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int row = r0 + lane;
      const float wv = row < rows ? tile[row * C1 + C] : kUntouched;
      const int lx = row % ex, ly = (row / ex) % ey, lz = row / (ex * ey);
      const long long grow =
          out.row_offset[g] +
          (((long long)b * D + oz + lz) * H + oy + ly) * (long long)Wd + ox +
          lx;
      for (unsigned todo = __ballot_sync(kAll, touched(wv)); todo;
           todo &= todo - 1) {
        const int j = __ffs(todo) - 1;
        const long long gr = __shfl_sync(kAll, grow, j);
        float* t = tile + (r0 + j) * C1;
        if (vec4) {
          for (int c4 = lane; c4 < C / 4; c4 += 32) {
            float* src = t + 4 * c4;
            const float4 fv = make_float4(src[0], src[1], src[2], src[3]);
            src[0] = src[1] = src[2] = src[3] = 0.0f;
            if (part_runs(kAblateNoFlush, fv.x))
              atomicAdd(reinterpret_cast<float4*>(sp.feat + gr * C) + c4, fv);
          }
        } else {
          for (int c = lane; c < C; c += 32) {
            const float fv = t[c];
            t[c] = 0.0f;
            if (part_runs(kAblateNoFlush, fv))
              atomicAdd(sp.feat + gr * C + c, fv);
          }
        }
      }
      if (touched(wv)) {
        tile[row * C1 + C] = kUntouched;
        if (kWeight && part_runs(kAblateNoFlush, wv))
          atomicAdd(sp.w + grow, wv);
      }
    }
    __syncwarp();
  }
}

// Bytes of dynamic shared memory of a splat block: the MLP's layers (W =
// 32 or 64), then each warp's region.
long long splat_smem_bytes(int width, int n_layers, int max_rows, int C,
                           int stage) {
  return 4LL * (n_layers * (width * width + width) +
                kWarps * warp_floats(max_rows, C, stage));
}

template <int W, int kC, int kT, int kSteps>
cudaError_t launch_splat(const SplatParams& sp, const Plan& pl,
                         long long max_items, cudaStream_t stream) {
  const size_t smem = (size_t)splat_smem_bytes(
      W, W ? sp.m.n_layers[0] : 0, pl.max_rows, sp.out_chn,
      pl.stage * (kSteps ? 2 : 1));
  cudaError_t e = cudaFuncSetAttribute(
      splat_fw_kernel<W, kC, kT, kSteps>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, splat_fw_kernel<W, kC, kT, kSteps>, kSplatThreads, smem);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * sms;
  const long long wanted = (max_items + kWarps - 1) / kWarps;
  const long long blocks = resident < wanted ? resident : wanted;
  if (blocks < 1) return cudaSuccess;
  splat_fw_kernel<W, kC, kT, kSteps>
      <<<(int)blocks, kSplatThreads, smem, stream>>>(sp, pl);
  return cudaGetLastError();
}

// The splat pass with kC corners a step (8 where the sub-grid has no
// singleton axis) and kT = 2 where C >= 64 (the weight apart).
template <int W, int kT, int kSteps>
cudaError_t launch_splat(const SplatParams& sp, const Plan& pl,
                         long long max_items, cudaStream_t stream) {
  const int* d = sp.out.dims[0];
  return d[1] > 1 && d[2] > 1 && d[3] > 1
             ? launch_splat<W, 8, kT, kSteps>(sp, pl, max_items, stream)
             : launch_splat<W, 4, kT, kSteps>(sp, pl, max_items, stream);
}

template <int W, int kSteps = 0>
cudaError_t launch_splat(const SplatParams& sp, const Plan& pl,
                         long long max_items, cudaStream_t stream) {
  // W = 32 bounds the output at 32 channels
  if (W != 32 && sp.out_chn >= 64)
    return launch_splat<W, W == 32 ? 1 : 2, kSteps>(sp, pl, max_items,
                                                    stream);
  return launch_splat<W, 1, kSteps>(sp, pl, max_items, stream);
}


// ---- the wide MLP build's pass F (W = 96, 128, 192, 256) --------------------

constexpr int kFWarps = 8;  // pass F: warps (rays) a block, two warpgroups
constexpr long long kMaxSmemBytes = 232448;  // a Hopper block's 227 KB

// Bytes of a pass F block's shared memory: each warp's [16][W + 4] tile,
// then the ring (116,736 at W = 128, 149,504 at 192, 182,272 at 256; one
// block an SM).
__host__ __device__ __forceinline__ long long pass_f_smem_bytes(int W,
                                                                int warps) {
  return 4LL * warps * kChunk * (W + 4) + ring_bytes(W);
}

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
// kSplatFw: every layer, relu between them), in place in the warp's tile.
template <int W>
__global__ void __launch_bounds__(32 * kFWarps, 1)
    splat_mlp_wide_kernel(const SplatParams sp, const uint4* __restrict__ ws,
                          int n_slices, bool wg, float* __restrict__ values) {
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

// Pass F's warps, shared memory and resident wave of blocks.
template <int W>
cudaError_t pass_f_config(size_t* smem, int* wave) {
  *smem = (size_t)pass_f_smem_bytes(W, kFWarps);
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
      &per_sm, splat_mlp_wide_kernel<W>, 32 * kFWarps, *smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *wave = sms * per_sm;
  return cudaSuccess;
}

// The pre-pass (the packed layers into `workspace`), then pass F.
template <int W>
cudaError_t launch_pass_f(const SplatParams& sp, void* workspace,
                          float* values, cudaStream_t stream) {
  size_t smem = 0;
  int wave = 0;
  cudaError_t e = pass_f_config<W>(&smem, &wave);
  if (e != cudaSuccess) return e;
  if ((e = launch_wide_pack(sp.m, kSplatFw, workspace, stream)) != cudaSuccess)
    return e;
  const long long needed = (sp.m.num_rays + kFWarps - 1) / kFWarps;
  splat_mlp_wide_kernel<W>
      <<<(int)(needed < wave ? needed : wave), 32 * kFWarps, smem, stream>>>(
          sp, static_cast<const uint4*>(workspace),
          wide_slices(sp.m, kSplatFw), kFWarps % 4 == 0, values);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the splat pass needs.
//   in_chn: the encoding's channels with the MLP (n_layers > 0); at widths
//   above 64 the splat pass is the per-step variant's (pass S)
long long lightplane_splat_fw_smem_bytes(int width, int n_layers,
                                         int max_rows, int out_chn,
                                         int in_chn) {
  const int per_pass = out_chn < 64 ? out_chn : 64;
  if (n_layers && width > 64)
    return splat_smem_bytes(0, 0, max_rows, out_chn,
                            2 * stage_chn(per_pass));
  const int E = n_layers ? in_chn : per_pass;
  return splat_smem_bytes(width, n_layers, max_rows, out_chn, stage_chn(E));
}

// The wide MLP build's pass F at `width` (96-256) for n_layers layers of
// mlp_widths (host int[n_layers + 1]): out[0] warps per block, out[1] a
// block's shared memory in bytes, out[2] the bytes of the workspace of
// packed layers; a cudaError_t code.
int lightplane_splat_fw_mlp_config(int width, int n_layers,
                                   const int* mlp_widths, int* out) {
  if (n_layers < 1 || n_layers > kMaxLayers || width <= 64 ||
      !known_splat_width(width))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const int counts[3] = {n_layers, 0, 0};
  fill_layers(p, counts, mlp_widths);
  out[0] = kFWarps;
  out[1] = (int)pass_f_smem_bytes(width, kFWarps);
  out[2] = (int)wide_pack_bytes(p, kSplatFw);
  return (int)cudaSuccess;
}

// Launches the wide MLP build's pass F on `stream` (the pre-pass, then the
// kernel); returns a cudaError_t code.  Arguments as lightplane_splat_fw's
// (with an MLP at a width above 64), `values` [num_rays, steps, out_chn]
// out (written at the sampled steps only) and `workspace` (16-byte
// aligned, lightplane_splat_fw_mlp_config's bytes).
int lightplane_splat_fw_mlp(
    const float* origins, const float* directions, const float* near,
    const float* far, const int* grid_idx, const float* enc,
    const float* input_grid, const float* mlp, float* values,
    void* workspace, int num_rays, int num_out_grids, const int* out_meta,
    int out_chn, int num_in_grids, const int* in_meta, int in_chn,
    int n_layers, const int* mlp_widths, int width, int num_samples,
    int num_samples_inf, float disparity_at_inf, int mask_out_of_bounds,
    int contract_coords, void* stream) {
  SplatParams sp = {};
  const int rc = fill_splat_params(
      sp, num_rays, num_out_grids, out_meta, out_chn, num_in_grids, in_meta,
      in_chn, n_layers, mlp_widths, width, num_samples, num_samples_inf,
      disparity_at_inf, mask_out_of_bounds, contract_coords);
  if (rc != (int)cudaSuccess) return rc;
  if (n_layers < 1 || width <= 64 || sp.m.layer_out[n_layers - 1] != out_chn)
    return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)wide_dispatch(width, [&](auto w) {
    return launch_pass_f<decltype(w)::value>(sp, workspace, values, s);
  });
}

// Registers, spilled bytes and the thread limit of the splat pass (its
// voxel-grid build) without the MLP (mlp = 0) or with it at `width` (mlp =
// 1; above 64 the wide build's pass F), of the plan's fill pass (mlp =
// 2), or of the per-step splat (mlp = 3: the voxel-grid build of pass S),
// into out[3]; a cudaError_t code.
int lightplane_splat_fw_attrs(int mlp, int width, int* out) {
  if (mlp == 2) return kernel_attrs(splat_plan_kernel<true>, out);
  if (mlp == 3) return kernel_attrs(splat_fw_kernel<0, 8, 2, 2>, out);
  if (!mlp) return kernel_attrs(splat_fw_kernel<0, 8, 2>, out);
  if (width > 64)
    return wide_dispatch(width, [&](auto w) {
      return kernel_attrs(splat_mlp_wide_kernel<decltype(w)::value>, out);
    });
  return width == 32 ? kernel_attrs(splat_fw_kernel<32, 8, 1>, out)
                     : kernel_attrs(splat_fw_kernel<64, 8, 2>, out);
}

// Launches one stage of the splat forward on `stream`; returns a
// cudaError_t code.
//   out_meta, in_meta: host int[5 * n], per sub-grid (row offset, B, D, H, W)
//   n_layers: the MLP's layer count, 0 without it (input_grid, mlp, in_meta
//     and mlp_widths are then not read)
//   mlp_widths: host int[n_layers + 1]; width: 32, 64, 96, 128, 192 or 256
//     (above 64 the plan's stages only: the wide build splats by pass S)
//   bricks: host int[3 * num_out_grids], cells per brick along D, H, W
//   stage: 0 counts the runs per brick into counts [bricks] (zero-filled);
//     1 writes them at offsets [bricks + 1] (the exclusive prefix sum of
//     the counts, with the total last) into runs [capacity] (int2), cursor
//     [bricks] zero-filled; 2 splats them, K = runs_per_item runs a work
//     item, item_start [bricks + 1] the exclusive prefix sum of each
//     brick's items, at most max_items items
//   step_values: 1 splats row ray * steps + s of enc at step s (the
//     adjoint's pass B; no MLP, w not written; in passes of 64 channels),
//     2 the same with w written (the wide MLP build's pass S, enc its
//     staging), 0 the ray's row
//   batch_limit: > 0 caps the batches a ray's grid_idx may index (the
//     adjoint's pass B passes the output grid-list's too), 0 none
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
    const int* bricks, int stage, int* counts, int* cursor,
    const int* offsets, void* runs, long long capacity,
    const int* item_start, int runs_per_item, long long max_items,
    int step_values, int batch_limit, void* stream) {
  SplatParams sp = {};
  const int rc = fill_splat_params(
      sp, num_rays, num_out_grids, out_meta, out_chn, num_in_grids, in_meta,
      in_chn, n_layers, mlp_widths, width, num_samples, num_samples_inf,
      disparity_at_inf, mask_out_of_bounds, contract_coords);
  if (rc != (int)cudaSuccess) return rc;
  if (stage < 0 || stage > 2 || num_samples + num_samples_inf > 0xffff ||
      runs_per_item < 1 || step_values < 0 || step_values > 2 ||
      (step_values && n_layers) || (stage == 2 && n_layers && width > 64))
    return (int)cudaErrorInvalidValue;
  if (batch_limit > 0 && batch_limit < sp.m.num_batches)
    sp.m.num_batches = batch_limit;
  Plan pl = {};
  pl.first[0] = 0;
  for (int g = 0; g < num_out_grids; ++g) {
    long long n = sp.out.dims[g][0];
    for (int k = 0; k < 3; ++k) {
      const int size = sp.out.dims[g][1 + k], cells = bricks[3 * g + k];
      if (cells < 1 || (size == 1 && cells != 1))
        return (int)cudaErrorInvalidValue;
      pl.brick[g][k] = cells;
      pl.nb[g][k] = (size + cells - 1) / cells;
      n *= pl.nb[g][k];
    }
    const int rows = tile_extent(bricks[3 * g], sp.out.dims[g][1]) *
                     tile_extent(bricks[3 * g + 1], sp.out.dims[g][2]) *
                     tile_extent(bricks[3 * g + 2], sp.out.dims[g][3]);
    pl.max_rows = rows > pl.max_rows ? rows : pl.max_rows;
    if (pl.first[g] + n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    pl.first[g + 1] = pl.first[g] + (int)n;
  }
  pl.counts = counts;
  pl.cursor = cursor;
  pl.offsets = offsets;
  pl.runs = static_cast<int2*>(runs);
  pl.capacity = capacity;
  pl.item_start = item_start;
  pl.runs_per_item = runs_per_item;
  pl.stage = stage_chn(n_layers ? in_chn : (out_chn < 64 ? out_chn : 64));
  pl.warp_floats =
      warp_floats(pl.max_rows, out_chn, pl.stage * (step_values ? 2 : 1));
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
  if (stage < 2) {
    const int blocks = (num_rays + kPlanThreads - 1) / kPlanThreads;
    if (stage == 0)
      splat_plan_kernel<false><<<blocks, kPlanThreads, 0, s>>>(sp, pl);
    else
      splat_plan_kernel<true><<<blocks, kPlanThreads, 0, s>>>(sp, pl);
    return (int)cudaGetLastError();
  }
  if (kAblate & kAblateNoSplat) return (int)cudaSuccess;
  cudaError_t e;
  if (step_values == 2) {
    e = launch_splat<0, 2>(sp, pl, max_items, s);
  } else if (step_values) {
    if (kAblate & (kAblateS2NoScatter | kAblateS2GatherOnly))
      return (int)cudaSuccess;
    e = launch_splat<0, 1>(sp, pl, max_items, s);
  } else if (n_layers == 0) e = launch_splat<0>(sp, pl, max_items, s);
  else if (width == 32) e = launch_splat<32>(sp, pl, max_items, s);
  else e = launch_splat<64>(sp, pl, max_items, s);
  return (int)e;
}

}  // extern "C"
