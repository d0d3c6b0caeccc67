// The dense layers of the wide builds (padded widths W = 96, 128, 192,
// 256, and for the renderer 384 and 512) of the renderer's forward march
// and recompute backward (renderer_wide.cuh, R1 and R2), of the splatter
// MLP's forward (splatter_fw.cu, S1's pass F) and of its adjoint
// (splatter_bw.cu, S2's pass A).
//
// All four stage their layers in shared memory, a slice at a time for a
// whole block (staged_rows, below): at W = 128 a 2/2/2 MLP is ~400 KB, more
// than a Hopper block's 227 KB, so a ring of slices of the layers, packed in
// wgmma's K-major core matrices and pre-split into TF32 hi and lo, passes
// through it; a warpgroup multiplies by wgmma, a lone warp by mma.sync.  A
// block's warps march a ray each, in lockstep over 16-step chunks; each
// kernel runs its chunk's products in the order of its schedule
// (wide_product: R1's, R2's, the splatter's forward, its adjoint).  R2's and
// S2's weight gradients are summed over a block's rows into one row a block
// (block_weight_grad; per layer mi x no accumulator tiles, tc_index(i, o,
// no), then 8 no bias sums: splatter_bw.cu's MlpLayout).
//
// Everything is written against the template width.  Past 128 a ring slot
// keeps the size it has at 128 (two k-steps of 16 N-tiles), so that a
// product wider than 16 N-tiles takes one k-step a slice; each warpgroup
// product takes the narrowest wgmma shape (128, 192, 256) that holds the
// product's N-tiles, and mma.sync reads a k-step's B fragments one N-tile
// at a time, so that only the accumulators grow with the width.  Past 256
// (wgmma's widest N, and a slot's widest k-step) a product runs in N-parts
// of at most 256 columns (kPartTiles), in turn, each with its own 128
// accumulators, a slice one k-step of one part; R2's block there is one
// warp, so R1 and R2 both multiply by mma.sync (staged_rows_parts).

#pragma once

#include <type_traits>

#include "mlp_bwd.cuh"
#include "warp_chunk.cuh"

namespace lightplane {

// f(std::integral_constant<int, W>{}) for the wide build W == width (96,
// 128, 192 or 256: the splatter MLP's builds; the renderer's, to 512, are
// renderer_wide.cu's wide_ops); cudaErrorInvalidValue, as f's return type,
// for any other width.
template <class F>
auto wide_dispatch(int width, F&& f)
    -> decltype(f(std::integral_constant<int, 128>{})) {
  using R = decltype(f(std::integral_constant<int, 128>{}));
  switch (width) {
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
    case 256: return f(std::integral_constant<int, 256>{});
  }
  return static_cast<R>(cudaErrorInvalidValue);
}

// Output o of a layer with no activation (the heads' last layers) for the
// input `row` (a tile's row in shared memory, 16-byte aligned), in
// march_common.cuh::dense_out's order: the bias, then the products by
// ascending input.  o is the same in every lane (a broadcast of each
// weight).  Past W = 256 each step is an explicit fused multiply-add: the
// compiler may contract a product and a sum or not, kernel by kernel, and
// R1 and R2 must round alike.
template <int W>
__device__ __forceinline__ float wide_last_out(const float* row,
                                               const float* __restrict__ w,
                                               const float* __restrict__ bias,
                                               int d_in, int d_out, int o) {
  // 32 inputs at a time, each weight's load issued ahead of the products
  // (predicated: 0 past d_in, where adding x * 0 leaves the sum as it is)
  // and none behind a branch out of the loop, so their latencies overlap
  float acc = __ldg(bias + o);
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i0 = 0; i0 < W; i0 += 32) {
    float wv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      wv[i] = i0 + i < d_in ? __ldg(w + (i0 + i) * d_out + o) : 0.0f;
#pragma unroll
    for (int i4 = 0; i4 < 8; ++i4) {
      const float4 x = r4[i0 / 4 + i4];
      if constexpr (W > 256) {
        acc = __fmaf_rn(x.x, wv[4 * i4], acc);
        acc = __fmaf_rn(x.y, wv[4 * i4 + 1], acc);
        acc = __fmaf_rn(x.z, wv[4 * i4 + 2], acc);
        acc = __fmaf_rn(x.w, wv[4 * i4 + 3], acc);
      } else {
        acc += x.x * wv[4 * i4];
        acc += x.y * wv[4 * i4 + 1];
        acc += x.z * wv[4 * i4 + 2];
        acc += x.w * wv[4 * i4 + 3];
      }
    }
  }
  return acc;
}

// Output o of layer l of p's MLPs (no activation) for the input `row`.
template <int W>
__device__ __forceinline__ float layer_out(const Params& p, int l,
                                           const float* row, int o) {
  return wide_last_out<W>(row, p.mlp + p.layer_w_off[l],
                          p.mlp + p.layer_b_off[l], p.layer_in[l],
                          p.layer_out[l], o);
}

// Floats of a layer's sums in a wide build's row (block_weight_grad).
__host__ __device__ __forceinline__ int wide_sum_floats(int d_in, int d_out) {
  const int mi = (d_in + 15) / 16, no = (d_out + 7) / 8;
  return mi * no * 128 + 8 * no;
}

// ---- staged layers ----------------------------------------------------------
// A block's warps march a ray each, 16 steps (one M-tile, kChunk) at a time,
// all of them on the same chunk and the same product at once.  Each product
// B of a chunk (a layer's [d_in, d_out] weights, or their transpose for the
// input gradient) comes from a workspace that a pre-pass kernel fills once a
// launch (renderer_wide.cuh::pack_wide_kernel): per k-step of 8, B's hi part
// then its lo part (hi the TF32 rounding of the weight, lo = w - hi in f32,
// so hi + lo == w; the MMA reads lo's top 19 bits), each as wgmma's
// K-major, non-swizzled core matrices (N-tile j and k-half h at core 2 j +
// h: 8 rows n of 4 k, 16 bytes a row), k-step-major, so two k-steps
// (kSliceSteps; one past kSlotTiles N-tiles) of a product are one
// contiguous slice; past kPartTiles N-tiles the product is laid out part
// by part (N-tiles 32 q .. 32 q + 31 of every k-step, then the next part).
// The block copies slices into a ring of kRingSlots
// slots in shared memory by cp.async, two ahead of the one the warps
// multiply by, in the order of the workspace's schedule (one int2 a slice:
// its first uint4 and its count), which repeats every chunk.

constexpr int kChunk = 16;       // steps a warp marches at a time
constexpr int kSliceSteps = 2;   // k-steps of 8 a ring slot holds
constexpr int kRingSlots = 3;

constexpr int kSlotTiles = 16;   // N-tiles of a slot's kSliceSteps k-steps

// uint4s of a ring slot at width W: kSliceSteps k-steps of W / 8 N-tiles,
// at most kSlotTiles.
__host__ __device__ __forceinline__ int ring_slot_u4(int W) {
  return kSliceSteps * (W / 8 < kSlotTiles ? W / 8 : kSlotTiles) * 32;
}

// k-steps a slice of a product (or a part) of n_tiles N-tiles:
// kSliceSteps up to kSlotTiles N-tiles (every product at W <= 128), else
// one.
__host__ __device__ __forceinline__ int slice_steps(int n_tiles) {
  return n_tiles > kSlotTiles ? 1 : kSliceSteps;
}

// N-tiles of a product's part: a slot's k-step and mma.sync's accumulators
// (128 registers) at most; wider products (past W = 256) run part by part.
constexpr int kPartTiles = 32;

__host__ __device__ __forceinline__ int product_parts(int n_tiles) {
  return (n_tiles + kPartTiles - 1) / kPartTiles;
}

// N-tiles of part q of a product of n_tiles N-tiles.
__host__ __device__ __forceinline__ int part_tiles(int n_tiles, int q) {
  const int rest = n_tiles - q * kPartTiles;
  return rest < kPartTiles ? rest : kPartTiles;
}

// Bytes of the ring of slices at width W.
__host__ __device__ __forceinline__ long long ring_bytes(int W) {
  return 16LL * kRingSlots * ring_slot_u4(W);
}

// A product of a chunk: layer `layer` as the K x N operand B (K = d_in,
// N = d_out), or transposed (K = d_out, N = d_in: its input gradient).
struct Product {
  int layer, transposed, k_steps, n_tiles;
};

// The schedules of a chunk's products.  R1 (kRenderFw) runs the relu layers
// of the forward in renderer_fw.cu's order (relu layer j is layer j below
// the opacity head's last, j + 1 past it), and past W = 256 the colour
// head's last layer (wide_head_product); R2 (kRenderBw) those, then every
// layer's input gradient, last layer first.  The splatter's MLP (its L
// layers in p.n_layers[0]): S1's pass F (kSplatFw) runs every layer, the
// last one too; S2's pass A (kSplatBw) the L - 1 relu layers, then every
// layer's input gradient, last layer first.
enum WideSchedule { kRenderFw = 0, kRenderBw = 1, kSplatFw = 2, kSplatBw = 3 };

// 1 where R1 and R2 run the colour head's last layer as a product, 0 where
// each lane takes its row's dot products (wide_last_out): its outputs are
// the rendered channels, up to 512 past W = 256 (a padded width is the
// widest layer's: the grid's channels are the first layer's input).
__host__ __device__ __forceinline__ int wide_head_product(const Params& p) {
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  for (int l = 0; l < n_total; ++l)
    if (p.layer_in[l] > 256 || p.layer_out[l] > 256) return 1;
  return 0;
}

__host__ __device__ __forceinline__ int wide_n_products(const Params& p,
                                                        int kind) {
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  if (kind == kSplatFw) return n_total;
  if (kind == kSplatBw) return 2 * n_total - 1;
  return n_total - 2 + wide_head_product(p) +
         (kind == kRenderBw ? n_total : 0);
}

__host__ __device__ __forceinline__ Product wide_product(const Params& p,
                                                         int kind, int i) {
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  Product pr;
  if (kind >= kSplatFw) {
    // the forward's products, then (kSplatBw) the transposed ones
    const int fwd = kind == kSplatFw ? n_total : n_total - 1;
    pr.transposed = i >= fwd;
    pr.layer = pr.transposed ? n_total - 1 - (i - fwd) : i;
  } else {
    // the relu layers (and the colour head's last, i + 1 at i = n_total -
    // 2), then the transposed ones
    const int opacity_end = p.n_layers[0] + p.n_layers[1] - 1;
    const int fwd = n_total - 2 + wide_head_product(p);
    pr.transposed = i >= fwd;
    pr.layer = !pr.transposed ? (i < opacity_end ? i : i + 1)
                              : n_total - 1 - (i - fwd);
  }
  const int d_in = p.layer_in[pr.layer], d_out = p.layer_out[pr.layer];
  pr.k_steps = ((pr.transposed ? d_out : d_in) + 7) / 8;
  pr.n_tiles = ((pr.transposed ? d_in : d_out) + 7) / 8;
  return pr;
}

// Ring slices of a product: each part's k-steps, slice_steps of them a
// slice.
__host__ __device__ __forceinline__ int product_slices(const Product& pr) {
  int slices = 0;
  for (int q = 0; q < product_parts(pr.n_tiles); ++q) {
    const int steps = slice_steps(part_tiles(pr.n_tiles, q));
    slices += (pr.k_steps + steps - 1) / steps;
  }
  return slices;
}

// Where product `upto` of schedule `kind` starts in the workspace (uint4s)
// and its first slice; with upto = wide_n_products, the workspace's size
// and the slices of a chunk.  The schedule (an int2 a slice) comes first.
__host__ __device__ __forceinline__ void wide_layout(const Params& p,
                                                     int kind, int upto,
                                                     long long* off,
                                                     int* first) {
  const int n = wide_n_products(p, kind);
  int slices = 0;
  for (int i = 0; i < n; ++i) slices += product_slices(wide_product(p, kind, i));
  long long at = (slices + 1) / 2;
  int s = 0;
  for (int i = 0; i < upto; ++i) {
    const Product pr = wide_product(p, kind, i);
    at += (long long)pr.k_steps * pr.n_tiles * 32;
    s += product_slices(pr);
  }
  *off = at;
  *first = upto == n ? slices : s;
}

// The slices of a chunk of schedule `kind`, and its workspace's bytes.
__host__ __device__ __forceinline__ int wide_slices(const Params& p,
                                                    int kind) {
  long long size = 0;
  int slices = 0;
  wide_layout(p, kind, wide_n_products(p, kind), &size, &slices);
  return slices;
}

__host__ __device__ __forceinline__ long long wide_pack_bytes(
    const Params& p, int kind) {
  long long size = 0;
  int slices = 0;
  wide_layout(p, kind, wide_n_products(p, kind), &size, &slices);
  return 16 * size;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block's ring of slices (every thread holds the same state).
struct Ring {
  uint4* slots;            // kRingSlots slots of slot_u4 uint4s
  const uint4* ws;         // the workspace: schedule, then the products
  int slot_u4, n_slices;   // a slot's uint4s; slices of a chunk
  int q;                   // the next slice the warps take
  int2 ahead;              // the schedule's entry of slice q + 2
  // past W = 256, the warp's kStashFloats in device memory
  // (staged_rows_parts)
  float* stash;
};

__device__ __forceinline__ int2 ring_entry(const Ring& r, int q) {
  return __ldg(reinterpret_cast<const int2*>(r.ws) + q % r.n_slices);
}

// Every thread copies its share of slice q (schedule entry d) into its
// slot, one group each.
__device__ __forceinline__ void ring_issue(const Ring& r, int q, int2 d) {
  uint4* dst = r.slots + (q % kRingSlots) * r.slot_u4;
  for (int i = threadIdx.x; i < d.y; i += blockDim.x)
    cp_async16(dst + i, r.ws + d.x + i);
  cp_async_commit();
}

__device__ __forceinline__ void ring_start(Ring& r) {
  r.q = 0;
  if (r.n_slices > 0) {
    ring_issue(r, 0, ring_entry(r, 0));
    ring_issue(r, 1, ring_entry(r, 1));
    r.ahead = ring_entry(r, 2);
  }
}

// The next slice, once every thread's copies of it have landed.  Every
// warp of the block takes every slice (a block barrier); past it every warp
// is done with the slice before, whose slot then takes the slice two ahead
// (its schedule entry read a slice earlier, off the barrier's path).
__device__ __forceinline__ const uint4* ring_next(Ring& r) {
  cp_async_wait<1>();
  // the copies (generic proxy) before wgmma's reads (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  ring_issue(r, r.q + 2, r.ahead);
  r.ahead = ring_entry(r, r.q + 3);
  const uint4* s = r.slots + (r.q % kRingSlots) * r.slot_u4;
  ++r.q;
  return s;
}

// The 3xTF32 split of the activations in R1's and R2's wide products: hi =
// x with its low 13 bits cleared, lo = x - hi (exact), whose low 13 bits the
// MMA drops; hi * hi + hi * lo + lo * hi then keeps a product to ~2^-20 of
// its size.  Two instructions where split_tf32's two roundings take more:
// an mma.sync build of R2 at the render headline at W = 128 took 436.0 ms
// with it, 576.7 with split_tf32 (H100, PERF.md, section 6).
__device__ __forceinline__ void split_wide(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// ---- wgmma: a warpgroup's 64 rows by the staged slice ---------------------

// A descriptor of a K-major, non-swizzled wgmma operand at `p` in shared
// memory: core matrices of 8 rows of 16 bytes, the next k-half 128 bytes
// on (the leading byte offset), the next 8 rows 256 (the stride byte
// offset), as pack_wide_kernel lays out each part of a k-step.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += A B over one k-step of 8 for the warpgroup's 64 rows (each warp its
// 16: A's fragment as mma.sync m16n8k8's, d as its accumulators, an N-tile
// of 8 columns each; a wider d's tiles past N / 8 untouched), B (8 x N,
// K-major) at descriptor `desc`, TF32 in, f32 sums: wgmma.mma_async
// m64nNk8, A from registers.
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  template <int M>
  static __device__ __forceinline__ void mma(float (&d)[M][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    static_assert(M >= 16, "the accumulators of 16 N-tiles");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(1), "l"(desc));
  }
};

template <>
struct Wgmma<96> {
  template <int M>
  static __device__ __forceinline__ void mma(float (&d)[M][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    static_assert(M >= 12, "the accumulators of 12 N-tiles");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %52, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %53, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(1), "l"(desc));
  }
};

template <>
struct Wgmma<256> {
  template <int M>
  static __device__ __forceinline__ void mma(float (&d)[M][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    static_assert(M >= 32, "the accumulators of 32 N-tiles");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %132, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
        "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
        "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "
        "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %133, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
          "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
          "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
          "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
          "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
          "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
          "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
          "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
          "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(1), "l"(desc));
  }
};

template <>
struct Wgmma<192> {
  template <int M>
  static __device__ __forceinline__ void mma(float (&d)[M][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    static_assert(M >= 24, "the accumulators of 24 N-tiles");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %100, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
        "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
        "%92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %101, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(1), "l"(desc));
  }
};

// out = epi(A @ B + bias) for a warp's 16 rows on the tensor cores in
// 3xTF32, B the product (k_steps, N outputs) whose slices the ring hands out:
// every warp takes them, and an inactive one (no open step in its chunk)
// writes nothing.  With `wg` (a block of 4 or 8 warps) each warpgroup
// multiplies its 64 rows by wgmma, B read from the slot by the tensor cores
// (an inactive warp's A is 0); else each warp by mma.sync, B's fragments
// read from the slot.  A is a [16][sa] tile in shared
// memory, plus the vector a_add (per column; the colour head's input: the
// trunk's output + the encoding) where given, added as A's fragments are
// read; bias (device memory, N floats) or null for none.  The epilogue
// writes columns [0, 8 ceil(N / 8)) of the rows of out (and out2 where
// given), tiles of row stride so: A B + bias, plus `add` (a tile like out,
// read at each output's own place) where given, through a relu where
// `relu`, times (gate > 0) where `gate` (a tile like out) is given; out may
// be A, gate or add.  Each k-step splits A into TF32 hi and lo parts
// (split_wide) and issues three MMAs per N-tile, term by term across the
// tiles, the small terms first (past W = 128 by mma.sync: N-tile by N-tile,
// each tile's terms in the same order; past W = 256 by N-parts,
// staged_rows_parts).  A, out and the tiles may lie in device memory.

// The bias of the N-tiles nt < n_tiles at columns c0 + 8 nt (0 past N) into
// the accumulators of NT N-tiles, as rows g and g + 8 of each.
template <int NT>
__device__ __forceinline__ void bias_rows(float (&d)[NT][4],
                                          const float* __restrict__ bias,
                                          int c0, int N, int n_tiles,
                                          bool active, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float b0 = 0.0f, b1 = 0.0f;
    const int o = c0 + nt * 8 + 2 * t;
    if (active && bias != nullptr && nt < n_tiles) {
      b0 = o < N ? __ldg(bias + o) : 0.0f;
      b1 = o + 1 < N ? __ldg(bias + o + 1) : 0.0f;
    }
    d[nt][0] = b0;
    d[nt][1] = b1;
    d[nt][2] = b0;
    d[nt][3] = b1;
  }
}

// A's fragments of a slice's k-steps ks0 .. ks0 + steps - 1 (below
// k_steps), split: a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4), plus a_add's columns where given; 0 in an inactive warp.
__device__ __forceinline__ void a_fragments(
    uint32_t (&ah)[kSliceSteps][4], uint32_t (&al)[kSliceSteps][4],
    const float* A, int sa, const float* a_add, int ks0, int k_steps,
    int steps, bool active, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kSliceSteps; ++kk) {
    const int ks = ks0 + kk;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (active && ks < k_steps && kk < steps) {
      const float* a = A + g * sa + ks * 8 + t;
      x[0] = a[0];
      x[1] = a[8 * sa];
      x[2] = a[4];
      x[3] = a[8 * sa + 4];
      if (a_add != nullptr) {
        const float e0 = a_add[ks * 8 + t], e1 = a_add[ks * 8 + t + 4];
        x[0] += e0;
        x[1] += e0;
        x[2] += e1;
        x[3] += e1;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) split_wide(x[j], ah[kk][j], al[kk][j]);
  }
}

// The epilogue's four outputs of N-tile accumulators d at `at` (row g,
// column 2 t of the tile) in out's layout: A B + bias (+ add), relu'd, gated.
__device__ __forceinline__ void epilogue_values(float (&y)[4],
                                                const float (&d)[4], int at,
                                                int so, bool relu,
                                                const float* gate,
                                                const float* add) {
  const int o[4] = {at, at + 1, at + 8 * so, at + 8 * so + 1};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    y[e] = d[e];
    if (add != nullptr) y[e] += add[o[e]];
    if (relu) y[e] = fmaxf(y[e], 0.0f);
    if (gate != nullptr && !(gate[o[e]] > 0.0f)) y[e] = 0.0f;
  }
}

__device__ __forceinline__ void store_values(float* out, float* out2, int at,
                                             int so, const float (&y)[4]) {
  const int o[4] = {at, at + 1, at + 8 * so, at + 8 * so + 1};
#pragma unroll
  for (int e = 0; e < 4; ++e) out[o[e]] = y[e];
  if (out2 != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out2[o[e]] = y[e];
  }
}

template <int W>
__device__ __forceinline__ void staged_rows_whole(
    Ring& r, int k_steps, int N, const float* A, int sa,
    const float* a_add, const float* __restrict__ bias, bool relu,
    const float* gate, const float* add, float* out, float* out2, int so,
    bool active, bool wg, int lane) {
  constexpr int NT = W / 8;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (N + 7) / 8;
  // k-steps a slice (kSliceSteps at W <= 128)
  const int steps = W > 128 ? slice_steps(n_tiles) : kSliceSteps;
  float d[NT][4];
  bias_rows(d, bias, 0, N, n_tiles, active, t);
#pragma unroll 1
  for (int ks0 = 0; ks0 < k_steps; ks0 += steps) {
    const uint4* slice = ring_next(r);
    if (!active && !wg) continue;
    uint32_t ah[kSliceSteps][4], al[kSliceSteps][4];
    a_fragments(ah, al, A, sa, a_add, ks0, k_steps, steps, active, g, t);
    if (wg) {
      // the warpgroup's three products a k-step, the small terms first,
      // B's hi and lo parts read by the tensor cores from the slot
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSliceSteps; ++kk) {
        if (ks0 + kk >= k_steps || kk >= steps) break;
        const uint4* hi = slice + kk * n_tiles * 32;
        const uint4* lo = hi + n_tiles * 16;
        if constexpr (W <= 128) {
          Wgmma<W>::mma(d, al[kk], wgmma_desc(hi));
          Wgmma<W>::mma(d, ah[kk], wgmma_desc(lo));
          Wgmma<W>::mma(d, ah[kk], wgmma_desc(hi));
        } else if (n_tiles <= 16) {
          // the narrowest shape that holds the product's columns: B's
          // rows past them (read within the slot) land in d's tiles past
          // n_tiles, which the epilogue never writes
          Wgmma<128>::mma(d, al[kk], wgmma_desc(hi));
          Wgmma<128>::mma(d, ah[kk], wgmma_desc(lo));
          Wgmma<128>::mma(d, ah[kk], wgmma_desc(hi));
        } else if (W == 256 && n_tiles <= 24) {
          Wgmma<192>::mma(d, al[kk], wgmma_desc(hi));
          Wgmma<192>::mma(d, ah[kk], wgmma_desc(lo));
          Wgmma<192>::mma(d, ah[kk], wgmma_desc(hi));
        } else {
          Wgmma<W>::mma(d, al[kk], wgmma_desc(hi));
          Wgmma<W>::mma(d, ah[kk], wgmma_desc(lo));
          Wgmma<W>::mma(d, ah[kk], wgmma_desc(hi));
        }
      }
      wgmma_commit_and_wait();
      continue;
    }
    if constexpr (W > 128) {
      // one k-step a slice past kSlotTiles N-tiles, else two; B's two
      // fragments of each N-tile (hi, lo) read just before its three MMAs
#pragma unroll
      for (int kk = 0; kk < kSliceSteps; ++kk) {
        if (ks0 + kk >= k_steps || kk >= steps) break;
        const uint32_t* b = reinterpret_cast<const uint32_t*>(
                                slice + kk * n_tiles * 32) +
                            g * 4 + t;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= n_tiles) continue;
          const uint32_t bh0 = b[nt * 64], bh1 = b[nt * 64 + 32];
          const uint32_t bl0 = b[(n_tiles + nt) * 64],
                         bl1 = b[(n_tiles + nt) * 64 + 32];
          mma_tf32(d[nt], al[kk], bh0, bh1);
          mma_tf32(d[nt], ah[kk], bl0, bl1);
          mma_tf32(d[nt], ah[kk], bh0, bh1);
        }
      }
      continue;
    }
#pragma unroll
    for (int kk = 0; kk < kSliceSteps; ++kk) {
      if (ks0 + kk >= k_steps) break;
      // b0 (k t, n g) and b1 (k t + 4, n g) of N-tile nt: rows g of its
      // two core matrices, hi then lo
      const uint32_t* b = reinterpret_cast<const uint32_t*>(
                              slice + kk * n_tiles * 32) +
                          g * 4 + t;
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= n_tiles) continue;
        bh[nt][0] = b[nt * 64];
        bh[nt][1] = b[nt * 64 + 32];
        bl[nt][0] = b[(n_tiles + nt) * 64];
        bl[nt][1] = b[(n_tiles + nt) * 64 + 32];
      }
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= n_tiles) continue;
          if (term == 0) mma_tf32(d[nt], al[kk], bh[nt][0], bh[nt][1]);
          if (term == 1) mma_tf32(d[nt], ah[kk], bl[nt][0], bl[nt][1]);
          if (term == 2) mma_tf32(d[nt], ah[kk], bh[nt][0], bh[nt][1]);
        }
    }
  }
  if (!active) return;
  __syncwarp();  // every lane's reads of A are done
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= n_tiles) continue;
    const int at = g * so + nt * 8 + 2 * t;
    float y[4];
    epilogue_values(y, d[nt], at, so, relu, gate, add);
    store_values(out, out2, at, so, y);
  }
  __syncwarp();
}

// Floats of a warp's stash (Ring::stash): one part's outputs, a thread's
// 4 kPartTiles values at stash[32 i + lane].
constexpr int kStashFloats = kPartTiles * 4 * 32;

// staged_rows past W = 256, by mma.sync (R2's block there is one warp, and
// R1 follows it): the product's N-tiles in parts of kPartTiles, in turn,
// each from the bias over every k-step of its slices (one k-step a slice;
// two for a part of up to kSlotTiles N-tiles), each N-tile's three terms in
// staged_rows_whole's order, so that an output's sums are those of the
// whole product.  Where out is A (R1's layers, R2's colour input gradient)
// the parts but the last wait in the warp's stash until the last has read
// A (at W <= 512 a product has two parts at most).  Not inlined: one copy
// a kernel, not one a call site, keeps the 384 and 512 builds' compile
// time in bounds.
static __device__ __noinline__ void staged_rows_parts(
    Ring& r, int k_steps, int N, const float* A, int sa,
    const float* a_add, const float* __restrict__ bias, bool relu,
    const float* gate, const float* add, float* out, float* out2, int so,
    bool active, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (N + 7) / 8;
  const int parts = product_parts(n_tiles);
  const bool stash = out == A && parts > 1;
#pragma unroll 1
  for (int q = 0; q < parts; ++q) {
    const int pt = part_tiles(n_tiles, q), steps = slice_steps(pt);
    const int c0 = q * kPartTiles * 8;  // the part's first column
    float d[kPartTiles][4];
    bias_rows(d, bias, c0, N, pt, active, t);
#pragma unroll 1
    for (int ks0 = 0; ks0 < k_steps; ks0 += steps) {
      const uint4* slice = ring_next(r);
      if (!active) continue;
      uint32_t ah[kSliceSteps][4], al[kSliceSteps][4];
      a_fragments(ah, al, A, sa, a_add, ks0, k_steps, steps, active, g, t);
#pragma unroll
      for (int kk = 0; kk < kSliceSteps; ++kk) {
        if (ks0 + kk >= k_steps || kk >= steps) break;
        const uint32_t* b = reinterpret_cast<const uint32_t*>(
                                slice + kk * pt * 32) +
                            g * 4 + t;
#pragma unroll
        for (int nt = 0; nt < kPartTiles; ++nt) {
          if (nt >= pt) continue;
          const uint32_t bh0 = b[nt * 64], bh1 = b[nt * 64 + 32];
          const uint32_t bl0 = b[(pt + nt) * 64], bl1 = b[(pt + nt) * 64 + 32];
          mma_tf32(d[nt], al[kk], bh0, bh1);
          mma_tf32(d[nt], ah[kk], bl0, bl1);
          mma_tf32(d[nt], ah[kk], bh0, bh1);
        }
      }
    }
    if (!active) continue;
    __syncwarp();  // every lane's reads of A are done
#pragma unroll
    for (int nt = 0; nt < kPartTiles; ++nt) {
      if (nt >= pt) continue;
      const int at = g * so + c0 + nt * 8 + 2 * t;
      float y[4];
      epilogue_values(y, d[nt], at, so, relu, gate, add);
      if (stash && q < parts - 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) r.stash[(nt * 4 + e) * 32 + lane] = y[e];
      } else {
        store_values(out, out2, at, so, y);
      }
    }
    __syncwarp();
  }
  if (!stash || !active) return;
  // the first part, from the stash (each thread reads back its own values)
#pragma unroll
  for (int nt = 0; nt < kPartTiles; ++nt) {
    const int at = g * so + nt * 8 + 2 * t;
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = r.stash[(nt * 4 + e) * 32 + lane];
    store_values(out, out2, at, so, y);
  }
  __syncwarp();
}

template <int W>
__device__ __forceinline__ void staged_rows(
    Ring& r, int k_steps, int N, const float* A, int sa,
    const float* a_add, const float* __restrict__ bias, bool relu,
    const float* gate, const float* add, float* out, float* out2, int so,
    bool active, bool wg, int lane) {
  if constexpr (W > 256)
    staged_rows_parts(r, k_steps, N, A, sa, a_add, bias, relu, gate, add,
                      out, out2, so, active, lane);
  else
    staged_rows_whole<W>(r, k_steps, N, A, sa, a_add, bias, relu, gate, add,
                         out, out2, so, active, wg, lane);
}

// The weight gradient of a [d_in, d_out] layer over the rows of the
// block's active warps (16 each; active[w] in shared memory), added into
// the block's row of sums (per layer mi x no accumulator tiles, tc_index,
// then 8 no bias sums): sums += X^T G and the bias sums += the column sums
// of G.  Warp w's X and G tiles lie at X0 and G0 plus w x_stride floats; X
// sx-strided (at least 16 mi columns) plus its warp's vector at xadd0 + w
// x_stride where xadd0 is given (a_add's); G sg-strided.  The
// mi M-tiles by no N-tiles of the product, and one more M-tile for the
// bias sums (A all ones: every row the column sums), go out to the warps
// eight N-tiles of one M-tile at a time: per job the products start at 0,
// run over every active warp's two k-steps of 8 rows (three MMAs a tile,
// the small terms first) and are then added to the row in f32 by
// reductions (each sum always by the same thread, so in the same order
// from run to run).  Nothing is written to the block's tiles.
template <int W>
__device__ __forceinline__ void block_weight_grad(
    float* sums, const float* X0, const float* xadd0, const float* G0,
    int sx, int sg, int x_stride, const int* active, int warps, int d_in,
    int d_out, int warp, int lane) {
  constexpr int kN = 8;
  const int mi = (d_in + 15) / 16, no = (d_out + 7) / 8;
  const int ng = (no + kN - 1) / kN;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int job = warp; job < (mi + 1) * ng; job += warps) {
    const int mt = job / ng, n0 = (job % ng) * kN;
    const bool bias = mt == mi;
    float d[kN][4];
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[nt][e] = 0.0f;
#pragma unroll 1
    for (int w = 0; w < warps; ++w) {
      if (!active[w]) continue;
      const float* X = X0 + (long long)w * x_stride;
      const float* G = G0 + (long long)w * x_stride;
      const float* e =
          xadd0 != nullptr ? xadd0 + (long long)w * x_stride : nullptr;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t ah[4], al[4];
        if (bias) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ah[j] = to_tf32(1.0f);
            al[j] = 0u;
          }
        } else {
          // A = X^T: a0 (i g, row t), a1 (g + 8, t), a2 (g, t + 4),
          // a3 (g + 8, t + 4)
          const int i = mt * 16 + g;
          const float* a = X + (ks * 8 + t) * sx + i;
          float x[4] = {a[0], a[8], a[4 * sx], a[4 * sx + 8]};
          if (e != nullptr) {
            x[0] += e[i];
            x[1] += e[i + 8];
            x[2] += e[i];
            x[3] += e[i + 8];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) split_wide(x[j], ah[j], al[j]);
        }
        // B = G: b0 (row t, o g), b1 (t + 4, g)
        uint32_t bh[kN][2], bl[kN][2];
#pragma unroll
        for (int nt = 0; nt < kN; ++nt) {
          if (n0 + nt >= no) continue;
          const float* b = G + (ks * 8 + t) * sg + (n0 + nt) * 8 + g;
          split_wide(b[0], bh[nt][0], bl[nt][0]);
          split_wide(b[4 * sg], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int nt = 0; nt < kN; ++nt) {
            // the ones' lo part is 0: the bias tile takes two terms
            if (n0 + nt >= no || (bias && term == 0)) continue;
            if (term == 0) mma_tf32(d[nt], al, bh[nt][0], bh[nt][1]);
            if (term == 1) mma_tf32(d[nt], ah, bl[nt][0], bl[nt][1]);
            if (term == 2) mma_tf32(d[nt], ah, bh[nt][0], bh[nt][1]);
          }
      }
    }
    if (!bias) {
#pragma unroll
      for (int nt = 0; nt < kN; ++nt) {
        if (n0 + nt >= no) continue;
        atomicAdd(reinterpret_cast<float4*>(sums) +
                      (mt * no + n0 + nt) * 32 + lane,
                  make_float4(d[nt][0], d[nt][1], d[nt][2], d[nt][3]));
      }
    } else if (g == 0) {
      // row 0 of the ones tile: column 2 t and 2 t + 1 of each N-tile
      float* b = sums + mi * no * 128;
#pragma unroll
      for (int nt = 0; nt < kN; ++nt) {
        if (n0 + nt >= no) continue;
        atomicAdd(b + (n0 + nt) * 8 + 2 * t, d[nt][0]);
        atomicAdd(b + (n0 + nt) * 8 + 2 * t + 1, d[nt][1]);
      }
    }
  }
}

// The entry points of renderer_wide.cu that renderer_fw.cu's and
// renderer_bw.cu's C functions dispatch to at W = 96, 128, 192, 256, 384
// and 512.  Both kernels take a workspace (the packed layers and their
// schedule, filled by each launch; past W = 256 then a scratch in device
// memory for each block of the resident wave) of the bytes their config
// gives.
// out[0] warps per block, out[1] a block's shared memory in bytes, out[2]
// the packed layers' bytes, out[3] the blocks of the resident wave, out[4]
// a block's scratch bytes (0 up to W = 256); a cudaError_t code.
int render_fw_wide_config(const Params& p, int width, int* out);
// probe: the recording build's (LIGHTPLANE_RELU_MASKS) [R, steps, 2]
// floats, zero-filled, or null (renderer_wide.cuh::write_probe).
cudaError_t launch_render_fw_wide(const Params& p, int width, int warps,
                                  void* workspace, float* probe,
                                  cudaStream_t stream);
int render_fw_wide_attrs(int width, int* out);
// out[0] warps per block, out[1] rows of partial sums (one per block of
// the resident wave), out[2] floats of a row, out[3] a block's shared
// memory in bytes, out[4] the packed layers' bytes, out[5] a block's
// scratch bytes (0 up to W = 256); a cudaError_t code
// (cudaErrorInvalidValue where one warp's region and the ring exceed a
// block's shared memory).
int render_bw_wide_config(const Params& p, int width, bool color_grid,
                          int* out);
cudaError_t launch_render_bw_wide(const Params& p, int width,
                                  void* workspace, float* probe,
                                  cudaStream_t stream);
int render_bw_wide_attrs(int width, int* out);
// The pre-pass alone: the products of a chunk of schedule `kind`
// (WideSchedule) packed into the workspace (wide_pack_bytes).
cudaError_t launch_wide_pack(const Params& p, int kind, void* workspace,
                             cudaStream_t stream);

}  // namespace lightplane
