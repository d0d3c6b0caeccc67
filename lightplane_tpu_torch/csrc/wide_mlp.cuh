// The dense layers of the wide builds (padded widths W = 96 and 128) of the
// renderer's forward march and recompute backward (renderer_wide.cu, R1 and
// R2) and the splatter's MLP adjoint (splatter_bw.cu, S2's pass A).
//
// R1 and R2 stage their layers in shared memory, a slice at a time for a
// whole block (staged_rows, below): at W = 128 a 2/2/2 MLP is ~400 KB, more
// than a Hopper block's 227 KB, so a ring of slices of the layers, packed in
// wgmma's K-major core matrices and pre-split into TF32 hi and lo, passes
// through it; a warpgroup multiplies by wgmma, a lone warp by mma.sync.
// R2's weight gradient is summed over a block's rows (block_weight_grad).
//
// S2's pass A keeps the first wide design: the B fragments of a product are
// read straight from the flat, unpadded mlp_params in device memory (at
// most a few hundred KB, so they stay in L2 and mostly in L1), zero past a
// layer's widths.  A product is mma.sync m16n8k8 in 3xTF32 as
// warp_chunk.cuh::mma_rows's, one M-tile of 16 rows at a time (W / 2
// accumulators a lane), over a layer's own K and N rounded up to 8, on a
// chunk's [32][W + 4] tile of activations in shared memory (row j = step
// j).  The weight gradient X^T G of a chunk is
// mlp_bwd.cuh::tc_weight_grad_rows's product, eight N-tiles at a time,
// added into a warp's own row of sums in device memory (the layout of
// splatter_bw.cu's MlpLayout: per layer mi x no accumulator tiles,
// tc_index(i, o, no), then 8 no bias sums; R2's block rows have it too).
//
// Everything is written against the template width, so a wider build
// (160-256) needs only its instantiation and the shared memory of its
// tiles.

#pragma once

#include "mlp_bwd.cuh"
#include "warp_chunk.cuh"

namespace lightplane {

// Element (k, n) of a layer's K x N operand: its weight (i = k, o = n), or
// with `transpose` (i = n, o = k); 0 outside the layer's [d_in, d_out].
__device__ __forceinline__ float layer_weight(const float* __restrict__ w,
                                              int d_in, int d_out, int k,
                                              int n, bool transpose) {
  const int i = transpose ? n : k, o = transpose ? k : n;
  return i < d_in && o < d_out ? __ldg(w + i * d_out + o) : 0.0f;
}

// out = epi(A @ B + bias) for the chunk's 32 rows on the tensor cores in
// 3xTF32, B the layer's [d_in, d_out] weights w in device memory (or their
// transpose: the input gradient's product, K = d_out, N = d_in), bias the
// layer's d_out biases or null for none.  The epilogue adds `add` (a tile
// like A, read at each output's own place) where given, takes relu where
// `relu`, and multiplies by (gate > 0) where `gate` is given.  Columns
// [0, 8 ceil(N / 8)) of out, and of out2 when given, get the rows; out may
// be A, gate or add (an M-tile's rows are all read before any is written).
template <int W>
__device__ __forceinline__ void wide_mma_rows(
    const float* A, const float* __restrict__ w, const float* __restrict__ bias,
    int d_in, int d_out, bool transpose, bool relu, const float* gate,
    const float* add, float* out, float* out2, int lane) {
  constexpr int S = W + 4, NT = W / 8;
  const int K = transpose ? d_out : d_in, N = transpose ? d_in : d_out;
  const int k_steps = (K + 7) / 8, n_tiles = (N + 7) / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int mt = 0; mt < 2; ++mt) {
    float d[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float b0 = 0.0f, b1 = 0.0f;
      const int o = nt * 8 + 2 * t;
      if (bias != nullptr && nt < n_tiles) {
        b0 = o < N ? __ldg(bias + o) : 0.0f;
        b1 = o + 1 < N ? __ldg(bias + o + 1) : 0.0f;
      }
      d[nt][0] = b0;
      d[nt][1] = b1;
      d[nt][2] = b0;
      d[nt][3] = b1;
    }
    // b0 (k t, n g), b1 (k t + 4, n g) of every N-tile: the next k-step's
    // are loaded before this one's MMAs, so that their latency overlaps
    float b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b[nt][0] = layer_weight(w, d_in, d_out, t, nt * 8 + g, transpose);
      b[nt][1] = layer_weight(w, d_in, d_out, t + 4, nt * 8 + g, transpose);
    }
#pragma unroll 1
    for (int ks = 0; ks < k_steps; ++ks) {
      // a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      const float* a = A + (mt * 16 + g) * S + ks * 8 + t;
      uint32_t ah[4], al[4];
      split_tf32(a[0], ah[0], al[0]);
      split_tf32(a[8 * S], ah[1], al[1]);
      split_tf32(a[4], ah[2], al[2]);
      split_tf32(a[8 * S + 4], ah[3], al[3]);
      const int k = (ks + 1) * 8 + t;  // the next k-step's (0 past K)
      float next[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        next[nt][0] = layer_weight(w, d_in, d_out, k, nt * 8 + g, transpose);
        next[nt][1] =
            layer_weight(w, d_in, d_out, k + 4, nt * 8 + g, transpose);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= n_tiles) continue;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b[nt][0], bh0, bl0);
        split_tf32(b[nt][1], bh1, bl1);
        mma_tf32(d[nt], al, bh0, bh1);
        mma_tf32(d[nt], ah, bl0, bl1);
        mma_tf32(d[nt], ah, bh0, bh1);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        b[nt][0] = next[nt][0];
        b[nt][1] = next[nt][1];
      }
    }
    __syncwarp();  // every lane's reads of these rows are done
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= n_tiles) continue;
      const int at = (mt * 16 + g) * S + nt * 8 + 2 * t;
      const int o[4] = {at, at + 1, at + 8 * S, at + 8 * S + 1};
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[e] = d[nt][e];
        if (add != nullptr) y[e] += add[o[e]];
        if (relu) y[e] = fmaxf(y[e], 0.0f);
        if (gate != nullptr && !(gate[o[e]] > 0.0f)) y[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) out[o[e]] = y[e];
      if (out2 != nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) out2[o[e]] = y[e];
      }
    }
  }
  __syncwarp();
}

// Output o of a layer with no activation (the heads' last layers) for the
// input `row` (a tile's row in shared memory, 16-byte aligned), in
// march_common.cuh::dense_out's order: the bias, then the products by
// ascending input.  o is the same in every lane (a broadcast of each
// weight).
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
      acc += x.x * wv[4 * i4];
      acc += x.y * wv[4 * i4 + 1];
      acc += x.z * wv[4 * i4 + 2];
      acc += x.w * wv[4 * i4 + 3];
    }
  }
  return acc;
}

// Layer l of p's MLPs, relu'd, over the tile X into out (and out2).
template <int W>
__device__ __forceinline__ void relu_layer(const Params& p, int l,
                                           const float* X, float* out,
                                           float* out2, int lane) {
  wide_mma_rows<W>(X, p.mlp + p.layer_w_off[l], p.mlp + p.layer_b_off[l],
                   p.layer_in[l], p.layer_out[l], false, true, nullptr,
                   nullptr, out, out2, lane);
}

// Output o of layer l of p's MLPs (no activation) for the input `row`.
template <int W>
__device__ __forceinline__ float layer_out(const Params& p, int l,
                                           const float* row, int o) {
  return wide_last_out<W>(row, p.mlp + p.layer_w_off[l],
                          p.mlp + p.layer_b_off[l], p.layer_in[l],
                          p.layer_out[l], o);
}

// The input gradient of layer l of p's MLPs: out = (G @ W_l^T [+ add]) x
// (gate > 0), gate and add as wide_mma_rows's.
template <int W>
__device__ __forceinline__ void layer_input_grad(const Params& p, int l,
                                                 const float* G,
                                                 const float* gate,
                                                 const float* add, float* out,
                                                 int lane) {
  wide_mma_rows<W>(G, p.mlp + p.layer_w_off[l], nullptr, p.layer_in[l],
                   p.layer_out[l], true, false, gate, add, out, nullptr, lane);
}

// acc += X^T G over the chunk's 32 rows for a [d_in, d_out] layer, and the
// bias sums acc[mi no 128 + o] += the column sums of G: the layer's sums in
// a warp's own row (device memory), mi = ceil(d_in / 16) M-tiles by no =
// ceil(d_out / 8) N-tiles of accumulator fragments (tc_index(i, o, no)).
// As tc_weight_grad_rows: per tile the products start at 0 over the 4
// k-steps of 8 rows and are then added to the sums in f32, three MMAs a
// tile, the small terms first; eight N-tiles at a time, so the
// accumulators and the split B fragments take 64 registers.  Those eight
// tiles' sums are loaded before the products and stored after them.
template <int W>
__device__ __forceinline__ void wide_weight_grad(float* acc, const float* X,
                                                 const float* G, int d_in,
                                                 int d_out, int lane) {
  constexpr int S = W + 4, kN = 8;
  const int mi = (d_in + 15) / 16, no = (d_out + 7) / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int mt = 0; mt < mi; ++mt) {
#pragma unroll 1
    for (int n0 = 0; n0 < no; n0 += kN) {
      float4* c = reinterpret_cast<float4*>(acc) + (mt * no + n0) * 32 + lane;
      // the sums' loads go out first, their latency behind the products
      float4 sum[kN];
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
        if (n0 + nt < no) sum[nt] = c[nt * 32];
      float d[kN][4];
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[nt][e] = 0.0f;
#pragma unroll 1
      for (int ks = 0; ks < 4; ++ks) {
        // A = X^T: a0 (i g, row t), a1 (g + 8, t), a2 (g, t + 4),
        // a3 (g + 8, t + 4)
        const float* a = X + (ks * 8 + t) * S + mt * 16 + g;
        uint32_t ah[4], al[4];
        split_tf32(a[0], ah[0], al[0]);
        split_tf32(a[8], ah[1], al[1]);
        split_tf32(a[4 * S], ah[2], al[2]);
        split_tf32(a[4 * S + 8], ah[3], al[3]);
        // B = G: b0 (row t, o g), b1 (t + 4, g)
        uint32_t bh[kN][2], bl[kN][2];
#pragma unroll
        for (int nt = 0; nt < kN; ++nt) {
          if (n0 + nt >= no) continue;
          const float* b = G + (ks * 8 + t) * S + (n0 + nt) * 8 + g;
          split_tf32(b[0], bh[nt][0], bl[nt][0]);
          split_tf32(b[4 * S], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int nt = 0; nt < kN; ++nt) {
            if (n0 + nt >= no) continue;
            if (term == 0) mma_tf32(d[nt], al, bh[nt][0], bh[nt][1]);
            if (term == 1) mma_tf32(d[nt], ah, bl[nt][0], bl[nt][1]);
            if (term == 2) mma_tf32(d[nt], ah, bh[nt][0], bh[nt][1]);
          }
      }
#pragma unroll
      for (int nt = 0; nt < kN; ++nt) {
        if (n0 + nt >= no) continue;
        float4 v = sum[nt];
        v.x += d[nt][0];
        v.y += d[nt][1];
        v.z += d[nt][2];
        v.w += d[nt][3];
        c[nt * 32] = v;
      }
    }
  }
  float* bias_acc = acc + mi * no * 128;
  for (int o = lane; o < 8 * no; o += 32) {
    float a = 0.0f;
    for (int j = 0; j < 32; ++j) a += G[j * S + o];
    bias_acc[o] += a;
  }
  __syncwarp();
}

// Floats of a layer's sums in a wide build's row (wide_weight_grad,
// block_weight_grad).
__host__ __device__ __forceinline__ int wide_sum_floats(int d_in, int d_out) {
  const int mi = (d_in + 15) / 16, no = (d_out + 7) / 8;
  return mi * no * 128 + 8 * no;
}

// ---- staged layers: R1's and R2's wide builds (renderer_wide.cu) ----------
// A block's warps march a ray each, 16 steps (one M-tile, kChunk) at a time,
// all of them on the same chunk and the same product at once.  Each product
// B of a chunk (a layer's [d_in, d_out] weights, or their transpose for the
// input gradient) comes from a workspace that a pre-pass kernel fills once a
// launch (pack_wide_kernel): per k-step of 8, B's hi part then its lo part
// (hi the TF32 rounding of the weight, lo = w - hi in f32, so hi + lo == w;
// the MMA reads lo's top 19 bits), each as wgmma's K-major, non-swizzled
// core matrices (N-tile j and k-half h at core 2 j + h: 8 rows n of 4 k, 16
// bytes a row), k-step-major, so two k-steps (kSliceSteps) of a product are
// one contiguous slice.  The block
// copies slices into a ring of kRingSlots slots in shared memory by
// cp.async, two ahead of the one the warps multiply by, in the order of the
// workspace's schedule (one int2 a slice: its first uint4 and its count),
// which repeats every chunk.

constexpr int kChunk = 16;       // steps a warp marches at a time
constexpr int kSliceSteps = 2;   // k-steps of 8 a ring slot holds
constexpr int kRingSlots = 3;

// uint4s of a ring slot at width W: kSliceSteps k-steps of W / 8 N-tiles.
__host__ __device__ __forceinline__ int ring_slot_u4(int W) {
  return kSliceSteps * (W / 8) * 32;
}

// A product of a chunk: layer `layer` as the K x N operand B (K = d_in,
// N = d_out), or transposed (K = d_out, N = d_in: its input gradient).
struct Product {
  int layer, transposed, k_steps, n_tiles;
};

// The products of a chunk in the order R1 and R2 run them: the relu layers
// of the forward in renderer_fw.cu's order (relu layer j is layer j below
// the opacity head's last, j + 1 past it), then, in R2 (`backward`), every
// layer's input gradient, last layer first.
__host__ __device__ __forceinline__ int wide_n_products(const Params& p,
                                                        bool backward) {
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  return n_total - 2 + (backward ? n_total : 0);
}

__host__ __device__ __forceinline__ Product wide_product(const Params& p,
                                                         int i) {
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  const int opacity_end = p.n_layers[0] + p.n_layers[1] - 1;
  Product pr;
  pr.transposed = i >= n_total - 2;
  pr.layer = !pr.transposed ? (i < opacity_end ? i : i + 1)
                            : n_total - 1 - (i - (n_total - 2));
  const int d_in = p.layer_in[pr.layer], d_out = p.layer_out[pr.layer];
  pr.k_steps = ((pr.transposed ? d_out : d_in) + 7) / 8;
  pr.n_tiles = ((pr.transposed ? d_in : d_out) + 7) / 8;
  return pr;
}

// Ring slices of a product.
__host__ __device__ __forceinline__ int product_slices(const Product& pr) {
  return (pr.k_steps + kSliceSteps - 1) / kSliceSteps;
}

// Where product `upto` starts in the workspace (uint4s) and its first
// slice; with upto = n, the workspace's size and the slices of a chunk.
// The schedule (an int2 a slice) comes first.
__host__ __device__ __forceinline__ void wide_layout(const Params& p, int n,
                                                     int upto,
                                                     long long* off,
                                                     int* first) {
  int slices = 0;
  for (int i = 0; i < n; ++i) slices += product_slices(wide_product(p, i));
  long long at = (slices + 1) / 2;
  int s = 0;
  for (int i = 0; i < upto; ++i) {
    const Product pr = wide_product(p, i);
    at += (long long)pr.k_steps * pr.n_tiles * 32;
    s += product_slices(pr);
  }
  *off = at;
  *first = upto == n ? slices : s;
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
// of 8 columns each), B (8 x W, K-major) at descriptor `desc`, TF32 in, f32
// sums: wgmma.mma_async m64nWk8, A from registers.
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
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
  static __device__ __forceinline__ void mma(float (&d)[12][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
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

// out = epi(A @ B + bias) for a warp's 16 rows on the tensor cores in
// 3xTF32, B the product (k_steps, N outputs) whose slices the ring hands out:
// every warp takes them, and an inactive one (no open step in its chunk)
// writes nothing.  With `wg` (a block of 4 or 8 warps) each warpgroup
// multiplies its 64 rows by wgmma, B read from the slot by the tensor cores
// (an inactive warp's A is 0); else each warp by mma.sync, B's fragments
// read from the slot.  A is a [16][sa] tile in shared
// memory, plus the vector a_add (per column; the colour head's input: the
// trunk's output + the encoding) where given, added as A's fragments are
// read; bias (device memory, null for none) as wide_mma_rows's.  The
// epilogue (W + 4-strided out, out2, gate and add) is wide_mma_rows's; out
// may be A.  Each k-step splits A into TF32 hi and lo parts (split_wide)
// and issues three MMAs per N-tile, term by term across the tiles, the
// small terms first.
template <int W>
__device__ __forceinline__ void staged_rows(
    Ring& r, int k_steps, int N, const float* A, int sa,
    const float* a_add, const float* __restrict__ bias, bool relu,
    const float* gate, const float* add, float* out, float* out2,
    bool active, bool wg, int lane) {
  constexpr int S = W + 4, NT = W / 8;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (N + 7) / 8;
  float d[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float b0 = 0.0f, b1 = 0.0f;
    const int o = nt * 8 + 2 * t;
    if (active && bias != nullptr && nt < n_tiles) {
      b0 = o < N ? __ldg(bias + o) : 0.0f;
      b1 = o + 1 < N ? __ldg(bias + o + 1) : 0.0f;
    }
    d[nt][0] = b0;
    d[nt][1] = b1;
    d[nt][2] = b0;
    d[nt][3] = b1;
  }
#pragma unroll 1
  for (int ks0 = 0; ks0 < k_steps; ks0 += kSliceSteps) {
    const uint4* slice = ring_next(r);
    if (!active && !wg) continue;
    // A's fragments of the slice's k-steps, split: a0 (row g, col t), a1
    // (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); 0 in an inactive warp
    uint32_t ah[kSliceSteps][4], al[kSliceSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSliceSteps; ++kk) {
      const int ks = ks0 + kk;
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (active && ks < k_steps) {
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
    if (wg) {
      // the warpgroup's three products a k-step, the small terms first,
      // B's hi and lo parts read by the tensor cores from the slot
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSliceSteps; ++kk) {
        if (ks0 + kk >= k_steps) break;
        const uint4* hi = slice + kk * n_tiles * 32;
        const uint4* lo = hi + n_tiles * 16;
        Wgmma<W>::mma(d, al[kk], wgmma_desc(hi));
        Wgmma<W>::mma(d, ah[kk], wgmma_desc(lo));
        Wgmma<W>::mma(d, ah[kk], wgmma_desc(hi));
      }
      wgmma_commit_and_wait();
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
    const int at = g * S + nt * 8 + 2 * t;
    const int o[4] = {at, at + 1, at + 8 * S, at + 8 * S + 1};
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      y[e] = d[nt][e];
      if (add != nullptr) y[e] += add[o[e]];
      if (relu) y[e] = fmaxf(y[e], 0.0f);
      if (gate != nullptr && !(gate[o[e]] > 0.0f)) y[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) out[o[e]] = y[e];
    if (out2 != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e) out2[o[e]] = y[e];
    }
  }
  __syncwarp();
}

// The weight gradient of a [d_in, d_out] layer over the rows of the
// block's active warps (16 each; active[w] in shared memory), added into
// the block's row of sums (wide_weight_grad's layout): sums += X^T G and
// the bias sums += the column sums of G.  Warp w's X and G tiles lie at X0
// and G0 plus w x_stride floats; X (W + 4-strided) plus its warp's vector
// at xadd0 + w x_stride where xadd0 is given (a_add's); G sg-strided.  The
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
    int sg, int x_stride, const int* active, int warps, int d_in, int d_out,
    int warp, int lane) {
  constexpr int S = W + 4, kN = 8;
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
          const float* a = X + (ks * 8 + t) * S + i;
          float x[4] = {a[0], a[8], a[4 * S], a[4 * S + 8]};
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
// renderer_bw.cu's C functions dispatch to at W = 96 and 128.  Both
// kernels take a workspace (the packed layers and their schedule, filled
// by each launch) of the bytes their config gives.
// out[0] warps per block, out[1] a block's shared memory in bytes, out[2]
// the workspace's bytes; a cudaError_t code.
int render_fw_wide_config(const Params& p, int width, int* out);
cudaError_t launch_render_fw_wide(const Params& p, int width, int warps,
                                  void* workspace, cudaStream_t stream);
int render_fw_wide_attrs(int width, int* out);
// out[0] warps per block, out[1] rows of partial sums (one per block of
// the resident wave), out[2] floats of a row, out[3] a block's shared
// memory in bytes, out[4] the workspace's bytes; a cudaError_t code
// (cudaErrorInvalidValue where one warp's region and the ring exceed a
// block's shared memory).
int render_bw_wide_config(const Params& p, int width, bool color_grid,
                          int* out);
cudaError_t launch_render_bw_wide(const Params& p, int width,
                                  void* workspace, cudaStream_t stream);
int render_bw_wide_attrs(int width, int* out);
// The pre-pass alone: the products of R1's chunk (R2's with `backward`)
// packed into the workspace.
cudaError_t launch_wide_pack(const Params& p, bool backward, void* workspace,
                             cudaStream_t stream);

}  // namespace lightplane
