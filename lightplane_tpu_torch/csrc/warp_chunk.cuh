// What the warp-cooperative kernels of the renderer's forward march
// (renderer_fw.cu, R1; renderer_wide.cuh, its wide build and R2's) and the
// splatter's adjoint (splatter_bw.cu, S2) share: the corners of a step in
// one sub-grid (grid_corners), the gather of a chunk's grid samples into a
// tile (gather_chunk), and dense
// layers over a [32][W + 4] tile of a chunk's 32 steps in shared memory
// (row j = step j) on the tensor cores (mma.sync m16n8k8, 3xTF32,
// mma_rows), their weights staged in shared memory in the B fragments'
// order (frag_index).

#pragma once

#include "march_common.cuh"

namespace lightplane {

// B fragment order of a K x N operand (element (k, n): a layer's weight
// (i, o), or (o, i) for its transpose), k_steps k-steps of 8 deep: per
// N-tile nt and k-step ks, lane 4 g + t holds (k t, n g) and (k t + 4, n g)
// of the 8 x 8 block as one float2.
__host__ __device__ __forceinline__ int frag_index(int k, int n,
                                                   int k_steps) {
  const int ks = k >> 3, hi = (k >> 2) & 1, t = k & 3;
  const int nt = n >> 3, g = n & 7;
  return (((nt * k_steps + ks) * 32 + g * 4 + t) << 1) + hi;
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

// Row j (< kRows) of `tile` (stride W + 4) gets the linear sample of every
// sub-grid of the [V, C] grid-list (m, grid) at sample j's point, for the
// samples of the chunk whose bit is set in `taken`, and 0 for the others
// (and in channels C..W-1).  With `relu` the sum goes through a relu; `tile2`, when given,
// gets the same rows.  `st` is the lane's own sample, b the ray's batch (< 0:
// nothing is read).  The warp reads four samples' rows at a time: lane
// 8 q + u sums channels 32 v + 4u .. + 3 (v < W / 32) of sample 4 i + q,
// corner by corner in march_common.cuh::sample_grids's order onto the
// row's sum so far, and gets each corner's row and weight from the
// sample's lane by a shuffle.
template <int W, int kRows = 32>
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
    // two rows of samples at a time (one past W = 512, where V float4
    // sums a row would double a build's compile time)
#pragma unroll (W > 512 ? 1 : 2)
    for (int i = 0; i < kRows / 4; ++i) {
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

// out = epi(A @ B + bias) for the chunk's 32 rows on the tensor cores in
// 3xTF32.  A is a [32][W + 4] tile; B is n_tiles N-tiles by k_steps
// k-steps of 8 x 8 in fragment order (frag_index), both at most W / 8;
// bias holds 8 n_tiles floats.  The epilogue takes relu where `relu`, and
// multiplies by (gate > 0) where `gate` (a tile like A, read at each
// output's own place) is given.  Columns [0, 8 n_tiles) of out, and of
// out2 when given, get the rows; out may be A or gate.  At W = 32 both
// M-tiles go in one pass, sharing each B fragment's split; at W = 64 one
// M-tile per pass, so the accumulators stay at W/2 registers.  kRollK
// keeps the k-steps a loop rather than unrolled (a kernel with several
// call sites stays small enough for the instruction caches) and issues a
// k-step's MMAs term by term across the N-tiles, so that no MMA waits on
// the one before it.
template <int W, bool kRollK = false>
__device__ __forceinline__ void mma_rows(const float* A,
                                         const float2* __restrict__ frag,
                                         const float* __restrict__ bias,
                                         int n_tiles, int k_steps, bool relu,
                                         const float* gate, float* out,
                                         float* out2, int lane) {
  constexpr int S = W + 4, KS = W / 8, NT = W / 8;
  constexpr int kMT = W == 32 ? 2 : 1;
  constexpr int kUnrollK = kRollK ? 1 : KS;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m0 = 0; m0 < 2; m0 += kMT) {
    float d[kMT][NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float b0 = 0.0f, b1 = 0.0f;
      if (nt < n_tiles) {
        b0 = bias[nt * 8 + 2 * t];
        b1 = bias[nt * 8 + 2 * t + 1];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        d[mt][nt][0] = b0;
        d[mt][nt][1] = b1;
        d[mt][nt][2] = b0;
        d[mt][nt][3] = b1;
      }
    }
#pragma unroll kUnrollK
    for (int ks = 0; ks < KS; ++ks) {
      if (ks >= k_steps) continue;
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* a = A + ((m0 + mt) * 16 + g) * S + ks * 8 + t;
        split_tf32(a[0], ah[mt][0], al[mt][0]);
        split_tf32(a[8 * S], ah[mt][1], al[mt][1]);
        split_tf32(a[4], ah[mt][2], al[mt][2]);
        split_tf32(a[8 * S + 4], ah[mt][3], al[mt][3]);
      }
      if constexpr (kRollK) {
        // the three products of a tile depend on each other: issued as
        // three sweeps over the N-tiles, consecutive MMAs are independent
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= n_tiles) continue;
          const float2 bv = frag[(nt * k_steps + ks) * 32 + lane];
          split_tf32(bv.x, bh[nt][0], bl[nt][0]);
          split_tf32(bv.y, bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt >= n_tiles) continue;
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              if (term == 0) mma_tf32(d[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
              if (term == 1) mma_tf32(d[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
              if (term == 2) mma_tf32(d[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
            }
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= n_tiles) continue;
          const float2 bv = frag[(nt * k_steps + ks) * 32 + lane];
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
    }
    __syncwarp();  // every lane's reads of these rows are done
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= n_tiles) continue;
        const int at = ((m0 + mt) * 16 + g) * S + nt * 8 + 2 * t;
        const int o[4] = {at, at + 1, at + 8 * S, at + 8 * S + 1};
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          y[e] = relu ? fmaxf(d[mt][nt][e], 0.0f) : d[mt][nt][e];
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
  }
  __syncwarp();
}

}  // namespace lightplane
