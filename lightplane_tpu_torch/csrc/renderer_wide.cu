// The wide builds' entry points (declared in wide_mlp.cuh), which
// renderer_fw.cu's and renderer_bw.cu's C functions call above W = 64: the
// kernels and their launchers are renderer_wide.cuh's, built by width in
// renderer_wide_<W>.cu (past 256 R1 and R2 apart, renderer_wide_<W>_fw.cu
// and _bw.cu; one nvcc each, started together).

#include "renderer_wide.cuh"

namespace lightplane {
namespace {

// The launchers at `width`; false for a width with no wide build.
bool wide_ops(int width, WideOps* ops) {
  switch (width) {
    case 96: *ops = wide_ops_96(); return true;
    case 128: *ops = wide_ops_128(); return true;
    case 192: *ops = wide_ops_192(); return true;
    case 256: *ops = wide_ops_256(); return true;
    case 384:
      *ops = join_wide_ops(wide_fw_ops_384(), wide_bw_ops_384());
      return true;
    case 512:
      *ops = join_wide_ops(wide_fw_ops_512(), wide_bw_ops_512());
      return true;
  }
  return false;
}

}  // namespace

int render_fw_wide_config(const Params& p, int width, int* out) {
  if (width <= 64 || !known_width(width)) return (int)cudaErrorInvalidValue;
  out[0] = fw_warps(width);
  out[1] = (int)fw_smem_bytes(width, out[0]);
  out[2] = (int)wide_pack_bytes(p, kRenderFw);
  out[3] = 0;
  out[4] = (int)(4 * fw_scratch_floats(width, out[0]));
  WideOps ops;
  wide_ops(width, &ops);
  return (int)ops.fw_wave(out[0], &out[3]);
}

cudaError_t launch_render_fw_wide(const Params& p, int width, int warps,
                                  void* workspace, float* probe,
                                  cudaStream_t stream) {
  WideOps ops;
  if (!wide_ops(width, &ops)) return cudaErrorInvalidValue;
  return ops.launch_fw(p, warps, static_cast<uint4*>(workspace), probe,
                       stream);
}

int render_fw_wide_attrs(int width, int* out) {
  WideOps ops;
  if (!wide_ops(width, &ops)) return (int)cudaErrorInvalidValue;
  return ops.fw_attrs(out);
}

int render_bw_wide_config(const Params& p, int width, bool color_grid,
                          int* out) {
  int warps = 0, wave = 0;
  size_t smem = 0;
  const int n_total = p.n_layers[0] + p.n_layers[1] + p.n_layers[2];
  WideOps ops;
  const cudaError_t e =
      wide_ops(width, &ops)
          ? ops.bw_config(p, color_grid, &warps, &smem, &wave)
          : cudaErrorInvalidValue;
  const BwLayout lay =
      bw_layout(width, n_total, p.n_layers[2], color_grid, head_out(p));
  out[0] = warps;
  out[1] = wave;
  out[2] = wide_sums(p).total;
  out[3] = (int)(smem ? smem : bw_smem_bytes(width, lay, 1));
  out[4] = (int)wide_pack_bytes(p, kRenderBw);
  out[5] = (int)(4 * bw_scratch_floats(width, lay));
  return (int)e;
}

cudaError_t launch_render_bw_wide(const Params& p, int width, void* workspace,
                                  float* probe, cudaStream_t stream) {
  WideOps ops;
  if (!wide_ops(width, &ops)) return cudaErrorInvalidValue;
  return ops.launch_bw(p, static_cast<uint4*>(workspace), probe, stream);
}

int render_bw_wide_attrs(int width, int* out) {
  WideOps ops;
  if (!wide_ops(width, &ops)) return (int)cudaErrorInvalidValue;
  return ops.bw_attrs(out);
}

cudaError_t launch_wide_pack(const Params& p, int kind, void* workspace,
                             cudaStream_t stream) {
  launch_pack(p, kind, static_cast<uint4*>(workspace), stream);
  return cudaGetLastError();
}

}  // namespace lightplane
