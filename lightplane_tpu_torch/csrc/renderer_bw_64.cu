// R2 at W = 64 (renderer_bw.cuh), compiled apart from its build at W = 32
// (renderer_bw.cu) so that nvcc builds the two in parallel.

#include "renderer_bw.cuh"

namespace lightplane {

cudaError_t launch_render_bw_64(const Params& p, int rays, size_t smem_bytes,
                                cudaStream_t stream) {
  return ::launch<64>(p, rays, smem_bytes, stream);
}

int render_bw_attrs_64(int* out) {
  return kernel_attrs(::render_bw_kernel<64>, out);
}

}  // namespace lightplane
