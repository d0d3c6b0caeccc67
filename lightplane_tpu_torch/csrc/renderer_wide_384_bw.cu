// R2's wide build at W = 384 (renderer_wide.cuh), compiled apart from
// the others so that nvcc builds it in parallel.

#include "renderer_wide.cuh"

namespace lightplane {

WideOps wide_bw_ops_384() { return make_wide_bw_ops<384>(); }

}  // namespace lightplane
