// R1's wide build at W = 512 (renderer_wide.cuh), compiled apart from
// the others so that nvcc builds it in parallel.

#include "renderer_wide.cuh"

namespace lightplane {

WideOps wide_fw_ops_512() { return make_wide_fw_ops<512>(); }

}  // namespace lightplane
