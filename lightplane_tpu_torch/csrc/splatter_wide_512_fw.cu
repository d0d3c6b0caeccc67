// S1's pass F at W = 512 (splatter_wide.cuh), compiled apart from the
// other widths so that nvcc builds it in parallel.

#include "splatter_wide.cuh"

namespace lightplane {

SplatWideOps splat_fw_ops_512() { return make_splat_fw_ops<512>(); }

}  // namespace lightplane
