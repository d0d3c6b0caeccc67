// S2's pass A at W = 512 (splatter_wide.cuh), compiled apart from the
// other widths so that nvcc builds it in parallel.

#include "splatter_wide.cuh"

namespace lightplane {

SplatWideOps splat_bw_ops_512() { return make_splat_bw_ops<512>(); }

}  // namespace lightplane
