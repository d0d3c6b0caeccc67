// S2's pass A at W = 768 (splatter_wide.cuh), compiled apart from the
// other widths so that nvcc builds it in parallel.

#include "splatter_wide.cuh"

namespace lightplane {

SplatWideOps splat_bw_ops_768() { return make_splat_bw_ops<768>(); }

}  // namespace lightplane
