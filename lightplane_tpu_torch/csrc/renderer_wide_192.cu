// R1's and R2's wide builds at W = 192 (renderer_wide.cuh), compiled apart
// from the other widths so that nvcc builds them in parallel.

#include "renderer_wide.cuh"

namespace lightplane {

WideOps wide_ops_192() {
  return join_wide_ops(make_wide_fw_ops<192>(), make_wide_bw_ops<192>());
}

}  // namespace lightplane
