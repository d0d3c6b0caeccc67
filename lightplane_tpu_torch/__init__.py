"""lightplane_tpu_torch: the PyTorch / CUDA port of ``lightplane_tpu``.

The renderer, forward and backward: ``lightplane_renderer`` and the
``LightplaneRenderer`` module run the fused Emission-Absorption march and
its O(1)-in-samples recompute backward as hand-written CUDA kernels on
NVIDIA Hopper GPUs (``csrc/renderer_fw.cu``, ``csrc/renderer_bw.cu``, built
with ``nvcc`` at first use) and as their plain PyTorch versions on the CPU.
The package trains: gradients reach the grid-list, the decoder's
``mlp_params`` and the ray encoding (so the module's parameters), and
``utils.grid_utils`` holds the fitting regularisers.  Factories build on
the GPU unless asked for ``device="cpu"``.  Names, layouts (channels-last
grid-lists, the flat ``mlp_params`` vector) and numerics follow the JAX
package, which stays the reference.  This package never imports JAX.
"""

from .ops.const import MIN_BLOCK_SIZE
from .ops.rays import (
    Rays,
    calc_harmonic_embedding,
    calc_harmonic_embedding_dim,
    default_tile,
    jitter_near_far,
    tile_ray_order,
)
from .ops.misc_utils import (
    flatten_grid,
    unflatten_grid,
    if_not_none_else,
    is_in_bounds,
    check_grid,
    check_grid_and_color_grid,
    process_and_flatten_grid,
)
from .ops.mlp_utils import (
    DecoderParams,
    init_decoder_params,
    flatten_decoder_params,
    flattened_decoder_params_to_list,
)
from .ops.rand import int_to_randn
from .ops.naive_renderer import (
    lightplane_renderer_naive,
    lightplane_eval_mlp,
    lightplane_eval_mlp_opacity_only,
)
from .ops.renderer import lightplane_renderer
from .models.renderer_module import LightplaneRenderer

__version__ = "0.1.0"
