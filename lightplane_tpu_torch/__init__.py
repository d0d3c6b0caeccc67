"""lightplane_tpu_torch: the PyTorch / CUDA port of ``lightplane_tpu``.

The renderer (3D -> 2D) and the splatter (2D -> 3D), forward and backward.
``lightplane_renderer`` and the ``LightplaneRenderer`` module run the fused
Emission-Absorption march and its O(1)-in-samples recompute backward;
``lightplane_splatter``, ``lightplane_mlp_splatter`` (and
``lightplane_splatter_raw``) and the ``LightplaneSplatter`` /
``LightplaneMLPSplatter`` modules run the fused splat and its gather
adjoint.  On NVIDIA Hopper GPUs each pass is a hand-written CUDA kernel
(``csrc/renderer_fw.cu``, ``csrc/renderer_bw.cu``, ``csrc/splatter_fw.cu``,
``csrc/splatter_bw.cu``, built with ``nvcc`` at first use); on the CPU it is
the kernel's plain PyTorch version.  Gradients reach the grid-lists, the
MLPs' flat ``mlp_params`` and the ray encodings, so a splat can be rendered
back and trained end to end.  ``utils.grid_utils`` holds the fitting
regularisers and ``utils.cameras`` pinhole rays.  Factories build on the GPU
unless asked for ``device="cpu"``.  Names, layouts (channels-last
grid-lists, the flat ``mlp_params`` vectors) and numerics follow the JAX
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
    SplatterParams,
    init_decoder_params,
    init_splatter_params,
    flatten_decoder_params,
    flatten_splatter_params,
    flattened_decoder_params_to_list,
)
from .ops.rand import int_to_randn
from .ops.naive_renderer import (
    lightplane_renderer_naive,
    lightplane_eval_mlp,
    lightplane_eval_mlp_opacity_only,
)
from .ops.renderer import lightplane_renderer
from .ops.naive_splatter import (
    lightplane_splatter_naive,
    lightplane_mlp_splatter_naive,
)
from .ops.splatter import (
    lightplane_splatter,
    lightplane_mlp_splatter,
    lightplane_splatter_raw,
)
from .models.renderer_module import LightplaneRenderer
from .models.splatter_module import LightplaneSplatter, LightplaneMLPSplatter

__version__ = "0.1.0"
